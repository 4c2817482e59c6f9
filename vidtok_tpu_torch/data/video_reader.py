"""Host-side video I/O (``vidtok_tpu/data/video_reader.py``).

Decoding tries the repo's native FFmpeg library first
(``native_reader``), then OpenCV, as the JAX package does, so both give
the same frames. OpenCV is imported inside the functions that need it:
importing this module needs neither backend. Frame indices follow the
reference's fps-proportional sampling (``vidtok/data/video_read.py:12-50``).
Frames are channels-last RGB: uint8 from :func:`read_frames_u8`, float32
in [0, 1] from :func:`read_frames_at`.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("no video backend: native/libvidtok_ingest.so is not "
                          "built and OpenCV (cv2) is not installed") from e
    return cv2


def sample_frames_with_fps(total_frames: int, video_fps: float,
                           sample_num_frames: int, sample_fps: float,
                           start_index: Optional[int] = None,
                           rng: Optional[random.Random] = None) -> np.ndarray:
    """fps-proportional frame indices (reference video_read.py:12-50)."""
    sample_num_frames = min(sample_num_frames, total_frames)
    interval = round(video_fps / sample_fps)
    frames_range = (sample_num_frames - 1) * interval + 1

    if start_index is not None:
        start = start_index
    elif total_frames - frames_range - 1 < 0:
        start = 0
    else:
        r = rng if rng is not None else random
        start = r.randint(0, total_frames - frames_range - 1)

    return np.linspace(start=start, stop=min(total_frames - 1, start + frames_range),
                       num=sample_num_frames).astype(int)


def _native():
    from . import native_reader

    return native_reader if native_reader.available() else None


def video_info(path: str) -> Tuple[int, float]:
    """(total_frames, fps)."""
    nat = _native()
    if nat is not None:
        try:
            return nat.native_video_info(path)
        except IOError:
            pass
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
    cap.release()
    return n, fps


def read_frames_u8(path: str, indices: Sequence[int]) -> np.ndarray:
    """Decode the frames at ``indices`` -> uint8 [T,H,W,3] RGB. Indices
    past the end repeat the last decoded frame."""
    nat = _native()
    if nat is not None:
        try:
            reader = nat.NativeVideoReader(path)
            try:
                return reader.gather(indices)
            finally:
                reader.close()
        except IOError:
            pass
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    want = {}
    for pos, idx in enumerate(indices):
        want.setdefault(int(idx), []).append(pos)
    out: List[Optional[np.ndarray]] = [None] * len(indices)
    max_idx = max(want)
    i = 0
    while i <= max_idx:
        ok, frame = cap.read()
        if not ok:
            break
        if i in want:
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            for pos in want[i]:
                out[pos] = rgb
        i += 1
    cap.release()
    last = next((f for f in reversed(out) if f is not None), None)
    if last is None:
        raise IOError(f"no frames decoded from {path}")
    return np.stack([f if f is not None else last for f in out])


def read_frames_at(path: str, indices: Sequence[int]) -> np.ndarray:
    """Decode the frames at ``indices`` -> float32 [T,H,W,3] RGB in [0,1]."""
    return read_frames_u8(path, indices).astype(np.float32) / 255.0


def read_video_frames(path: str, sample_num_frames: int, sample_fps: float,
                      start_index: Optional[int] = None,
                      rng: Optional[random.Random] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """fps-resampled read (reference read_frames_with_decord,
    video_read.py:53-88): (frames [T,H,W,3] in [0,1], indices)."""
    total, fps = video_info(path)
    idxs = sample_frames_with_fps(total, fps, sample_num_frames, sample_fps,
                                  start_index, rng)
    return read_frames_at(path, idxs), idxs


def write_video(path: str, frames: np.ndarray, fps: float = 30.0):
    """uint8 [T,H,W,3] RGB frames -> an mp4 (OpenCV's mp4v)."""
    cv2 = _cv2()
    t, h, w, _ = frames.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open video writer for {path}")
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
