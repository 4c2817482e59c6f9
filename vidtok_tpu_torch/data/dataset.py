"""Datasets (``vidtok_tpu/data/dataset.py``, after reference
vidtok/data/vidtok.py).

* :class:`VidTokDataset` (training, reference :18-128): a CSV's ``videos``
  column of paths under ``data_dir``; an fps-resampled read per item with
  a random temporal crop (fixed by ``start_index``); missing files
  resampled, unreadable ones black; the tail padded with the last frame.
* :class:`VidTokValDataset` (evaluation, reference :131-333): every
  fixed-stride window of every video (:func:`window_frame_ids`);
  ``read_long_video`` keeps one chunk-aligned window a video; optional
  pre-load into host memory.

Items are ``{"jpg": float32 [T, H, W, C] in [-1, 1], "path": str}``, as
the JAX package's, as tensors: frames are decoded to uint8 on the host
and transformed (:mod:`.transforms`) on the CPU, or for
:class:`VidTokValDataset` on its ``device``, to which they are moved
first (the evaluation CLI's card).
"""

from __future__ import annotations

import csv
import glob
import os
import random
from typing import List, Optional

import numpy as np
import torch

from .transforms import transform_u8
from .video_reader import read_frames_u8, sample_frames_with_fps, video_info

# pandas' default NA strings (read_csv's na_values): a row with one of
# these as a field is dropped, as ``dropna()`` drops it
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
       "nan", "null"}


def _read_meta(meta_path: str) -> List[dict]:
    """The rows of a metadata CSV that the JAX package's
    ``pd.read_csv(on_bad_lines="skip", encoding="ISO-8859-1",
    engine="python").dropna()`` keeps, as ``{column: str}`` dicts: blank
    lines skipped; a row with more fields than the header skipped, unless
    the first data row has exactly one more, which makes the first field
    an index (pandas' implicit index); a row with fewer fields, or an NA
    string in a field, dropped. Values stay strings (pandas would turn a
    column of bare numbers into numbers)."""
    with open(meta_path, encoding="ISO-8859-1", newline="") as f:
        rows = [r for r in csv.reader(f) if "".join(r).strip()]
    if not rows:
        return []
    header, body = rows[0], rows[1:]
    index = int(bool(body) and len(body[0]) == len(header) + 1)
    width = len(header) + index
    out = []
    for r in body:
        if len(r) > width:
            continue
        fields = r[index:]
        if len(r) < width or any(v in _NA for v in fields):
            continue
        out.append(dict(zip(header, fields)))
    return out


def _pad_tail(frames, n: int):
    """Frames padded to ``n`` by repeating the last one."""
    if frames.shape[0] < n:
        tail = frames[-1:].expand(n - frames.shape[0], *frames.shape[1:])
        frames = torch.cat([frames, tail], dim=0)
    return frames


class VidTokDataset:
    def __init__(self, data_dir: str, meta_path: str, video_params: dict,
                 data_frac: float = 1.0, is_strict_loading: bool = False,
                 skip_missing_files: bool = True,
                 start_index: Optional[int] = None, seed: Optional[int] = None):
        self.data_dir = data_dir
        self.video_params = video_params
        self.is_strict_loading = is_strict_loading
        self.skip_missing_files = skip_missing_files
        self.start_index = start_index
        self.rng = random.Random(seed)
        rows = _read_meta(meta_path)
        if data_frac < 1:
            rows = self.rng.sample(rows, round(data_frac * len(rows)))
        self.paths = [os.path.join(data_dir, r["videos"]) for r in rows]
        self.missing_files = []

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, item):
        vp = self.video_params
        path = self.paths[item % len(self.paths)]
        try:
            if os.path.isfile(path):
                total, fps = video_info(path)
                idxs = sample_frames_with_fps(total, fps, vp["sample_num_frames"],
                                              vp["sample_fps"], self.start_index,
                                              rng=self.rng)
                frames = read_frames_u8(path, idxs)
            else:
                if path not in self.missing_files:
                    self.missing_files.append(path)
                if self.skip_missing_files:
                    return self[self.rng.randrange(len(self))]
                raise ValueError(f"missing video {path}")
        except ValueError:
            raise
        except Exception:
            if self.is_strict_loading:
                raise
            frames = np.zeros((1, vp["input_height"], vp["input_width"], 3), np.uint8)
        frames = transform_u8(frames, vp["input_height"], vp["input_width"])
        frames = _pad_tail(frames, vp["sample_num_frames"])
        return {"jpg": frames, "path": path}


def window_frame_ids(total: int, fps: float, video_params: dict,
                     read_long_video: bool = False, chunk_size: int = 16,
                     is_causal: bool = True,
                     last_frames_handle: str = "repeat") -> List[List[int]]:
    """The frame indices of each evaluation window of one video of
    ``total`` frames at ``fps`` (reference vidtok.py:204-254): every
    ``round(fps / sample_fps)``-th frame, in windows of
    ``sample_num_frames`` (a short last window repeated or dropped by
    ``last_frames_handle``); with ``read_long_video`` one window,
    ``1 + k * chunk_size`` frames (causal) or ``k * chunk_size``, none
    when the video is shorter."""
    interval = round(fps / video_params["sample_fps"])
    frame_ids = list(range(0, total, max(1, interval)))
    if read_long_video:
        vl, cs = len(frame_ids), chunk_size
        if is_causal and vl > cs:
            return [frame_ids[: cs * ((vl - 1) // cs) + 1]]
        if not is_causal and vl >= cs:
            return [frame_ids[: cs * (vl // cs)]]
        return []
    n = video_params["sample_num_frames"]
    windows = []
    for x in range(0, len(frame_ids), n):
        ids = frame_ids[x: x + n]
        if len(ids) < n:
            if last_frames_handle == "repeat":
                ids = ids + [ids[-1]] * (n - len(ids))
            elif last_frames_handle == "drop":
                continue
            else:
                raise ValueError(last_frames_handle)
        windows.append(ids)
    return windows


class VidTokValDataset:
    def __init__(self, data_dir: str, video_params: dict,
                 meta_path: Optional[str] = None,
                 pre_load_frames: bool = True, is_strict_loading: bool = True,
                 last_frames_handle: str = "repeat",
                 skip_missing_files: bool = False,
                 read_long_video: bool = False, chunk_size: int = 16,
                 is_causal: bool = True, device="cpu"):
        self.data_dir = data_dir
        self.video_params = video_params
        self.read_long_video = read_long_video
        self.chunk_size = chunk_size
        self.is_causal = is_causal
        self.is_strict_loading = is_strict_loading
        self.last_frames_handle = last_frames_handle
        self.skip_missing_files = skip_missing_files
        self.device = torch.device(device)

        if meta_path is not None:
            paths = [os.path.join(data_dir, r["videos"]) for r in _read_meta(meta_path)]
        else:
            paths = sorted(glob.glob(os.path.join(data_dir, "**", "*.mp4"),
                                     recursive=True))
        self.frames_batch = []
        for path in paths:
            if not os.path.isfile(path):
                continue
            total, fps = video_info(path)
            for ids in window_frame_ids(total, fps, video_params, read_long_video,
                                        chunk_size, is_causal, last_frames_handle):
                self.frames_batch.append({"video_fp": path, "num_frames_ids": ids})
        if pre_load_frames:
            for entry in self.frames_batch:
                entry["frames"] = read_frames_u8(entry["video_fp"], entry["num_frames_ids"])

    def __len__(self):
        return len(self.frames_batch)

    def __getitem__(self, item):
        vp = self.video_params
        entry = self.frames_batch[item]
        frames = entry.get("frames")
        if frames is None:
            frames = read_frames_u8(entry["video_fp"], entry["num_frames_ids"])
        frames = transform_u8(frames, vp["input_height"], vp["input_width"], self.device)
        if not self.read_long_video:
            frames = _pad_tail(frames, vp["sample_num_frames"])
        return {"jpg": frames, "path": entry["video_fp"]}
