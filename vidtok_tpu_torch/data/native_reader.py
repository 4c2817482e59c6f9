"""ctypes binding of the repo's native (C++/FFmpeg) video ingest library,
``native/libvidtok_ingest.so`` (built by ``native/build.sh``): libavformat
demux, libavcodec decode and libswscale RGB conversion in one sweep.

The port's own copy of ``vidtok_tpu/data/native_reader.py``; its gather
returns the decoded uint8 frames (the caller scales them).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence, Tuple

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native", "libvidtok_ingest.so"),
    "libvidtok_ingest.so",
]

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        for p in _LIB_PATHS:
            try:
                lib = ctypes.CDLL(p)
            except OSError:
                continue
            lib.vt_open.restype = ctypes.c_void_p
            lib.vt_open.argtypes = [ctypes.c_char_p]
            lib.vt_close.argtypes = [ctypes.c_void_p]
            lib.vt_num_frames.restype = ctypes.c_int64
            lib.vt_num_frames.argtypes = [ctypes.c_void_p]
            lib.vt_fps.restype = ctypes.c_double
            lib.vt_fps.argtypes = [ctypes.c_void_p]
            lib.vt_width.restype = ctypes.c_int
            lib.vt_width.argtypes = [ctypes.c_void_p]
            lib.vt_height.restype = ctypes.c_int
            lib.vt_height.argtypes = [ctypes.c_void_p]
            lib.vt_gather.restype = ctypes.c_int64
            lib.vt_gather.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ]
            _lib = lib
            return _lib
        return None


def available() -> bool:
    return _load() is not None


class NativeVideoReader:
    """One decoder handle per reader; use one per thread."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("libvidtok_ingest.so not built (run native/build.sh)")
        self._lib = lib
        self._h = lib.vt_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open video {path}")
        self.path = path

    def close(self):
        if self._h:
            self._lib.vt_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def num_frames(self) -> int:
        return int(self._lib.vt_num_frames(self._h))

    @property
    def fps(self) -> float:
        return float(self._lib.vt_fps(self._h))

    @property
    def size(self) -> Tuple[int, int]:
        return (int(self._lib.vt_height(self._h)), int(self._lib.vt_width(self._h)))

    def gather(self, indices: Sequence[int]) -> np.ndarray:
        """Decode the frames at ``indices`` -> uint8 [T, H, W, 3] RGB at
        the video's size (the library's resize-on-decode is not used)."""
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        h, w = self.size
        buf = np.empty((len(idx), h, w, 3), np.uint8)
        filled = self._lib.vt_gather(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 0, 0)
        if filled != len(idx):
            raise IOError(f"decoded {filled}/{len(idx)} frames from {self.path}")
        return buf


def native_video_info(path: str) -> Tuple[int, float]:
    r = NativeVideoReader(path)
    try:
        return r.num_frames, r.fps
    finally:
        r.close()
