"""What the port's CLIs share: their added flags, the tokenizer load, the
tiling settings, the frames they sample, and a clock for their compute."""

from __future__ import annotations

import time
from collections import defaultdict

import torch

from .. import load_model_from_config


def add_port_args(p) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs (cpu for a machine without a card)")
    p.add_argument("--full_pickle", action="store_true",
                   help="load a torch --ckpt with its full pickle (runs code "
                        "from the file: only for a file you trust)")


def load_tokenizer(args):
    """The tokenizer of ``args.config`` (a YAML path or a config dict) with
    ``args.ckpt``'s weights on ``args.device``, bf16 with ``args.bf16``."""
    return load_model_from_config(
        args.config, ckpt=args.ckpt, device=args.device,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        full_pickle=args.full_pickle)


def set_tiling(tok, chunk_size: int) -> None:
    """The scripts' long-video setting: tiled with overlap, ``chunk_size``
    frames an encoder chunk."""
    tok.use_tiling = True
    tok.t_chunk_enc = chunk_size
    tok.t_chunk_dec = chunk_size // tok.time_downsample_factor
    tok.use_overlap = True


def frame_ids(total: int, fps: float, sample_fps: int, chunk_size: int,
              is_causal: bool, read_long_video: bool) -> list:
    """Every ``round(fps / sample_fps)``-th frame of a video; for
    ``read_long_video`` cut to ``1 + k * chunk_size`` frames (causal) or
    ``k * chunk_size``."""
    ids = list(range(0, total, max(1, round(fps / sample_fps))))
    if read_long_video:
        vl, cs = len(ids), chunk_size
        ids = ids[: cs * ((vl - 1) // cs) + 1] if is_causal else ids[: cs * (vl // cs)]
    return ids


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Host seconds by part: ``lap(name)`` waits for the device and adds
    the time since the previous lap (or the start) to ``seconds[name]``."""

    def __init__(self, device):
        self.device = device
        self.seconds = defaultdict(float)
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.seconds[name] += now - self.t
        self.t = now
