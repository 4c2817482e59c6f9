"""Profiling helpers (``vidtok_tpu/utils/profiling.py``; reference SURVEY
§5.1: Lightning's simple profiler and the CUDA max-memory report,
main.py:775, 1116-1123): a ``torch.profiler`` trace context, a wall-clock
step timer, per-device memory and a parameter-memory line.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch
from torch import nn


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the body with ``torch.profiler`` (CPU activity, and CUDA's
    when a card is visible) and write a Chrome
    trace, ``trace.json``, under ``logdir`` (default ``torch-trace`` in the
    temporary directory); yields ``logdir``. View it in Perfetto or
    ``chrome://tracing``, or read it with TensorBoard's profiler plugin."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield logdir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock EMA step timer with throughput reporting."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.ema = None
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else (
            self.decay * self.ema + (1 - self.decay) * dt)
        return dt


def device_memory_report() -> dict:
    """``{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}}`` for each
    visible CUDA device: the caching allocator's allocated bytes now and at
    their peak (``torch.cuda.max_memory_allocated``) and the card's total
    memory; ``{}`` without CUDA."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[str(torch.device("cuda", i))] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return out


def param_memory_report(module: nn.Module, dtype_bytes: int = 4) -> str:
    n = sum(p.numel() for p in module.parameters())
    return (f"{n/1e6:.1f}M params, "
            f"{n*dtype_bytes/1e9:.2f} GB at {dtype_bytes}B/param "
            f"({n*2/1e9:.2f} GB bf16)")
