"""Profiling helpers (``vidtok_tpu/utils/profiling.py``; reference SURVEY
§5.1: Lightning's simple profiler and the CUDA max-memory report,
main.py:775, 1116-1123): a ``torch.profiler`` trace context, the program's
spans, per-device memory and a parameter-memory line.

The program marks its layer boundaries with :func:`span`: ``vt.engine.*``
(``VideoTokenizer``'s and ``VidTwinTokenizer``'s calls, chunk steps, input
cast and output),
``vt.model.*`` (encoder, decoder, regularizer, and each down- and
upsample module: ``vt.model.down.spatial``, ``.down.temporal``,
``.up.spatial``, ``.up.temporal``; in VidTwin the ST transformers as
``vt.model.encoder`` and ``.decoder``, each block's ``vt.model.attn.spatial``
and ``.attn.temporal`` branch, the structure pathway ``vt.model.structure``
with its ``vt.model.qformer``, the motion pathway ``vt.model.dynamics``, each
posterior's ``vt.model.regularize``), ``vt.stream.cache`` (every read and write of a stream's cache)
and ``vt.kernel.<wrapper>`` (each kernel wrapper from entry to return). A
span is a ``RecordFunction`` range while a profiler records, so it lands
in the profiler's trace (a ``cpu_op`` event) on the clock of the device's
operations, nested under the span that encloses it on the same thread;
with no profiler recording it is one shared no-op context and costs one
check.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

import torch
from torch import nn


_OFF = contextlib.nullcontext()
# the profiler's range at the least host cost: a RecordFunction made in C++
# without record_function's Python op around it (on an H100 host, 1.2 us a
# span against 13 us, and a traced t17 request's device idle 8.3% against
# 14.2% with record_function and 6.4% without spans); record_function
# where torch lacks it
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)


def span(name: str):
    """A context that records the range ``name`` while a profiler records,
    else the shared no-op context: no ``RecordFunction`` is made when
    nothing records."""
    if torch.autograd._profiler_enabled():
        return _RANGE(name)
    return _OFF


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
