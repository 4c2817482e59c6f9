"""The port's profiling helpers (``vidtok_tpu_torch/utils/profiling.py``)
against ``vidtok_tpu/utils/profiling.py`` on the CPU: ``StepTimer``'s EMA
on the same durations (``time.perf_counter`` patched in both modules),
``param_memory_report``'s string for the same parameter count,
``device_memory_report`` without a card, and ``trace`` writing a Chrome
trace of a CPU forward."""

import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from vidtok_tpu.utils import profiling as JP
from vidtok_tpu_torch.utils import profiling as P


def test_step_timer(monkeypatch):
    ticks = iter(np.cumsum([0.0, 0.5, 0.1, 0.3, 0.2, 0.05, 0.7]))
    clock = {"now": 0.0}

    def perf_counter():
        return clock["now"]

    monkeypatch.setattr(JP.time, "perf_counter", perf_counter)
    monkeypatch.setattr(P.time, "perf_counter", perf_counter)
    jt, pt = JP.StepTimer(decay=0.8), P.StepTimer(decay=0.8)
    clock["now"] = next(ticks)
    for start, end in zip(ticks, ticks):
        clock["now"] = start
        jt.tic()
        pt.tic()
        clock["now"] = end
        assert jt.toc() == pt.toc()
        assert jt.ema == pt.ema
    assert pt.ema is not None


def test_param_memory_report():
    model = torch.nn.Sequential(torch.nn.Linear(300, 1000), torch.nn.Conv2d(8, 16, 3))
    shapes = [tuple(p.shape) for p in model.parameters()]
    tree = {f"p{i}": jnp.zeros(s) for i, s in enumerate(shapes)}
    for dtype_bytes in (4, 2):
        assert P.param_memory_report(model, dtype_bytes) == JP.param_memory_report(
            tree, dtype_bytes)
    assert P.param_memory_report(model).startswith("0.3M params")


def test_device_memory_report_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert P.device_memory_report() == {}


def test_trace_writes_a_file(tmp_path):
    conv = torch.nn.Conv2d(3, 8, 3)
    with P.trace(str(tmp_path / "trace")) as logdir:
        conv(torch.randn(1, 3, 16, 16))
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
