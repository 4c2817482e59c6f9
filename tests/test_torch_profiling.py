"""The port's profiling helpers (``vidtok_tpu_torch/utils/profiling.py``)
against ``vidtok_tpu/utils/profiling.py`` on the CPU:
``param_memory_report``'s string for the same parameter count,
``device_memory_report`` without a card, ``trace`` writing a Chrome trace
of a CPU forward, and ``span``: the shared no-op context while no profiler
records, a range in the trace while one does."""

import json
import os

import jax.numpy as jnp
import torch

from vidtok_tpu.utils import profiling as JP
from vidtok_tpu_torch.utils import profiling as P


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


def test_span_is_the_shared_no_op_while_nothing_records():
    assert not torch.autograd._profiler_enabled()
    off = P.span("vt.test")
    assert off is P.span("vt.other") and not isinstance(off, torch.profiler.record_function)
    with off:
        pass


def test_span_is_a_range_in_the_trace(tmp_path):
    conv = torch.nn.Conv2d(3, 8, 3)
    with P.trace(str(tmp_path)) as logdir:
        with P.span("vt.test.outer"):
            with P.span("vt.test.inner"):
                conv(torch.randn(1, 3, 16, 16))
    with open(os.path.join(logdir, "trace.json")) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"}
    outer, inner = events["vt.test.outer"], events["vt.test.inner"]
    assert outer["ts"] <= inner["ts"] and (inner["ts"] + inner["dur"]
                                           <= outer["ts"] + outer["dur"])
