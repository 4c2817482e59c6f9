"""On the card, at each cell's own size: the program's spans against the
kernel-name patterns, and the profiler's one clock.

After a warm-up unit (a request, or a stream's first chunk and the next),
one more unit of the cell's traffic runs under ``torch.profiler``, read as
the benchmark reads its traced window (``vtbench/spans.py``). Every device
operation launched under a ``vt.kernel.*`` span matches a pattern of
``kernel_names/*.json``, and every operation a pattern matches was launched
under one: a wrapper's one ``_lib.call`` launches its row passes and its
GEMM alike (the tools' microbenchmarks launch outside the wrappers and
run in no cell). A cell whose frozen call model gives the traced unit
kernel calls (``harness.request_calls``) runs port kernels and the wrappers
count launches; one whose model gives none (a model that runs no port
kernel) runs no operation a pattern matches, opens no ``vt.kernel.*`` span
and counts no launch. In every cell every operation is joined to its
launch on the host and starts after it, up to the profiler's alignment of
the device's clock to the host's (``ALIGN_US``); almost all of the device
time lies under a ``vt.*`` span, so a model without port kernels still puts
its work under spans of its own, and no wrapper rebuilt an operand after
the warm-up."""

import pytest

from vtbench import harness, spans
from vtbench import trace as T
from vtbench_tiny import cells

CELLS = cells()
SEED = 2**33 + 211
# the profiler puts the device's timestamps on the host's clock with an
# alignment error fixed for a session: on an H100 host most traces had no
# operation start before its launch, some had them start up to 0.34 ms and
# 1.34 ms before (PERF.md, Findings); two clocks apart would be seconds
# apart or more
ALIGN_US = 5000.0


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_spans_match_kernel_names_on_one_clock(card, name, tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from vidtok_tpu_torch.ops import kernels as K

    cell = harness.load_cell(name)
    traffic = harness.build_program(cell, SEED, card, {}).traffic
    unit = min(traffic.per_unit, 2)
    traced = range(traffic.per_unit, traffic.per_unit + unit)
    calls = any(harness.request_calls(cell, traffic.kind(i)) for i in traced)
    for i in range(unit):
        traffic.issue(i)
    torch.cuda.synchronize()
    K.reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(T.WINDOW):
            for i in traced:
                traffic.issue(i)
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    s = spans.read(path)
    patterns = T.kernel_patterns(cell.bench_dir / "kernel_names")
    assert s is not None and s.ops
    port = 0
    for op in s.ops:
        named = op.cat == "kernel" and T.family_of(op.name, patterns) is not None
        spanned = any(n.startswith("vt.kernel.") for n in op.under)
        assert named == spanned, (op.name, sorted(op.under))
        assert op.launched is not None, op
        port += named
    launches = sum(K.counts("launches").values())
    print(f"{name}: {'kernel' if calls else 'kernel-free'} branch, {port} port operations, "
          f"{launches} launches")
    if calls:
        assert port > 0 and launches > 0, (port, launches)
    else:
        opened = sorted({sp.name for sp in s.spans if sp.name.startswith("vt.kernel.")})
        assert port == 0 and not opened and launches == 0, (port, opened, launches)
    early = sorted(op.launched - op.start for op in s.ops if op.start < op.launched)
    assert not early or early[-1] <= ALIGN_US, (
        f"{len(early)} of {len(s.ops)} operations start before their launch, "
        f"by {early[0]:.3f} to {early[-1]:.3f} us")
    assert s.unattributed_s <= 0.02 * s.device_s, s.unattributed_s
    assert sum(K.counts("builds").values()) == 0
