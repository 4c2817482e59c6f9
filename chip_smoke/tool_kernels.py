"""Phase 2 of the card gate, the tools' kernels (``vidtok_tpu_torch/tools``):
kernel B in zero mode, T1 (``fused_fat``), T2 (``fused_diag``, modes mm,
ln, copy) and T3 (``copy_min``, the five tilings that divide) at the
temporal microbenchmark's default [1, 9, 64, 64, 512] and at B's
[1, 20, 256, 256, 128], T1 and T2's mm and ln also at two clips of
33 x 33 (TOOL_PARTIAL, checked, not timed), T4 (``silu_probe``, three
modes) at [64, 512, 512], each gated as the serving kernels are (T4's
bf16 modes against f32 SiLU and value by value against the plain bf16
version, see SILU_UNITS; every copy equal to x), the plain version and
``x.clone()`` (T3, T2's copy) or ``F.silu`` (T4's f32 form) timed with
the L2 flushed before each call, and for T2's mm a cuDNN yardstick (two
k=(3,1,1) convs and the add, ``mm_yardstick``) (``check_tools``); then
both tools' mains on the card at the same shapes, whose rows give the
kernels' times and bounds and whose launches of T1-T4 the result line
reports (``run_tools``, ``tool_entry``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from chip_smoke import (KERNEL_GATE, SILU_SHAPE, SILU_UNITS, TOOL_PARTIAL, TOOL_PARTIAL_ROWS,
                        TOOL_RUNS, TOOL_SHAPES, TOOL_SOURCES, rel_l2)
from chip_smoke.kernels import Params, f32, gate


class ToolCase(NamedTuple):
    """One row of a tool at one shape: the wrapper and plain version on the
    same bf16 arguments, one PyTorch call for the same function (or None),
    a cuDNN yardstick (or None), and whether the row is timed (the tools'
    mains run it) or only checked."""
    name: str
    row: str
    shape: tuple
    kernel: Callable
    plain: Callable
    args: tuple
    library: Callable = None
    yardstick: Callable = None
    timed: bool = True


def mm_yardstick(x, params):
    """T2 ``mm``'s function as cuDNN runs it: two ``F.conv3d`` k=(3, 1, 1)
    on the zero-front-padded input (x padded once, here; h in the call),
    plus the residual add."""
    import torch.nn.functional as F

    xc = x.permute(0, 4, 1, 2, 3)  # [B, C, T, H, W], channels last in memory
    xp = F.pad(xc, (0, 0, 0, 0, 2, 0))
    w1, w2 = (params[n][0][..., None, None].to(x.dtype) for n in ("conv1", "conv2"))

    def run():
        h = F.conv3d(xp, w1)
        return xc + F.conv3d(F.pad(h, (0, 0, 0, 0, 2, 0)), w2)

    return run


def tool_cases(device, names=None):
    """Yield a ``ToolCase`` for kernel B in zero mode (the tool's ``v0
    shipped``), T1, T2 in its three modes (``mm`` with ``mm_yardstick``) and
    T3 at every tiling that divides the shape, at each of TOOL_SHAPES with
    ``Params`` inputs (random norm and conv parameters); T1, T2 ``mm`` and
    ``ln`` at TOOL_PARTIAL, not timed; T4 in its three modes at SILU_SHAPE.
    Rows are named as the tools' mains name them; ``names`` keeps those
    kernels' cases alone."""
    import torch
    import torch.nn.functional as F

    from vidtok_tpu_torch.ops.kernels import fused_temporal
    from vidtok_tpu_torch.tools import microbench_temporal as tm
    from vidtok_tpu_torch.tools import probe_silu_bf16 as tp

    def keep(name):
        return names is None or name in names

    p = Params(5, device)
    for shape in TOOL_SHAPES + (TOOL_PARTIAL,):
        timed = shape != TOOL_PARTIAL
        c = shape[-1]
        x = p.x(shape, torch.bfloat16)
        params = {"norm1": p.norm(c), "conv1": p.conv((c, c, 3)),
                  "norm2": p.norm(c), "conv2": p.conv((c, c, 3))}
        cases = [ToolCase("fused_temporal_resblock", "v0 shipped", shape,
                          fused_temporal.fused_temporal_resblock,
                          fused_temporal.fused_temporal_resblock_plain,
                          (x, *(params[n] for n in ("norm1", "conv1", "norm2", "conv2")),
                           "zero")),
                 ToolCase("fused_fat", "v1 fat", shape, tm.fused_fat, tm.fused_fat_plain,
                          (x, params))]
        for row, mode in tm.DIAG_ROWS:
            cases.append(ToolCase(
                "fused_diag", row, shape, tm.fused_diag, tm.fused_diag_plain,
                (x, params, mode), (lambda x=x: x.clone()) if mode == "copy" else None,
                mm_yardstick(x, params) if mode == "mm" and timed else None))
        b, t, h, w, _ = shape
        for row, tile_s, tile_t in tm.COPY_TILINGS if timed else ():
            if (h * w) % tile_s or t % (tile_t or t):
                if keep("copy_min"):
                    print(f"tools copy_min {shape} {row}: not run, the tile does not "
                          "divide the shape", flush=True)
                continue
            cases.append(ToolCase("copy_min", row, shape, tm.copy_min, tm.copy_min_plain,
                                  (x, tile_s, tile_t), lambda x=x: x.clone()))
        for case in cases:
            if keep(case.name) and (timed or case.row in TOOL_PARTIAL_ROWS):
                yield case._replace(timed=timed)
        del x, cases
    x = tp.probe_input(SILU_SHAPE, device)
    for mode in tp.MODES:
        lib = (lambda: F.silu(x)) if mode == "f32_logistic" else None
        case = ToolCase("silu_probe", mode, SILU_SHAPE, tp.silu_probe, tp.silu_probe_plain,
                        (x, mode), lib)
        if keep(case.name):
            yield case


def ulp_bf16(a):
    """The spacing of bf16 values at |a| (8 significant bits), in f32."""
    import torch

    e = torch.floor(torch.log2(a.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def silu_units(x, plain_out, mode: str):
    """The unit of SILU_UNITS at each value of bf16 x: one ulp of the plain
    output, plus for ``bf16_tanh`` |x| times the grid step of its s, from
    t = tanh(x / 2) in bf16 steps as its plain form takes it."""
    import torch

    unit = ulp_bf16(plain_out)
    if mode == "bf16_tanh":
        t = torch.tanh(x * 0.5)
        unit = unit + x.float().abs() * torch.maximum(ulp_bf16(t), ulp_bf16(t + 1.0)) / 2
    return unit


def check_tools(device, names=None) -> dict:
    """The tools' kernels (B, T1-T4; or those in ``names``) against their
    plain versions at the shapes of ``tool_cases``: relative L2 <=
    KERNEL_GATE against the plain version run in f32 (TF32 off) and <=
    BF16_SLACK x the plain bf16 version's own, and every copy equal to x.
    T4's bf16 forms: relative L2 <= KERNEL_GATE against SiLU in f32, and
    every value within SILU_UNITS of the plain bf16 version
    (``silu_units``). Every gate is checked before the first failure is
    raised. Times (the tools' ``Timer``: the median of CUDA event pairs, the
    L2 flushed before each call) of the plain version in bf16, of the
    library call and of the yardstick, for the timed rows; the kernels' own
    times are their tools' rows (``run_tools``). Returns {kernel: {(shape,
    row): {max_abs_err, plain_ms, library_ms, yardstick_ms}}} of the timed
    rows."""
    import torch
    import torch.nn.functional as F

    from vidtok_tpu_torch.tools import Timer

    timer = Timer(device)
    results, failed = {}, []
    for case in tool_cases(device, names):
        name, row, shape, args = case.name, case.row, case.shape, case.args
        out = case.kernel(*args)
        plain_bf16 = case.plain(*args)
        x = args[0]
        bf16_silu = name == "silu_probe" and row != "f32_logistic"
        ref = F.silu(x.float()) if bf16_silu else case.plain(*f32(args))
        torch.cuda.synchronize()
        if out.shape != x.shape or out.dtype != x.dtype:
            raise AssertionError(f"{name} {shape} {row}: {out.shape}/{out.dtype}")
        err = float((out.float() - ref).abs().max())
        rel, plain_rel = rel_l2(out.float(), ref), rel_l2(plain_bf16.float(), ref)
        note, problem = "", None
        if bf16_silu:
            diff = (out.float() - plain_bf16.float()).abs()
            units = float((diff / silu_units(x, plain_bf16, row)).max())
            ulps = float((diff / ulp_bf16(plain_bf16)).max())
            note = (f" max |kernel - plain bf16| {units:.3g} units ({ulps:.3g} ulps of "
                    "the plain output)")
            if not (rel <= KERNEL_GATE and units <= SILU_UNITS):
                problem = (f"silu_probe {row}: rel_l2 vs f32 silu {rel} > {KERNEL_GATE}, "
                           f"or {units} > {SILU_UNITS} units")
        else:
            try:
                gate(f"{name}{shape} {row}", rel, plain_rel)
            except AssertionError as e:
                problem = str(e)
            if (name == "copy_min" or row == "v4 copy-only") and not torch.equal(out, x):
                problem = f"{name} {shape} {row}: the copy differs from x"
        if problem is not None:
            print(f"GATE FAILED {problem}", flush=True)
            failed.append(problem)
        del out, plain_bf16, ref
        times = ""
        if case.timed:
            plain_ms = timer(lambda: case.plain(*args), iters=10)
            lib_ms, yard_ms = (None if fn is None else timer(fn, iters=10)
                               for fn in (case.library, case.yardstick))
            times = "".join(f" {k} {'none' if v is None else f'{v:.4f}'}" for k, v in (
                ("plain_bf16_ms", plain_ms), ("library_ms", lib_ms),
                ("cudnn_yardstick_ms", yard_ms))) + " (median, L2 flushed)"
            results.setdefault(name, {})[shape, row] = dict(
                max_abs_err=err, plain_ms=plain_ms, library_ms=lib_ms, yardstick_ms=yard_ms)
        print(f"tools {name} {shape} {row}: max_abs_err {err:.4g} rel_l2 {rel:.4g} "
              f"plain_bf16_rel_l2 {plain_rel:.4g}{note}{times or ' (checked, not timed)'}",
              flush=True)
        del args, case
    if failed:
        raise AssertionError(f"{len(failed)} tool gates failed:\n" + "\n".join(failed))
    return results


def run_tools() -> tuple:
    """Both tools' mains on the card (the microbenchmark at TOOL_RUNS, the
    probe at its default), their rows printed. Returns the T1-T4 launches
    of these runs, each of which must be > 0, and the rows by (shape, row
    name)."""
    from vidtok_tpu_torch.tools import microbench_temporal as tm
    from vidtok_tpu_torch.tools import probe_silu_bf16 as tp

    wrappers = {**tm.WRAPPERS, **tp.WRAPPERS}
    for fn in wrappers.values():
        fn.calls = fn.launches = 0
    rows = {}
    for shape, argv in zip(TOOL_SHAPES, TOOL_RUNS):
        print(f"tool microbench_temporal {' '.join(argv)}:", flush=True)
        rows.update(((shape, r["name"]), r) for r in tm.main(argv))
    print("tool probe_silu_bf16 (defaults):", flush=True)
    rows.update(((SILU_SHAPE, r["name"]), r) for r in tp.main([]))
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"tools launches {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name}: no launch in the tools' run")
    return launches, rows


def tool_entry(name: str, checked: dict, launches: int, rows: dict) -> dict:
    """The result line's entry of a tool kernel: its numbers from its row
    named in TOOL_SOURCES at its first shape (T1-T3: TOOL_SHAPES[0], T4:
    SILU_SHAPE), and each of its rows under ``rows``: the time and bound
    from the tool's run, the error, plain and library times from
    ``check_tools``."""
    source, replaces, first_row, headers = TOOL_SOURCES[name]
    first = SILU_SHAPE if name == "silu_probe" else TOOL_SHAPES[0]
    per_row = []
    for (shape, row), c in checked.items():
        r = rows[shape, row]
        per_row.append(dict(shape=list(shape), row=row, ms=r["ms"], plain_ms=c["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=c["library_ms"], yardstick_ms=c["yardstick_ms"],
                            max_abs_err=c["max_abs_err"]))
    head = next(r for r in per_row if r["shape"] == list(first) and r["row"] == first_row)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "headers": list(headers), "launches": launches, "max_abs_err": head["max_abs_err"],
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shape": list(first), "row": first_row, "rows": per_row}
