"""Microbenchmark of the temporal residual block's parts on the card: the
counterpart of the JAX package's ``tools/microbench_temporal.py``.

    python -m vidtok_tpu_torch.tools.microbench_temporal [C T S] [--device cpu]

x is ``[1, T, S, S, C]`` bf16 (default ``512 9 64``). Rows: the copy
floor at five tilings (T3, ``copy_min``), a plain torch round trip, kernel
B (``v0 shipped``, zero mode), the fat-product form of B (T1,
``fused_fat``) and B's parts (T2, ``fused_diag``: the two products alone,
the two LN+SiLU passes alone, the copy alone), each with its bound and the
share of it reached. Then ``v1 == v0`` within 3e-2: v0 takes the fast
LN+SiLU, v1 the exact one.

Kernels: ``csrc/microbench_temporal.cu``. T1's and T2's products run
kernel B's own loop, the TMA + wgmma implicit GEMM of
``csrc/wgmma_conv.cuh``, with B's weight operands and tensor maps
(``_lib.operands``, one entry per block, shared with B): T2's ``mm`` row
(tap set ``kCausal``, ``plan.conv_plan_temporal``) times B's two products
as B runs them, its zero front read from TMA's zero fill; T1's (tap set
``kDense``, ``plan.conv_plan_dense``) two dense ``[M, 3C] x [3C, C]``
products over an explicit fat operand. T1's fat-row pass and T2's ``ln``
run whole-warp exact row passes in ``act_rows_kernel``'s layout
(``plan.row_layout``), so T2's ``ln`` row times the row pass B uses with
the exact statistics in place of the fast ones. Each wrapper runs its plain
PyTorch version for a CPU tensor and its kernel for a CUDA tensor (or
raises), and counts ``calls`` and ``launches`` (T1 and T2 ``mm`` also
``conv_tiles`` and ``conv_blocks``, as ``_lib.count_conv``). One
deliberate divergence:
JAX's grids (``s // tile_s``, ``t // tile_t``) leave a non-dividing tile's
remainder uncopied; here such a tile raises, and ``main`` prints its row as
not run.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.kernels import _lib, plan
from ..ops.kernels.act import ln_silu_exact_f32
from ..ops.kernels.fused_temporal import (block_operands, fused_temporal_resblock,
                                          gemm_weight)
from . import Timer, bound_ms, parse_args, report

DIAG_MODES = {"copy": 0, "mm": 1, "ln": 2}
# (row name, tile_s, tile_t), as the JAX tool's main
COPY_TILINGS = (("copy min128", 128, None), ("copy min256", 256, None),
                ("copy t1 s512", 512, 1), ("copy t1 s4096", 4096, 1),
                ("copy t3 s1024", 1024, 3))
# (row name, mode) of fused_diag's rows, as the JAX tool's main
DIAG_ROWS = (("v2 mm-only", "mm"), ("v3 ln-only", "ln"), ("v4 copy-only", "copy"))
V1_V0_ATOL = 3e-2


def params_from_jax(params, device="cpu") -> dict:
    """The JAX tool's flax-layout ``params`` (``norm*``: scale, bias;
    ``conv*``: kernel ``[3, 1, 1, Ci, Co]``, bias) as the port's: ``norm*``
    (g, b) and ``conv*`` (Conv1d weight ``[Co, Ci, 3]``, bias), f32 on
    ``device``."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    out = {n: (t(params[n]["scale"]), t(params[n]["bias"])) for n in ("norm1", "norm2")}
    for n in ("conv1", "conv2"):
        k = t(params[n]["kernel"])
        taps, ci, co = k.shape[0], k.shape[-2], k.shape[-1]
        out[n] = (k.reshape(taps, ci, co).permute(2, 1, 0).contiguous(),
                  t(params[n]["bias"]))
    return out


def _fat(a):
    """``[B, T, H, W, C]`` -> ``[B, T, H, W, 3C]``: ``[a(t-2) | a(t-1) |
    a(t)]``, zeros before frame 0."""
    t = a.shape[1]
    pad = torch.cat([a.new_zeros((a.shape[0], 2) + a.shape[2:]), a], 1)
    return torch.cat([pad[:, j:j + t] for j in range(3)], -1)


def _tconv(a, weight):
    """Causal k=3 time conv of ``a`` (zero front) with Conv1d ``weight``
    ``[Co, Ci, 3]`` cast to a's dtype, as one fat product, accumulated in
    f32; no bias."""
    return torch.matmul(_fat(a).float(), gemm_weight(weight, a.dtype).float())


def fused_fat_plain(x, params, eps: float = 1e-6):
    """Plain PyTorch form of T1: ``x + conv2(ln_silu(conv1(ln_silu(x))))``
    with the exact LN+SiLU, both convs causal k=3 with a zero front, h and y
    in f32 with their biases, the second LN on the unrounded h."""
    dt = x.dtype
    (g1, b1), (w1, c1) = params["norm1"], params["conv1"]
    (g2, b2), (w2, c2) = params["norm2"], params["conv2"]
    h = _tconv(ln_silu_exact_f32(x, g1, b1, eps), w1) + c1.float()
    y = _tconv(ln_silu_exact_f32(h, g2, b2, eps).to(dt), w2) + c2.float()
    return (x.float() + y).to(dt)


def fused_diag_plain(x, params, mode: str = "mm", eps: float = 1e-6):
    """Plain PyTorch form of T2 (see :func:`fused_diag`)."""
    dt = x.dtype
    if mode == "copy":
        return x.clone()
    if mode == "mm":
        h = _tconv(x, params["conv1"][0]).to(dt)
        y = _tconv(h, params["conv2"][0])
    else:
        a = ln_silu_exact_f32(x, *params["norm1"], eps)
        y = ln_silu_exact_f32(a, *params["norm2"], eps).float()
    return (x.float() + y).to(dt)


def copy_min_plain(x, tile_s: int = 128, tile_t: int = None):
    """Plain PyTorch form of T3: the blocked copy as one ``copy_``."""
    b, t, h, w, c = x.shape
    tt = tile_t or t
    out = torch.empty_like(x)
    shape = (b, t // tt, tt, h * w // tile_s, tile_s, c)
    out.view(shape).copy_(x.view(shape))
    return out


def _check_clip(x, params=None) -> None:
    """Raise unless x is a contiguous bf16 CUDA ``[B, T, H, W, C]`` with
    C % 8 == 0, and ``params`` (if given) the block's at C on x's device."""
    if x.dim() != 5:
        raise ValueError(f"x must be [B, T, H, W, C], got {tuple(x.shape)}")
    _lib.require(x, torch.bfloat16, x.shape)
    c = x.shape[-1]
    if c % 8:
        raise ValueError(f"the kernels take C % 8 == 0, got C={c}")
    if params is None:
        return
    for name, shape in (("norm1", (c,)), ("norm2", (c,)), ("conv1", (c, c, 3)),
                        ("conv2", (c, c, 3))):
        for v, want in zip(params[name], (shape, (c,))):
            if tuple(v.shape) != want:
                raise ValueError(f"{name}: {tuple(v.shape)} != {want}")
            _lib.same_device(v, x)


def _operands(params) -> dict:
    """The block's parameters as kernel B reads them, shared with B."""
    return block_operands(*(params[n] for n in ("norm1", "conv1", "norm2", "conv2")))


def fused_fat(x, params):
    """T1, replacing ``tools/microbench_temporal.py:53`` ``fused_fat``: kernel
    B in zero mode with the exact LN+SiLU and each conv's three taps as one
    ``[M, 3C] x [3C, C]`` product. x ``[B, T, H, W, C]``; ``params`` as
    :func:`params_from_jax` gives them.

    A CPU tensor runs :func:`fused_fat_plain`. A CUDA tensor must be
    contiguous bf16 with C % 8 == 0, 8 to 1024 (``plan.conv_plan_dense``,
    the row pass); it runs the kernel (scratch:
    the fat operand ``[M, 3C]`` bf16 and h ``[M, C]`` f32) or raises.
    """
    fused_fat.calls += 1
    if x.device.type == "cpu":
        return fused_fat_plain(x, params)
    _check_clip(x, params)
    b, t, h, w, c = x.shape
    m = b * t * h * w
    pl = plan.conv_plan_dense(m, 3 * c, c)
    plan.check_row_channels(c)
    op = _operands(params)
    map1, map2 = _lib.weight_maps(op, pl.bn, "w1", "w2")
    fat = x.new_empty((m, 3 * c))
    hf = torch.empty((m, c), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    _lib.call("vt_microbench_fat", x, out, fat, hf, op["g1"], op["b1"], map1, op["bias1"],
              op["g2"], op["b2"], map2, op["bias2"], b, t, h * w, c, pl.bn, pl.stages,
              pl.smem, pl.grid)
    fused_fat.launches += 1
    _lib.count_conv(fused_fat, pl, 2)  # the two dense products
    return out


def fused_diag(x, params, mode: str = "mm"):
    """T2, replacing ``tools/microbench_temporal.py:102`` ``fused_diag``: one
    part of kernel B alone. ``copy``: ``out = x``. ``mm``: the two causal
    k=3 time convs with a zero front, no bias, no LN, h rounded to x's
    dtype, ``out = x + y`` in f32. ``ln``: ``a1 = ln_silu(x; norm1)``,
    ``a2 = ln_silu(a1; norm2)``, exact, each rounded to x's dtype,
    ``out = x + a2`` in f32.

    A CPU tensor runs :func:`fused_diag_plain`. A CUDA tensor must be
    contiguous bf16 with C % 8 == 0 (``mm`` and ``ln``: 8 to 1024,
    ``plan.conv_plan_temporal``, ``plan.row_layout``); it
    runs the kernel or raises. An unknown mode raises.
    """
    fused_diag.calls += 1
    if mode not in DIAG_MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {tuple(DIAG_MODES)}")
    if x.device.type == "cpu":
        return fused_diag_plain(x, params, mode)
    _check_clip(x, params)
    b, t, h, w, c = x.shape
    out = torch.empty_like(x)
    hb = g1 = b1 = map1 = g2 = b2 = map2 = None  # what the mode reads
    bn = stages = smem = grid = 0
    if mode == "mm":
        pl = plan.conv_plan_temporal(b, t, h * w, c)
        bn, stages, smem, grid = pl.bn, pl.stages, pl.smem, pl.grid
        map1, map2 = _lib.weight_maps(_operands(params), bn, "w1", "w2")
        hb = torch.empty_like(x)
    elif mode == "ln":
        plan.check_row_channels(c)
        op = _operands(params)
        g1, b1, g2, b2 = (op[k] for k in ("g1", "b1", "g2", "b2"))
    _lib.call("vt_microbench_diag", x, out, hb, g1, b1, map1, g2, b2, map2,
              b, t, h * w, c, DIAG_MODES[mode], bn, stages, smem, grid)
    fused_diag.launches += 1
    if mode == "mm":
        _lib.count_conv(fused_diag, pl, 2)  # the two causal convs
    return out


def copy_min(x, tile_s: int = 128, tile_t: int = None):
    """T3, replacing ``tools/microbench_temporal.py:130`` ``copy_min``: a copy
    of x ``[B, T, H, W, C]``, one unit of ``tile_t`` frames (default T) x
    ``tile_s`` positions x C at a time, the TPU's copy floor. A tile that
    does not divide T or H*W raises (JAX leaves the remainder uncopied).

    A CPU tensor runs :func:`copy_min_plain`. A CUDA tensor must be
    contiguous bf16 with C % 8 == 0; it runs the kernel or raises.
    """
    copy_min.calls += 1
    b, t, h, w, c = x.shape
    tt = tile_t or t
    if not (0 < tile_s and (h * w) % tile_s == 0 and 0 < tt and t % tt == 0):
        raise ValueError(f"tile (tile_t {tt}, tile_s {tile_s}) does not divide "
                         f"(T {t}, H*W {h * w})")
    if x.device.type == "cpu":
        return copy_min_plain(x, tile_s, tile_t)
    _check_clip(x)
    out = torch.empty_like(x)
    _lib.call("vt_copy_units", x, out, b, t, h * w, c, tt, tile_s)
    copy_min.launches += 1
    return out


WRAPPERS = {"fused_fat": fused_fat, "fused_diag": fused_diag, "copy_min": copy_min}
for _fn in WRAPPERS.values():
    _fn.calls = _fn.launches = _fn.conv_tiles = _fn.conv_blocks = 0


def tool_inputs(c: int, t: int, s: int, device):
    """The JAX tool's draws (``RandomState(0)``): x ``[1, T, S, S, C]`` =
    0.1 N(0, 1) in bf16, norm scales 1 and biases 0, conv kernels 0.02
    N(0, 1), conv biases 0; params in the port's layout on ``device``."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, t, s, s, c).astype(np.float32) * 0.1)
    ones, zeros = np.ones((c,)), np.zeros((c,))
    params = {"norm1": {"scale": ones, "bias": zeros},
              "norm2": {"scale": ones, "bias": zeros},
              "conv1": {"kernel": rng.randn(3, 1, 1, c, c) * 0.02, "bias": zeros},
              "conv2": {"kernel": rng.randn(3, 1, 1, c, c) * 0.02, "bias": zeros}}
    return x.to(device, torch.bfloat16), params_from_jax(params, device)


def block_flops(shape) -> int:
    """FLOP of the block's two k=3 time convs over x ``shape``."""
    b, t, h, w, c = shape
    return 2 * 2 * 3 * b * t * h * w * c * c


def diag_bound(shape, mode: str) -> tuple:
    """Bound of one ``fused_diag`` call: x read, out written (``mm``: and
    its two bf16 weights; ``ln``: its four f32 norm vectors), and ``mm``'s
    products or ``ln``'s ~20 FLOP per value of each pass."""
    n, c = int(np.prod(shape)), shape[-1]
    if mode == "mm":
        return bound_ms(4 * n + 2 * 2 * 3 * c * c, block_flops(shape))
    if mode == "ln":
        return bound_ms(4 * n + 4 * 4 * c, vec_flops=2 * 20 * n)
    return bound_ms(4 * n)


def fat_bound(shape) -> tuple:
    """Bound of one ``fused_fat`` (or kernel B) call: x read, out written,
    two bf16 weights and six f32 vectors, the products' FLOP."""
    n, c = int(np.prod(shape)), shape[-1]
    return bound_ms(4 * n + 2 * 2 * 3 * c * c + 4 * 6 * c, block_flops(shape))


def main(argv=None) -> list:
    """Print the rows for ``[C T S] [--device cpu]``; return them."""
    (c, t, s), device = parse_args(sys.argv[1:] if argv is None else argv, (512, 9, 64))
    x, params = tool_inputs(c, t, s, device)
    timer = Timer(device)
    shape = tuple(x.shape)
    copy_bound = bound_ms(2 * x.numel() * x.element_size())
    flops = block_flops(shape)
    print(f"x {list(shape)} bf16 on {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)

    def gbs(ms):
        return f"{2 * x.numel() * x.element_size() / ms / 1e6:8.0f} GB/s"

    def tflops(ms):
        return f"{flops / ms / 1e9:8.1f} TFLOP/s"

    rows = []
    with torch.no_grad():
        for name, tile_s, tile_t in COPY_TILINGS:
            tt = tile_t or t
            if (s * s) % tile_s or t % tt:
                print(f"{name:16s} not run: tile (tile_t {tt}, tile_s {tile_s}) does "
                      f"not divide (T {t}, H*W {s * s})", flush=True)
                continue
            ms = timer(lambda: copy_min(x, tile_s, tile_t))
            rows.append(report(name, ms, copy_bound, device, gbs(ms)))
        ms = timer(lambda: x * 1.000001)
        rows.append(report("torch roundtrip", ms, copy_bound, device, gbs(ms)))
        norm1, conv1, norm2, conv2 = (params[n] for n in ("norm1", "conv1", "norm2", "conv2"))
        o0 = fused_temporal_resblock(x, norm1, conv1, norm2, conv2, "zero")
        ms = timer(lambda: fused_temporal_resblock(x, norm1, conv1, norm2, conv2, "zero"))
        rows.append(report("v0 shipped", ms, fat_bound(shape), device, tflops(ms)))
        o1 = fused_fat(x, params)
        ms = timer(lambda: fused_fat(x, params))
        rows.append(report("v1 fat", ms, fat_bound(shape), device, tflops(ms)))
        for name, mode in DIAG_ROWS:
            ms = timer(lambda: fused_diag(x, params, mode))
            rate = tflops(ms) if mode == "mm" else gbs(ms)
            rows.append(report(name, ms, diag_bound(shape, mode), device, rate))
    err = float((o0.float() - o1.float()).abs().max())
    if not err <= V1_V0_ATOL:
        raise AssertionError(f"v1 vs v0: max abs {err} > {V1_V0_ATOL}")
    print(f"v1 == v0 within atol {V1_V0_ATOL} (max abs {err:.4g})", flush=True)
    return rows


if __name__ == "__main__":
    main()
