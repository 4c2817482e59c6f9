"""Kernels B and F: the fused causal temporal residual block (layernorm).

B replaces ``vidtok_tpu/ops/pallas/fused_temporal.py:205``
(``fused_temporal_resblock``), over a whole clip::

    y = x + conv2_t(ln_silu2(conv1_t(ln_silu1(x))))

both convs causal k=3 over time, C -> C, the residual added in f32.
CUDA: ``csrc/fused_temporal.cu``. The front pad applies to the ACTIVATED
tensor: ``replicate`` repeats activated frame 0, ``zero`` masks the taps
before frame 0.

F replaces ``fused_temporal.py:274`` (``fused_temporal_resblock_stream``):
the same block over one chunk of a stream, each conv's front being its
2-frame cache of activated frames (activated frame 0 twice on the first
chunk), the new caches stored ``offset`` frames back. CUDA:
``csrc/fused_temporal_stream.cu``.

Both run ``csrc/temporal_block.cuh`` on the TMA + wgmma loop of
``csrc/wgmma_conv.cuh``, launched with ``plan.conv_plan_temporal``'s plan
over a scratch of ``t + 2`` frames per clip whose first two are the front
(B: the stream-start rule; F: the caches). Both take their weights from
``_lib.operands`` (one entry per block, shared by B and F): relaid out
once per parameter, not at every call.

Both take bf16 or f32 activations (f32: the caches too); f32 runs the
loop's f32 scheme (``split.py``): the scratch holds the activations' bf16
pieces, a plane each, and the weights are split once per parameter
(:func:`temporal_operands` with ``split``). C is any multiple of 8 up to
1024 (``plan.check_channels``).
"""

from __future__ import annotations

import functools

import torch

from . import _lib, plan
from .act import ln_silu
from .split import PIECES, kmajor_pieces
from ...modules.conv import conv3d_cl, pad_time_front
from ...modules.stream import tail


def _tconv3(a, weight, mode):
    """Causal k=3 temporal conv of [B,T,H,W,Ci] with Conv1d weight [O,I,3]."""
    return conv3d_cl(pad_time_front(a, 2, mode), weight[..., None, None])


def gemm_weight(weight, dtype=torch.bfloat16):
    """Conv1d weight ``[Co, Ci, k]`` -> ``[(k, ci), co]``, tap-major,
    contiguous, in ``dtype``: the right factor of the fat product
    ``[a(t-2) | a(t-1) | a(t)] @ w`` of the tools' plain T1 and T2, the
    transpose of :func:`kmajor_weight`."""
    return weight.permute(2, 1, 0).reshape(-1, weight.shape[0]).to(dtype).contiguous()


def kmajor_weight(weight, dtype=torch.bfloat16):
    """Conv1d weight ``[Co, Ci, k]`` -> the wgmma loop's K-major operand
    ``[co, (k, ci)]``, contiguous, in ``dtype``."""
    return weight.permute(0, 2, 1).reshape(weight.shape[0], -1).to(dtype).contiguous()


def temporal_operands(w1, g1, b1, bias1, g2, b2, w2, bias2, split: bool = False) -> dict:
    """Kernels B's and F's parameters as they read them (conv1's weight,
    norm1, conv1's bias, norm2, conv2): the K-major bf16 ``kmajor_weight``
    of each conv and the f32 vectors; ``layouts`` how the loop reads each
    weight (``_lib.weight_layout``), ``maps`` the weights' tensor maps by
    BN. ``split``: the f32 scheme's operands, each conv's K-major f32
    weight as its bf16 pieces ``[C, 3 * 3C]``."""
    pack = ((lambda w: kmajor_pieces(kmajor_weight(w, torch.float32))) if split
            else kmajor_weight)
    layout = _lib.weight_layout(w1.shape[0], 3, 0, PIECES if split else 1)
    return {"w1": pack(w1), "w2": pack(w2),
            **{k: _lib.f32(v) for k, v in (("g1", g1), ("b1", b1), ("bias1", bias1),
                                           ("g2", g2), ("b2", b2), ("bias2", bias2))},
            "layouts": {"w1": layout, "w2": layout}, "maps": {}}


def block_operands(norm1, conv1, norm2, conv2, f32: bool = False) -> dict:
    """A block's ``temporal_operands`` (``f32``: with ``split``),
    built once per parameter (``_lib.operands``): one entry per block, which
    B, F and the temporal microbenchmark's T1 and T2 all read."""
    return _lib.operands("fused_temporal_resblock_f32" if f32 else "fused_temporal_resblock",
                         (conv1[0], *norm1, conv1[1], *norm2, *conv2),
                         functools.partial(temporal_operands, split=f32))


def _block_operands(name, norm1, conv1, norm2, conv2, x) -> tuple:
    """(operands, plan, weight maps) of kernel ``name`` (B or F) for x
    ``[B, t, H, W, C]``: the dtype's and the plan's refusals first, then the
    device, shape and weights' checks."""
    b, t, h, w, c = x.shape
    f32 = _lib.kernel_dtype(x, name) == torch.float32
    pl = plan.conv_plan_temporal(b, t, h * w, c, f32)
    _lib.require(x, x.dtype, (b, t, h, w, c))
    for cw in (conv1[0], conv2[0]):
        if tuple(cw.shape) != (c, c, 3):
            raise ValueError(f"kernel {name} takes two causal k=3 convs C->C")
    op = block_operands(norm1, conv1, norm2, conv2, f32)
    for k, v in op.items():
        if k not in ("maps", "layouts"):
            _lib.same_device(v, x)
    return op, pl, _lib.weight_maps(op, pl.bn, "w1", "w2")


def fused_temporal_resblock_plain(x, norm1, conv1, norm2, conv2,
                                  first_pad_mode: str = "zero",
                                  eps: float = 1e-6):
    """Plain PyTorch form. x: ``[B, T, H, W, C]``; ``conv*`` are
    (Conv1d weight ``[C, C, 3]``, bias)."""
    dt = x.dtype
    a = ln_silu(x, norm1[0], norm1[1], eps)
    h = _tconv3(a, conv1[0], first_pad_mode).float() + conv1[1].float()
    a = ln_silu(h.to(dt), norm2[0], norm2[1], eps)
    y = _tconv3(a, conv2[0], first_pad_mode).float() + conv2[1].float()
    return (x.float() + y).to(dt)


@_lib.wrapper
def fused_temporal_resblock(x, norm1, conv1, norm2, conv2,
                            first_pad_mode: str = "zero"):
    """x: ``[B, T, H, W, C]`` -> same shape.

    A CPU tensor runs :func:`fused_temporal_resblock_plain`. Otherwise x
    must be a contiguous bf16 or f32 CUDA tensor whose channels the plan takes
    (``plan.conv_plan_temporal``: C % 8 == 0, 8 to 1024); it runs the
    kernel or raises.
    """
    if first_pad_mode not in ("zero", "replicate"):
        raise ValueError(f"unknown first_pad_mode {first_pad_mode!r}")
    if x.device.type == "cpu":
        return fused_temporal_resblock_plain(x, norm1, conv1, norm2, conv2,
                                             first_pad_mode)
    op, pl, (map1, map2) = _block_operands("B", norm1, conv1, norm2, conv2, x)
    b, t, h, w, c = x.shape
    out = torch.empty_like(x)
    h1 = torch.empty_like(x)
    act = _scratch(x, b, t, h, w, c)
    entry = "vt_fused_temporal_resblock" + ("_f32" if x.dtype == torch.float32 else "")
    _lib.call(entry, x, out, h1, act, op["g1"], op["b1"], map1,
              op["bias1"], op["g2"], op["b2"], map2, op["bias2"], b, t, h * w, c,
              int(first_pad_mode == "replicate"), pl.bn, pl.stages, pl.smem, pl.grid)
    fused_temporal_resblock.launches += 1
    _lib.count_conv(fused_temporal_resblock, pl, 2)  # conv1, conv2
    return out


def _scratch(x, b, t, h, w, c):
    """[front | activated clip] of B and F: bf16 ``[b, t + 2, h, w, c]``,
    or for f32 x the activations' bf16 pieces, a plane each,
    ``[3, b, t + 2, h, w, c]``."""
    if x.dtype == torch.float32:
        return x.new_empty((PIECES, b, t + 2, h, w, c), dtype=torch.bfloat16)
    return x.new_empty((b, t + 2, h, w, c))


def _stream_conv(a, cache, conv, first_chunk: bool, offset: int):
    """VALID k=3 time conv of ``[cache | a]`` (first chunk: ``a[0]`` twice)
    in f32 with the bias; and the new cache, ``offset`` frames back."""
    front = (a[:, :1].expand(-1, 2, *a.shape[2:]) if first_chunk
             else cache.to(a.dtype))
    full = torch.cat([front, a], dim=1)
    y = conv3d_cl(full, conv[0][..., None, None]).float() + conv[1].float()
    return y, tail(full, 2, offset)


def fused_temporal_resblock_stream_plain(x, norm1, conv1, norm2, conv2, c1, c2,
                                         first_chunk: bool, offset: int = 0,
                                         eps: float = 1e-6):
    """Plain PyTorch form of one chunk step. x: ``[B, t, H, W, C]``; c1, c2:
    ``[B, 2, H, W, C]`` activated frames (unused on the first chunk) ->
    (y, new c1, new c2)."""
    dt = x.dtype
    a = ln_silu(x, norm1[0], norm1[1], eps)
    h, nc1 = _stream_conv(a, c1, conv1, first_chunk, offset)
    a = ln_silu(h.to(dt), norm2[0], norm2[1], eps)
    y, nc2 = _stream_conv(a, c2, conv2, first_chunk, offset)
    return (x.float() + y).to(dt), nc1, nc2


@_lib.wrapper
def fused_temporal_resblock_stream(x, norm1, conv1, norm2, conv2, c1, c2,
                                   first_chunk: bool, offset: int = 0):
    """One chunk step: x ``[B, t, H, W, C]`` and the caches -> (y, new c1,
    new c2); raises when ``t < offset`` (the new cache would reach into the
    previous chunk).

    A CPU tensor runs :func:`fused_temporal_resblock_stream_plain`.
    Otherwise x must be a contiguous bf16 or f32 CUDA tensor whose channels
    the plan takes (``plan.conv_plan_temporal``: C % 8 == 0, 8 to 1024),
    and the caches after the first chunk of x's dtype; it runs the kernel
    or raises.
    """
    b, t, h, w, c = x.shape
    if not 0 <= offset <= t:
        raise ValueError(f"kernel F: offset {offset} outside a {t}-frame chunk")
    if x.device.type == "cpu":
        return fused_temporal_resblock_stream_plain(
            x, norm1, conv1, norm2, conv2, c1, c2, first_chunk, offset)
    op, pl, (map1, map2) = _block_operands("F", norm1, conv1, norm2, conv2, x)
    if first_chunk:
        c1 = c2 = None
    else:
        for cache in (c1, c2):
            _lib.require(cache, x.dtype, (b, 2, h, w, c))
    out = torch.empty_like(x)
    h1 = torch.empty_like(x)
    act = _scratch(x, b, t, h, w, c)
    nc1 = x.new_empty((b, 2, h, w, c))
    nc2 = torch.empty_like(nc1)
    entry = "vt_fused_temporal_resblock_stream" + ("_f32" if x.dtype == torch.float32 else "")
    _lib.call(entry, x, c1, c2, out, nc1, nc2,
              h1, act, op["g1"], op["b1"], map1, op["bias1"], op["g2"], op["b2"],
              map2, op["bias2"], b, t, h * w, c, int(first_chunk), offset, pl.bn,
              pl.stages, pl.smem, pl.grid)
    fused_temporal_resblock_stream.launches += 1
    _lib.count_conv(fused_temporal_resblock_stream, pl, 2)  # conv1, conv2
    return out, nc1, nc2
