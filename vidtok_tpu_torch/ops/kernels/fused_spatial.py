"""Kernel A: fused per-frame spatial residual block (layernorm).

Replaces ``vidtok_tpu/ops/pallas/fused_spatial_v2.py:183``
(``fused_spatial_resblock_v2``)::

    out = shortcut(x) + conv2(ln_silu2(conv1(ln_silu1(x))))

two 3x3 SAME convs with f32 accumulation and an optional 1x1
``nin_shortcut``. CUDA: ``csrc/fused_spatial.cu`` on the TMA + wgmma loop
of ``csrc/wgmma_conv.cuh``, launched with ``plan.conv_plan_spatial``'s
plan. The SAME padding of both convs is zero AFTER LayerNorm+SiLU
(``ln_silu(0) = silu(bias) != 0``). It takes bf16 or f32 activations; f32
runs the loop's f32 scheme (``split.py``) on the weights' pieces
(:func:`spatial_operands` with ``split``). Cin and C are any multiples of
8 up to 1024 (``plan.check_channels``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _lib, plan
from .act import ln_silu
from .split import PIECES, kmajor_pieces


def _conv3x3_same(h, weight):
    """[N,H,W,Ci] x OIHW -> [N,H,W,Co], f32 accumulate, h.dtype out."""
    y = F.conv2d(h.permute(0, 3, 1, 2), weight.to(h.dtype), None, 1, 1)
    return y.permute(0, 2, 3, 1)


def fused_spatial_resblock_plain(x, norm1, conv1, norm2, conv2, nin=None,
                                 eps: float = 1e-6):
    """Plain PyTorch form. x: ``[N, H, W, Cin]``; ``norm*`` are LayerNorm
    (weight, bias); ``conv*`` and ``nin`` are (OIHW weight, bias)."""
    dt = x.dtype
    h = ln_silu(x, norm1[0], norm1[1], eps)
    c1 = (_conv3x3_same(h, conv1[0]).float() + conv1[1].float()).to(dt)
    h = ln_silu(c1, norm2[0], norm2[1], eps)
    y = _conv3x3_same(h, conv2[0]).float() + conv2[1].float()
    if nin is None:
        return (x.float() + y).to(dt)
    sc = F.linear(x, nin[0][:, :, 0, 0].to(dt)).float() + nin[1].float()
    return (sc + y).to(dt)


def spatial_operands(w1, g1, b1, bias1, g2, b2, w2, bias2, w_nin=None, b_nin=None,
                     split: bool = False):
    """Kernel A's parameters as it reads them (conv1's weight, norm1, conv1's
    bias, norm2, conv2, the nin_shortcut or None): the convs as K-major bf16
    GEMM operands ``[C, K]``, K = (dy, dx, ci), the 1x1 shortcut's Cin
    columns after conv2's (its bias folded into conv2's), and the f32
    vectors; ``layouts`` how the loop reads each weight
    (``_lib.weight_layout``), ``maps`` the weights' tensor maps by BN.
    ``split``: the f32 scheme's operands, each K-major f32 matrix as its
    bf16 pieces ``[C, 3K]``."""
    c, cin = w1.shape[:2]
    k1 = w1.float().permute(0, 2, 3, 1).reshape(w1.shape[0], -1)
    k2 = w2.float().permute(0, 2, 3, 1).reshape(w2.shape[0], -1)
    bias2 = bias2.float()
    if w_nin is not None:
        k2 = torch.cat([k2, w_nin.float()[:, :, 0, 0]], dim=1)
        bias2 = bias2 + b_nin.float()
    pack = kmajor_pieces if split else (lambda k: k.to(torch.bfloat16).contiguous())
    pieces = PIECES if split else 1
    cs = cin if w_nin is not None else 0
    return {"w1": pack(k1), "w2": pack(k2),
            "g1": _lib.f32(g1), "b1": _lib.f32(b1), "bias1": _lib.f32(bias1),
            "g2": _lib.f32(g2), "b2": _lib.f32(b2), "bias2": _lib.f32(bias2),
            "layouts": {"w1": _lib.weight_layout(cin, 9, 0, pieces, c),
                        "w2": _lib.weight_layout(c, 9, cs, pieces, c)},
            "maps": {}}


@_lib.wrapper
def fused_spatial_resblock(x, norm1, conv1, norm2, conv2, nin=None):
    """x: ``[N, H, W, Cin]`` -> ``[N, H, W, C]``.

    A CPU tensor runs :func:`fused_spatial_resblock_plain`. Otherwise x
    must be a contiguous bf16 or f32 CUDA tensor whose channels the plan
    takes (``plan.conv_plan_spatial``: Cin and C % 8 == 0, 8 to 1024); it
    runs the kernel (f32: its f32 scheme) or raises.
    """
    if x.device.type == "cpu":
        return fused_spatial_resblock_plain(x, norm1, conv1, norm2, conv2, nin)
    n, h, w, cin = x.shape
    c = conv1[0].shape[0]
    f32 = _lib.kernel_dtype(x, "A") == torch.float32
    pl = plan.conv_plan_spatial(n, h, w, cin, c, cin if nin is not None else 0, f32)
    _lib.require(x, x.dtype, (n, h, w, cin))
    if (tuple(conv1[0].shape) != (c, cin, 3, 3)
            or tuple(conv2[0].shape) != (c, c, 3, 3)):
        raise ValueError("kernel A takes two 3x3 convs Cin->C->C")
    if (nin is None) != (cin == c):
        raise ValueError("nin_shortcut is needed exactly when Cin != C")
    op = _lib.operands("fused_spatial_resblock_f32" if f32 else "fused_spatial_resblock",
                       (conv1[0], *norm1, conv1[1], *norm2, *conv2,
                        *(nin if nin is not None else (None, None))),
                       functools.partial(spatial_operands, split=f32))
    for v in (op["w1"], op["w2"], op["g1"], op["bias2"]):
        _lib.same_device(v, x)
    map1, map2 = _lib.weight_maps(op, pl.bn, "w1", "w2")
    h1 = x.new_empty((n, h, w, c))
    out = torch.empty_like(h1)
    tail = (n, h, w, cin, c, int(nin is not None), pl.th, pl.tw, pl.bn, pl.stages, pl.smem,
            pl.grid)
    if f32:
        # the activations' bf16 pieces, and raw x's for the 1x1 shortcut,
        # a plane a piece
        act = x.new_empty((PIECES, n * h * w, max(cin, c)), dtype=torch.bfloat16)
        xs = (x.new_empty((PIECES, n * h * w, cin), dtype=torch.bfloat16)
              if nin is not None else None)
        _lib.call("vt_fused_spatial_resblock_f32", x, out, h1, act, xs, op["g1"], op["b1"],
                  map1, op["bias1"], op["g2"], op["b2"], map2, op["bias2"], *tail)
    else:
        act = x.new_empty((n * h * w, max(cin, c)))  # activation scratch
        _lib.call("vt_fused_spatial_resblock", x, out, h1, act, op["g1"], op["b1"], map1,
                  op["bias1"], op["g2"], op["b2"], map2, op["bias2"], *tail)
    fused_spatial_resblock.launches += 1
    _lib.count_conv(fused_spatial_resblock, pl, 2)  # conv1, conv2
    return out
