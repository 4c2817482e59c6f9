"""Kernel A: fused per-frame spatial residual block (layernorm).

Replaces ``vidtok_tpu/ops/pallas/fused_spatial_v2.py:183``
(``fused_spatial_resblock_v2``)::

    out = shortcut(x) + conv2(ln_silu2(conv1(ln_silu1(x))))

two 3x3 SAME convs with f32 accumulation and an optional 1x1
``nin_shortcut``. CUDA: ``csrc/fused_spatial.cu``. The SAME padding of both
convs is zero AFTER LayerNorm+SiLU (``ln_silu(0) = silu(bias) != 0``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _lib
from .act import ln_silu_fast


def _conv3x3_same(h, weight):
    """[N,H,W,Ci] x OIHW -> [N,H,W,Co], f32 accumulate, h.dtype out."""
    y = F.conv2d(h.permute(0, 3, 1, 2), weight.to(h.dtype), None, 1, 1)
    return y.permute(0, 2, 3, 1)


def fused_spatial_resblock_plain(x, norm1, conv1, norm2, conv2, nin=None,
                                 eps: float = 1e-6):
    """Plain PyTorch form. x: ``[N, H, W, Cin]``; ``norm*`` are LayerNorm
    (weight, bias); ``conv*`` and ``nin`` are (OIHW weight, bias)."""
    dt = x.dtype
    h = ln_silu_fast(x, norm1[0], norm1[1], eps)
    c1 = (_conv3x3_same(h, conv1[0]).float() + conv1[1].float()).to(dt)
    h = ln_silu_fast(c1, norm2[0], norm2[1], eps)
    y = _conv3x3_same(h, conv2[0]).float() + conv2[1].float()
    if nin is None:
        return (x.float() + y).to(dt)
    sc = F.linear(x, nin[0][:, :, 0, 0].to(dt)).float() + nin[1].float()
    return (sc + y).to(dt)


def fused_spatial_resblock(x, norm1, conv1, norm2, conv2, nin=None):
    """x: ``[N, H, W, Cin]`` -> ``[N, H, W, C]``.

    A CPU tensor runs :func:`fused_spatial_resblock_plain`. A CUDA tensor
    must be contiguous bf16 with Cin % 32 == 0 and C % 128 == 0; it runs
    the kernel or raises.
    """
    fused_spatial_resblock.calls += 1
    if x.device.type == "cpu":
        return fused_spatial_resblock_plain(x, norm1, conv1, norm2, conv2, nin)
    n, h, w, cin = x.shape
    c = conv1[0].shape[0]
    _lib.require(x, torch.bfloat16, (n, h, w, cin))
    if cin % 32 or c % 128:
        raise ValueError(f"kernel A takes Cin % 32 == 0 and C % 128 == 0, "
                         f"got Cin={cin}, C={c}")
    if (tuple(conv1[0].shape) != (c, cin, 3, 3)
            or tuple(conv2[0].shape) != (c, c, 3, 3)):
        raise ValueError("kernel A takes two 3x3 convs Cin->C->C")
    if (nin is None) != (cin == c):
        raise ValueError("nin_shortcut is needed exactly when Cin != C")
    bf = torch.bfloat16
    # weights as GEMM operands [K, C], K = (dy, dx, ci); the 1x1 shortcut
    # rides as 10th tap of conv2 on the raw x, its bias folded into conv2's
    w1 = conv1[0].permute(2, 3, 1, 0).reshape(9 * cin, c).to(bf).contiguous()
    w2 = conv2[0].permute(2, 3, 1, 0).reshape(9 * c, c)
    bias2 = conv2[1].float()
    if nin is not None:
        w2 = torch.cat([w2, nin[0][:, :, 0, 0].t()])
        bias2 = bias2 + nin[1].float()
    w2 = w2.to(bf).contiguous()
    g1, b1, g2, b2, bias1 = (_lib.f32(t) for t in
                             (norm1[0], norm1[1], norm2[0], norm2[1], conv1[1]))
    bias2 = bias2.contiguous()
    for t in (w1, w2, g1, b1, g2, b2, bias1, bias2):
        _lib.same_device(t, x)
    h1 = x.new_empty((n, h, w, c))
    out = torch.empty_like(h1)
    act = x.new_empty((n * h * w, max(cin, c)))  # activation scratch
    _lib.call("vt_fused_spatial_resblock", x, out, h1, act, g1, b1, w1,
              bias1, g2, b2, w2, bias2, n, h, w, cin, c, int(nin is not None))
    fused_spatial_resblock.launches += 1
    return out


fused_spatial_resblock.calls = 0
fused_spatial_resblock.launches = 0
