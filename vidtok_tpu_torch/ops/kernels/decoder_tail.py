"""Kernel D: decoder tail, LayerNorm + SiLU + causal 3x3x3 conv C -> RGB.

Replaces ``vidtok_tpu/ops/pallas/decoder_tail.py:245`` (``decoder_tail_rgb``,
default body ``_kernel_tap_pack``). CUDA: ``csrc/decoder_tail.cu``. The
conv's spatial SAME padding is zero after LayerNorm+SiLU; the stream start
repeats activated frame 0 (``replicate``) or masks the missing frames
(``zero``). The output has exactly 3 channels.
"""

from __future__ import annotations

import torch

from . import _lib
from .act import ln_silu_fast
from ...modules.conv import conv3d_cl, pad_time_front

COUT = 3


def decoder_tail_rgb_plain(x, norm, conv, first_pad_mode: str,
                           eps: float = 1e-6):
    """Plain PyTorch form. x: ``[B, T, H, W, C]``; ``norm`` LayerNorm
    (weight, bias); ``conv`` (OIDHW weight ``[3, C, 3, 3, 3]``, bias)."""
    a = ln_silu_fast(x, norm[0], norm[1], eps)
    y = conv3d_cl(pad_time_front(a, 2, first_pad_mode), conv[0],
                  padding=(0, 1, 1))
    return (y.float() + conv[1].float()).to(x.dtype)


def decoder_tail_rgb(x, norm, conv, first_pad_mode: str):
    """x: ``[B, T, H, W, C]`` -> ``[B, T, H, W, 3]``.

    A CPU tensor runs :func:`decoder_tail_rgb_plain`; a CUDA tensor
    (contiguous bf16, C % 16 == 0) runs the kernel or raises.
    """
    decoder_tail_rgb.calls += 1
    if first_pad_mode not in ("zero", "replicate"):
        raise ValueError(f"unknown first_pad_mode {first_pad_mode!r}")
    if x.device.type == "cpu":
        return decoder_tail_rgb_plain(x, norm, conv, first_pad_mode)
    b, t, h, w, c = x.shape
    _lib.require(x, torch.bfloat16, (b, t, h, w, c))
    if c % 16 or tuple(conv[0].shape) != (COUT, c, 3, 3, 3):
        raise ValueError(f"kernel D takes C % 16 == 0 and a [3, C, 3, 3, 3] "
                         f"conv, got C={c}, {tuple(conv[0].shape)}")
    # OIDHW -> [kt, kh, kw, C, 3] in the compute dtype
    wt = conv[0].permute(2, 3, 4, 1, 0).to(torch.bfloat16).contiguous()
    g, bb, bias = (_lib.f32(v) for v in (norm[0], norm[1], conv[1]))
    for v in (wt, g, bb, bias):
        _lib.same_device(v, x)
    out = x.new_empty((b, t, h, w, COUT))
    stats = torch.empty((b * t * h * w, 2), device=x.device,
                        dtype=torch.float32)
    _lib.call("vt_decoder_tail_rgb", x, out, stats, g, bb, wt, bias,
              b, t, h, w, c, int(first_pad_mode == "replicate"))
    decoder_tail_rgb.launches += 1
    return out


decoder_tail_rgb.calls = 0
decoder_tail_rgb.launches = 0
