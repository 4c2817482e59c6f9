"""Kernels D and D': decoder tail, LayerNorm + SiLU + causal 3x3x3 conv
C -> RGB.

D replaces ``vidtok_tpu/ops/pallas/decoder_tail.py:245``
(``decoder_tail_rgb``, default body ``_kernel_tap_pack``), CUDA
``csrc/decoder_tail.cu``. D' replaces the same call with ``tap_pack=False``,
body ``_kernel`` (``:160``), CUDA ``csrc/decoder_tail_taps.cu``; it applies
the exact LayerNorm + SiLU (``_ln_silu``, ``:42``) where D applies the
kernels' fast form, and keeps the activated frames in the activation dtype.
For both the conv's spatial SAME padding is zero after LayerNorm+SiLU; the
stream start repeats activated frame 0 (``replicate``) or masks the missing
frames (``zero``). The output has exactly 3 channels.
"""

from __future__ import annotations

import torch

from . import _lib
from .act import ln_silu_exact, ln_silu_fast
from ...modules.conv import conv3d_cl, pad_time_front

COUT = 3
# kernel D' keeps a ring of three (C + 8)-channel halo frames and the
# weights in one block's shared memory
TAPS_MAX_C = 128


def _tail_conv(a, conv, first_pad_mode):
    y = conv3d_cl(pad_time_front(a, 2, first_pad_mode), conv[0],
                  padding=(0, 1, 1))
    return (y.float() + conv[1].float()).to(a.dtype)


def decoder_tail_rgb_plain(x, norm, conv, first_pad_mode: str,
                           eps: float = 1e-6):
    """Plain PyTorch form. x: ``[B, T, H, W, C]``; ``norm`` LayerNorm
    (weight, bias); ``conv`` (OIDHW weight ``[3, C, 3, 3, 3]``, bias)."""
    return _tail_conv(ln_silu_fast(x, norm[0], norm[1], eps), conv,
                      first_pad_mode)


def decoder_tail_rgb_taps_plain(x, norm, conv, first_pad_mode: str,
                                eps: float = 1e-6):
    """Plain PyTorch form of D': as :func:`decoder_tail_rgb_plain` with
    the exact LayerNorm + SiLU."""
    return _tail_conv(ln_silu_exact(x, norm[0], norm[1], eps), conv,
                      first_pad_mode)


def _weights(x, conv, kernel):
    """OIDHW -> ``[kt, kh, kw, C, 3]`` bf16; raises unless C % 16 == 0 and
    the conv is ``[3, C, 3, 3, 3]``."""
    c = x.shape[-1]
    if c % 16 or tuple(conv[0].shape) != (COUT, c, 3, 3, 3):
        raise ValueError(f"kernel {kernel} takes C % 16 == 0 and a [3, C, 3, 3, 3] "
                         f"conv, got C={c}, {tuple(conv[0].shape)}")
    return conv[0].permute(2, 3, 4, 1, 0).to(torch.bfloat16).contiguous()


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
    wt = _weights(x, conv, "D")
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


def decoder_tail_rgb_taps(x, norm, conv, first_pad_mode: str):
    """Kernel D': x ``[B, T, H, W, C]`` -> ``[B, T, H, W, 3]``.

    A CPU tensor runs :func:`decoder_tail_rgb_taps_plain`; a CUDA tensor
    (contiguous bf16, C % 16 == 0, C <= 128) runs the kernel or raises.
    """
    decoder_tail_rgb_taps.calls += 1
    if first_pad_mode not in ("zero", "replicate"):
        raise ValueError(f"unknown first_pad_mode {first_pad_mode!r}")
    if x.device.type == "cpu":
        return decoder_tail_rgb_taps_plain(x, norm, conv, first_pad_mode)
    b, t, h, w, c = x.shape
    _lib.require(x, torch.bfloat16, (b, t, h, w, c))
    wt = _weights(x, conv, "D'")
    if c > TAPS_MAX_C:
        raise ValueError(f"kernel D' takes C <= {TAPS_MAX_C}, got C={c}")
    g, bb, bias = (_lib.f32(v) for v in (norm[0], norm[1], conv[1]))
    for v in (wt, g, bb, bias):
        _lib.same_device(v, x)
    out = x.new_empty((b, t, h, w, COUT))
    _lib.call("vt_decoder_tail_rgb_taps", x, out, g, bb, wt, bias,
              b, t, h, w, c, int(first_pad_mode == "replicate"))
    decoder_tail_rgb_taps.launches += 1
    return out


decoder_tail_rgb_taps.calls = 0
decoder_tail_rgb_taps.launches = 0
