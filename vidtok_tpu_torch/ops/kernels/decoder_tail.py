"""Kernels D and D': decoder tail, LayerNorm + SiLU + causal 3x3x3 conv
C -> RGB.

D replaces ``vidtok_tpu/ops/pallas/decoder_tail.py:245``
(``decoder_tail_rgb``, default body ``_kernel_tap_pack``); D' the same call
with ``tap_pack=False``, body ``_kernel`` (``:160``). D' applies the exact
LayerNorm + SiLU (``_ln_silu``, ``:42``) where D applies the kernels' fast
form. For both the conv's spatial SAME padding is zero after LayerNorm+SiLU;
the stream start repeats activated frame 0 (``replicate``) or masks the
missing frames (``zero``). The output has exactly 3 channels.

Both are one CUDA kernel template (``csrc/decoder_tail.cu``), launched with
``plan.tail_plan``'s plan: a block walks the frames of one output patch,
reads and activates each input frame's halo box once and runs its products
on the tensor cores with the 27 (time tap, dx, out channel) columns packed
onto N, the weights relaid out once per parameter (:func:`tail_operands`).

D takes f32 too: its f32 form (``vt_decoder_tail_rgb_f32``) writes the f32
activation with the row pass, then runs the conv's f32 products on the
CUDA cores, launched with ``plan.tail_plan_f32``'s plan, the weights in
:func:`tail_operands_f32`'s layout. D' takes bf16 only (its f32 form is not
written yet, and it says so).
"""

from __future__ import annotations

import torch

from . import _lib, plan
from .act import ln_silu, ln_silu_exact
from ...modules.conv import conv3d_cl, pad_time_front

COUT = 3


def _tail_conv(a, conv, first_pad_mode):
    y = conv3d_cl(pad_time_front(a, 2, first_pad_mode), conv[0],
                  padding=(0, 1, 1))
    return (y.float() + conv[1].float()).to(a.dtype)


def decoder_tail_rgb_plain(x, norm, conv, first_pad_mode: str,
                           eps: float = 1e-6):
    """Plain PyTorch form. x: ``[B, T, H, W, C]``; ``norm`` LayerNorm
    (weight, bias); ``conv`` (OIDHW weight ``[3, C, 3, 3, 3]``, bias)."""
    return _tail_conv(ln_silu(x, norm[0], norm[1], eps), conv,
                      first_pad_mode)


def decoder_tail_rgb_taps_plain(x, norm, conv, first_pad_mode: str,
                                eps: float = 1e-6):
    """Plain PyTorch form of D': as :func:`decoder_tail_rgb_plain` with
    the exact LayerNorm + SiLU."""
    return _tail_conv(ln_silu_exact(x, norm[0], norm[1], eps), conv,
                      first_pad_mode)


def tail_operands(weight, bias, g, b) -> dict:
    """Kernels D and D''s parameters as they read them: the bf16 weight
    ``[3 dy, TAIL_BN, C]`` whose row ``n = 9j + 3dx + co`` is the OIDHW
    weight's ``[co, :, j, dy, dx]`` (rows 27 on zero), and the conv bias
    and norm scale and bias as f32 vectors."""
    c = weight.shape[1]
    w = weight.float().permute(3, 2, 4, 0, 1).reshape(3, plan.TAIL_COLS, c)
    w = torch.cat([w, w.new_zeros(3, plan.TAIL_BN - plan.TAIL_COLS, c)], dim=1)
    return {"w": w.to(torch.bfloat16).contiguous(), "bias": _lib.f32(bias),
            "g": _lib.f32(g), "b": _lib.f32(b)}


def tail_operands_f32(weight, bias, g, b) -> dict:
    """D's f32 operands: the f32 weight ``[3 j][3 dy][C][12]`` whose column
    ``3 dx + co`` is the OIDHW weight's ``[co, :, j, dy, dx]`` (columns 9-11
    zero), and the f32 vectors of :func:`tail_operands`."""
    c = weight.shape[1]
    w = weight.float().permute(2, 3, 1, 4, 0).reshape(3, 3, c, 9)
    w = torch.cat([w, w.new_zeros(3, 3, c, plan.TAIL_F32_WLD - 9)], dim=-1)
    return {"w": w.contiguous(), "bias": _lib.f32(bias), "g": _lib.f32(g), "b": _lib.f32(b)}


def _launch_f32(x, norm, conv, first_pad_mode: str):
    """D's f32 form on a CUDA ``x``, or raise."""
    b, t, h, w, c = x.shape
    pl = plan.tail_plan_f32(b, t, h, w, c)
    _lib.require(x, torch.float32, (b, t, h, w, c))
    if tuple(conv[0].shape) != (COUT, c, 3, 3, 3):
        raise ValueError(f"kernel D takes a [3, C, 3, 3, 3] conv, got C={c}, "
                         f"{tuple(conv[0].shape)}")
    op = _lib.operands("decoder_tail_f32", (conv[0], conv[1], norm[0], norm[1]),
                       tail_operands_f32)
    for v in op.values():
        _lib.same_device(v, x)
    act = torch.empty_like(x)  # the f32 activation
    out = x.new_empty((b, t, h, w, COUT))
    _lib.call("vt_decoder_tail_rgb_f32", x, act, out, op["g"], op["b"], op["w"], op["bias"],
              b, t, h, w, c, int(first_pad_mode == "replicate"), pl.th, pl.tw, pl.smem,
              pl.grid)
    return out


def _launch(entry: str, kernel: str, x, norm, conv, first_pad_mode: str):
    """Launch ``entry`` on a CUDA ``x``, or raise on what the plan and the
    kernel do not take."""
    b, t, h, w, c = x.shape
    pl = plan.tail_plan(b, t, h, w, c)
    _lib.require(x, torch.bfloat16, (b, t, h, w, c))
    if tuple(conv[0].shape) != (COUT, c, 3, 3, 3):
        raise ValueError(f"kernel {kernel} takes a [3, C, 3, 3, 3] conv, got C={c}, "
                         f"{tuple(conv[0].shape)}")
    op = _lib.operands("decoder_tail", (conv[0], conv[1], norm[0], norm[1]),
                       tail_operands)
    for v in op.values():
        _lib.same_device(v, x)
    out = x.new_empty((b, t, h, w, COUT))
    _lib.call(entry, x, out, op["g"], op["b"], op["w"], op["bias"], b, t, h, w, c,
              int(first_pad_mode == "replicate"), pl.th, pl.tw, pl.run, pl.stages,
              pl.smem, pl.grid)
    return out


def decoder_tail_rgb(x, norm, conv, first_pad_mode: str):
    """x: ``[B, T, H, W, C]`` -> ``[B, T, H, W, 3]``.

    A CPU tensor runs :func:`decoder_tail_rgb_plain`; a CUDA tensor
    (contiguous bf16 or f32, C that ``plan.tail_plan`` takes: 64 or 128)
    runs the kernel (f32: its f32 form) or raises.
    """
    decoder_tail_rgb.calls += 1
    if first_pad_mode not in ("zero", "replicate"):
        raise ValueError(f"unknown first_pad_mode {first_pad_mode!r}")
    if x.device.type == "cpu":
        return decoder_tail_rgb_plain(x, norm, conv, first_pad_mode)
    if _lib.kernel_dtype(x, "D") == torch.float32:
        out = _launch_f32(x, norm, conv, first_pad_mode)
    else:
        out = _launch("vt_decoder_tail_rgb", "D", x, norm, conv, first_pad_mode)
    decoder_tail_rgb.launches += 1
    return out


decoder_tail_rgb.calls = 0
decoder_tail_rgb.launches = 0


def decoder_tail_rgb_taps(x, norm, conv, first_pad_mode: str):
    """Kernel D': x ``[B, T, H, W, C]`` -> ``[B, T, H, W, 3]``.

    A CPU tensor runs :func:`decoder_tail_rgb_taps_plain`; a CUDA tensor
    (contiguous bf16, C that ``plan.tail_plan`` takes: 64 or 128) runs the
    kernel or raises (f32: D' has no f32 form yet).
    """
    decoder_tail_rgb_taps.calls += 1
    if first_pad_mode not in ("zero", "replicate"):
        raise ValueError(f"unknown first_pad_mode {first_pad_mode!r}")
    if x.device.type == "cpu":
        return decoder_tail_rgb_taps_plain(x, norm, conv, first_pad_mode)
    _lib.refuse_f32(x, "D'")
    out = _launch("vt_decoder_tail_rgb_taps", "D'", x, norm, conv, first_pad_mode)
    decoder_tail_rgb_taps.launches += 1
    return out


decoder_tail_rgb_taps.calls = 0
decoder_tail_rgb_taps.launches = 0
