"""Kernels G and H: the parity-upsample tail from the parity conv outputs.

Replace ``vidtok_tpu/ops/pallas/upsample_epilogue.py:49``
(``parity_blend_interleave``, G) and ``:96`` (``parity_blend_interleave4``,
H), the tail of ``TimeUpsampleRes2x``'s parity form where kernel E does not
run (``vidtok_tpu/modules/blocks.py:633-668``). Their shared body
``_kernel`` (``:34``), with ``y_cur`` and ``y_prev`` phase-packed
``[..., 2C]`` (even | odd output frame)::

    y = y_cur[t] + y_prev[t-1] + [bias | bias]          (f32)
    out[2t+p] = alpha * s[t] + (1 - alpha) * y[p*C:(p+1)*C]

rounded once to ``s.dtype`` (f32: not rounded). ``y_prev[-1]`` is zeros (``zero``) or
``y_prev[0]`` (``replicate``: the TPU index map clamps t-1 to 0). G takes
the two C->2C convs' outputs, H the one C->4C conv's ``[cur | prev]``.
CUDA: ``csrc/parity_blend.cu``, one kernel for both, given a pointer and a
row stride for each source, a template of the element type (bf16, f32).
"""

from __future__ import annotations

import torch

from . import _lib


def _check_mode(first_pad_mode: str) -> None:
    if first_pad_mode not in ("zero", "replicate"):
        raise ValueError(f"unknown first_pad_mode {first_pad_mode!r}")


def parity_blend_interleave_plain(s, y_cur, y_prev, bias, alpha,
                                  first_pad_mode: str):
    """Plain PyTorch form. s: ``[B, T, H, W, C]``; y_cur, y_prev:
    ``[B, T, H, W, 2C]``; bias ``[C]``; alpha a scalar tensor."""
    b, t, h, w, c = s.shape
    yp = y_prev.float()
    front = yp[:, :1] if first_pad_mode == "replicate" else torch.zeros_like(yp[:, :1])
    y = y_cur.float() + torch.cat([front, yp[:, :-1]], dim=1)
    y = (y + torch.cat([bias, bias]).float()).reshape(b, t, h, w, 2, c)
    a = alpha.float()
    out = (a * s.float()[:, :, :, :, None] + (1 - a) * y).to(s.dtype)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(b, 2 * t, h, w, c)


def parity_blend_interleave4_plain(s, y4, bias, alpha, first_pad_mode: str):
    """Plain PyTorch form of H. y4: ``[B, T, H, W, 4C]``, ``[cur | prev]``."""
    c2 = 2 * s.shape[-1]
    return parity_blend_interleave_plain(s, y4[..., :c2], y4[..., c2:], bias,
                                         alpha, first_pad_mode)


def _launch(s, y_cur, y_prev, ld, bias, alpha, first_pad_mode):
    b, t, h, w, c = s.shape
    if c % 8:
        raise ValueError(f"kernels G and H take C % 8 == 0, got C={c}")
    bias, alpha = _lib.f32(bias), _lib.f32(alpha.reshape(1))
    for v in (bias, alpha):
        _lib.same_device(v, s)
    out = s.new_empty((b, 2 * t, h, w, c))
    _lib.call("vt_parity_blend" + ("_f32" if s.dtype == torch.float32 else ""), s, y_cur,
              y_prev, bias, alpha, out, ld, b, t, h * w, c,
              int(first_pad_mode == "replicate"))
    return out


@_lib.wrapper
def parity_blend_interleave(s, y_cur, y_prev, bias, alpha, first_pad_mode: str):
    """Kernel G: s ``[B, T, H, W, C]`` and the two convs' ``[B, T, H, W, 2C]``
    -> ``[B, 2T, H, W, C]``. A CPU tensor runs
    :func:`parity_blend_interleave_plain`; a CUDA tensor (contiguous bf16
    or f32, C % 8 == 0) runs the kernel or raises."""
    _check_mode(first_pad_mode)
    if s.device.type == "cpu":
        return parity_blend_interleave_plain(s, y_cur, y_prev, bias, alpha,
                                             first_pad_mode)
    b, t, h, w, c = s.shape
    dt = _lib.kernel_dtype(s, "G")
    _lib.require(s, dt, (b, t, h, w, c))
    for y in (y_cur, y_prev):
        _lib.require(y, dt, (b, t, h, w, 2 * c))
    out = _launch(s, y_cur, y_prev, 2 * c, bias, alpha, first_pad_mode)
    parity_blend_interleave.launches += 1
    return out


@_lib.wrapper
def parity_blend_interleave4(s, y4, bias, alpha, first_pad_mode: str):
    """Kernel H: s ``[B, T, H, W, C]`` and the one conv's
    ``[B, T, H, W, 4C]`` -> ``[B, 2T, H, W, C]``; the kernel reads the cur
    half at frame t and the prev half at frame t-1. CPU and CUDA as
    :func:`parity_blend_interleave`."""
    _check_mode(first_pad_mode)
    if s.device.type == "cpu":
        return parity_blend_interleave4_plain(s, y4, bias, alpha, first_pad_mode)
    b, t, h, w, c = s.shape
    dt = _lib.kernel_dtype(s, "H")
    _lib.require(s, dt, (b, t, h, w, c))
    _lib.require(y4, dt, (b, t, h, w, 4 * c))
    out = _launch(s, y4, y4[..., 2 * c:], 4 * c, bias, alpha, first_pad_mode)
    parity_blend_interleave4.launches += 1
    return out
