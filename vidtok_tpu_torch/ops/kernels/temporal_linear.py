"""Kernels J and K: the v1.1 trilinear temporal upsample around its conv.

``TimeUpsampleRes2x`` in trilinear mode (``modules/blocks.py``) computes
``alpha * up + (1 - alpha) * conv(up)``, ``up`` the linear 2x interpolation
of x along T (``modules/interp.temporal_linear_up2x``), its first ntu
frames apart from the rest, and the conv causal with a 2-frame front. With
``fused`` the chain runs as two memory-bound passes with cuDNN's conv
between them:

* J, :func:`temporal_linear_up2x`: x ``[B, T, H, W, C]`` -> ``full =
  [front (2) | up (2T)]``, the conv's input with its front in place;
* K, :func:`linear_blend`: the conv's output y (its bias left out)
  becomes ``alpha * full[:, 2:] + (1 - alpha) * (y + bias)``, in place.

They replace no TPU kernel (XLA fuses the JAX module's chain). CUDA:
``csrc/temporal_linear.cu``. J is bit-equal to its plain form in bf16 and
f32; K in f32, and rounds once where the plain form rounds four times in
bf16. Both take any C; 16-byte vectors where C and the pointers allow.
"""

from __future__ import annotations

import torch

from ...modules import interp
from . import _lib

FRONTS = ("zero", "replicate")  # J's front modes besides a cached tensor
_FRONT_CODE = {"zero": 0, "replicate": 1}  # csrc/temporal_linear.cu TemporalFront
_FRONT_CACHED = 2


def temporal_linear_up2x_plain(x, split: int, prev=None, front="replicate"):
    """Plain PyTorch form of J: the interpolation of segments ``x[:,
    :split]`` and ``x[:, split:]`` apart (``interp.temporal_linear_up2x``
    of each, concatenated), frame 0's predecessor the last frame of
    ``prev`` ``[B, n, H, W, C]`` when given, then the conv's front
    prepended: ``front`` a cached ``[B, 2, H, W, C]`` tensor, ``zero`` or
    ``replicate`` (up-frame 0 twice). -> ``[B, 2 + 2T, H, W, C]``."""
    t = x.shape[1]
    split = min(max(split, 0), t)
    ups = []
    for s, e in ((0, split), (split, t)):
        seg = x[:, s:e]
        if seg.shape[1] == 0:
            continue
        if s == 0 and prev is not None:
            ups.append(interp.temporal_linear_up2x(
                torch.cat([prev[:, -1:].to(x.dtype), seg], dim=1))[:, 2:])
        else:
            ups.append(interp.temporal_linear_up2x(seg))
    up = torch.cat(ups, dim=1)
    if isinstance(front, torch.Tensor):
        head = front.to(x.dtype)
    elif front == "replicate":
        head = up[:, :1].expand(-1, 2, *up.shape[2:])
    else:
        head = up.new_zeros((up.shape[0], 2) + tuple(up.shape[2:]))
    return torch.cat([head, up], dim=1)


def linear_blend_plain(full, y, bias, alpha):
    """Plain PyTorch form of K: ``alpha * up + (1 - alpha) * (y + bias)``
    in y's dtype, ``up`` the last ``y.shape[1]`` frames of ``full``;
    ``alpha`` a one-element tensor, ``bias`` ``[C]``."""
    a = alpha.to(y.dtype)
    up = full[:, full.shape[1] - y.shape[1]:]
    return a * up + (1 - a) * (y + bias.to(y.dtype))


def _vectors(c: int, dt, *tensors) -> int:
    """1 when 16-byte vectors cover C and every pointer is 16-byte aligned."""
    per = 16 // (2 if dt == torch.bfloat16 else 4)
    return int(c % per == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _check_front(front) -> None:
    if not isinstance(front, torch.Tensor) and front not in FRONTS:
        raise ValueError(f"unknown front {front!r}; a tensor or one of {FRONTS}")


@_lib.wrapper
def temporal_linear_up2x(x, split: int, prev=None, front="replicate"):
    """Kernel J: x ``[B, T, H, W, C]`` -> ``[B, 2 + 2T, H, W, C]``, as
    :func:`temporal_linear_up2x_plain`. A CPU tensor runs the plain form;
    a CUDA tensor (contiguous bf16 or f32; ``prev`` and a cached ``front``
    contiguous, of x's dtype) runs the kernel or raises."""
    _check_front(front)
    if x.device.type == "cpu":
        return temporal_linear_up2x_plain(x, split, prev, front)
    b, t, h, w, c = x.shape
    dt = _lib.kernel_dtype(x, "J")
    _lib.require(x, dt, (b, t, h, w, c))
    if t == 0:
        raise ValueError("kernel J needs at least one frame")
    if prev is not None:
        _lib.require(prev, dt, (b, prev.shape[1], h, w, c))
        if prev.shape[1] == 0:
            raise ValueError("kernel J's prev holds no frame")
    cached = isinstance(front, torch.Tensor)
    if cached:
        _lib.require(front, dt, (b, 2, h, w, c))
    out = x.new_empty((b, 2 + 2 * t, h, w, c))
    given = [v for v in (prev, front if cached else None) if v is not None]
    _lib.call("vt_temporal_linear_up2x" + ("_f32" if dt == torch.float32 else ""), x,
              prev, 0 if prev is None else prev.shape[1], front if cached else None, out,
              b, t, h * w, c, min(max(split, 0), t),
              _FRONT_CACHED if cached else _FRONT_CODE[front],
              _vectors(c, dt, x, out, *given))
    temporal_linear_up2x.launches += 1
    return out


@_lib.wrapper
def linear_blend(full, y, bias, alpha):
    """Kernel K: y ``[B, Ty, H, W, C]`` -> ``alpha * full[:, 2:] + (1 -
    alpha) * (y + bias)``, ``full`` J's ``[B, 2 + Ty, H, W, C]``. A CPU
    tensor runs :func:`linear_blend_plain`; a CUDA tensor (contiguous bf16
    or f32) runs the kernel, which writes y in place and returns it, or
    raises. ``alpha``: a one-element tensor on the device, read there (f32,
    as the caller casts it)."""
    if y.device.type == "cpu":
        return linear_blend_plain(full, y, bias, alpha)
    b, ty, h, w, c = y.shape
    dt = _lib.kernel_dtype(y, "K")
    _lib.require(y, dt, (b, ty, h, w, c))
    _lib.require(full, dt, (b, ty + 2, h, w, c))
    bias, alpha = _lib.f32(bias), _lib.f32(alpha.reshape(1))
    for v in (bias, alpha):
        _lib.same_device(v, y)
    _lib.call("vt_linear_blend" + ("_f32" if dt == torch.float32 else ""), full, y, bias,
              alpha, b, ty, h * w, c, _vectors(c, dt, full, y))
    linear_blend.launches += 1
    return y
