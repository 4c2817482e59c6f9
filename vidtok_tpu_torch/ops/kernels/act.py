"""LayerNorm + SiLU as the kernels compute it.

``ln_silu_fast`` is ``vidtok_tpu/ops/pallas/act.py``'s, the JAX kernels'
default epilogue; its CUDA form is the ``ln_silu`` device function of
``csrc/common.cuh``. ``ln_silu_f32`` is what the kernels compute on f32
activations (``act_rows_kernel``'s f32 row forms); ``ln_silu`` picks one of
the two by x's dtype. ``ln_silu_exact`` is the decoder tail's ``_ln_silu``
(``vidtok_tpu/ops/pallas/decoder_tail.py:42``), which kernel D' computes
(``csrc/decoder_tail.cu``).
``ln_silu_exact_f32`` is ``vidtok_tpu/ops/pallas/fused_temporal.py:32``'s
``_ln_silu``, the exact form the temporal microbenchmark's kernels compute
(``ln_silu_exact_f32`` and ``row_stats_exact`` of ``csrc/common.cuh``). These
are the plain PyTorch forms, used by the plain version beside each kernel.
"""

from __future__ import annotations

import torch


def ln_silu_fast(x, g, b, eps: float = 1e-6):
    """x: ``[..., C]`` in its compute dtype; g, b: ``[C]``.

    Mean and E[x^2] in f32, ``var = max(E[x^2] - mean^2, 0)``; normalize,
    affine and SiLU with sigmoid through ``0.5*tanh(0.5y)+0.5``, rounded
    once to x.dtype, the value a conv then consumes. (The JAX form runs the
    pointwise steps in the tile dtype, a TPU vector-unit saving; the CUDA
    kernels run them in f32 registers.)
    """
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    rs = torch.rsqrt(var.clamp_min(0.0) + eps)
    y = (xf - mu) * rs * g.float() + b.float()
    return (y * (torch.tanh(0.5 * y) * 0.5 + 0.5)).to(x.dtype)


def ln_silu_f32(x, g, b, eps: float = 1e-6):
    """x: ``[..., C]`` f32; g, b: ``[C]``. The mean, then the mean of
    ``(x - mean)^2`` (no ``E[x^2] - mean^2`` cancellation where a row's mean
    is large beside its spread), ``rsqrt``, the affine and SiLU with sigmoid
    through ``0.5*tanh(0.5y)+0.5``, all in f32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()
    return (y * (torch.tanh(0.5 * y) * 0.5 + 0.5)).to(x.dtype)


def ln_silu(x, g, b, eps: float = 1e-6):
    """The kernels' LayerNorm + SiLU for x's dtype: :func:`ln_silu_f32` for
    f32, :func:`ln_silu_fast` otherwise."""
    return (ln_silu_f32 if x.dtype == torch.float32 else ln_silu_fast)(x, g, b, eps)


def ln_silu_exact(x, g, b, eps: float = 1e-6):
    """x: ``[..., C]``; g, b: ``[C]``. The mean, then the mean of
    ``(x - mean)^2``, in f32; the affine result is rounded to x.dtype, then
    ``y * sigmoid(y)`` rounded to x.dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) / torch.sqrt(var + eps) * g.float() + b.float()
    y = y.to(x.dtype).float()
    return (y * torch.sigmoid(y)).to(x.dtype)


def ln_silu_exact_f32(x, g, b, eps: float = 1e-6):
    """x: ``[..., C]``; g, b: ``[C]``. The mean, then the mean of
    ``(x - mean)^2``, ``rsqrt``, the affine and ``y * sigmoid(y)``, all in
    f32, rounded once to x.dtype (an f32 x is not rounded)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()
    return (y * torch.sigmoid(y)).to(x.dtype)
