"""LayerNorm + SiLU as the kernels compute it (``vidtok_tpu/ops/pallas/act.py``
``ln_silu_fast``, the JAX kernels' default epilogue).

The CUDA form is the ``ln_silu`` device function and the ``ln_stats``
kernel of ``csrc/common.cuh``. This is its plain PyTorch form, used by the
plain version beside each kernel.
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
