"""Kernel C: subpixel-upsample bias + interleave.

Replaces ``vidtok_tpu/ops/pallas/subpixel_epilogue.py:100``
(``subpixel_interleave``)::

    out[n, 2a+pr, 2b+pc, :] = y_{pr,pc}[n, a, b, :] + bias

with the bias added in the tile dtype. CUDA: ``csrc/subpixel.cu``. The four
2x2 parity convs that make ``y_pq`` run outside it, as in JAX.
"""

from __future__ import annotations

import torch

from . import _lib


def subpixel_interleave_plain(y00, y01, y10, y11, bias):
    """Plain PyTorch form. y_pq: ``[N, H, W, C]`` -> ``[N, 2H, 2W, C]``."""
    n, h, w, c = y00.shape
    rows = torch.stack([torch.stack([y00, y01], dim=3),
                        torch.stack([y10, y11], dim=3)], dim=2)
    # rows: [N, H, 2(pr), W, 2(pc), C]
    return rows.reshape(n, 2 * h, 2 * w, c) + bias.to(y00.dtype)


def subpixel_interleave(y00, y01, y10, y11, bias):
    """A CPU tensor runs :func:`subpixel_interleave_plain`; a CUDA tensor
    (contiguous bf16, C % 8 == 0) runs the kernel or raises."""
    subpixel_interleave.calls += 1
    if y00.device.type == "cpu":
        return subpixel_interleave_plain(y00, y01, y10, y11, bias)
    n, h, w, c = y00.shape
    for y in (y00, y01, y10, y11):
        _lib.require(y, torch.bfloat16, (n, h, w, c))
    if c % 8:
        raise ValueError(f"kernel C takes C % 8 == 0, got C={c}")
    bias = _lib.f32(bias)
    _lib.same_device(bias, y00)
    out = y00.new_empty((n, 2 * h, 2 * w, c))
    _lib.call("vt_subpixel_interleave", y00, y01, y10, y11, bias, out,
              n, h, w, c)
    subpixel_interleave.launches += 1
    return out


subpixel_interleave.calls = 0
subpixel_interleave.launches = 0
