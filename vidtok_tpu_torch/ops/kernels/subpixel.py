"""Kernels C and I: subpixel-upsample bias + interleave.

C replaces ``vidtok_tpu/ops/pallas/subpixel_epilogue.py:100``
(``subpixel_interleave``)::

    out[n, 2a+pr, 2b+pc, :] = y_{pr,pc}[n, a, b, :] + bias

with the bias added in the tile dtype. I replaces ``:57``
(``subpixel_interleave_z``), the merged form: one VALID 2x2 conv of the
once-padded input gives ``z [N, H+1, W+1, 4C]`` with the output-channel
groups ``e00 | e01 | e10 | e11``, and::

    out[n, 2a+pr, 2b+pc, :] = z[n, a+pr, b+pc, (2pr+pc)*C:(2pr+pc+1)*C] + bias

CUDA: ``csrc/subpixel.cu``. The parity convs run outside both, as in JAX.
Both take bf16 or f32 (templates of the element type).
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


@_lib.wrapper
def subpixel_interleave(y00, y01, y10, y11, bias):
    """A CPU tensor runs :func:`subpixel_interleave_plain`; a CUDA tensor
    (contiguous bf16 or f32, C % 8 == 0) runs the kernel or raises."""
    if y00.device.type == "cpu":
        return subpixel_interleave_plain(y00, y01, y10, y11, bias)
    n, h, w, c = y00.shape
    dt = _lib.kernel_dtype(y00, "C")
    for y in (y00, y01, y10, y11):
        _lib.require(y, dt, (n, h, w, c))
    if c % 8:
        raise ValueError(f"kernel C takes C % 8 == 0, got C={c}")
    bias = _lib.f32(bias)
    _lib.same_device(bias, y00)
    out = y00.new_empty((n, 2 * h, 2 * w, c))
    _lib.call("vt_subpixel_interleave" + ("_f32" if dt == torch.float32 else ""),
              y00, y01, y10, y11, bias, out, n, h, w, c)
    subpixel_interleave.launches += 1
    return out


def subpixel_interleave_z_plain(z, bias):
    """Plain PyTorch form of I. z: ``[N, H+1, W+1, 4C]`` -> ``[N, 2H, 2W, C]``."""
    _, h1, w1, c4 = z.shape
    h, w, c = h1 - 1, w1 - 1, c4 // 4
    return subpixel_interleave_plain(z[:, :h, :w, :c], z[:, :h, 1:, c:2 * c],
                                     z[:, 1:, :w, 2 * c:3 * c], z[:, 1:, 1:, 3 * c:],
                                     bias)


@_lib.wrapper
def subpixel_interleave_z(z, bias):
    """Kernel I. A CPU tensor runs :func:`subpixel_interleave_z_plain`; a
    CUDA tensor (contiguous bf16 or f32, C % 8 == 0) runs the kernel or
    raises."""
    n, h1, w1, c4 = z.shape
    c = bias.shape[0]
    if c4 != 4 * c:
        raise ValueError(f"z has {c4} channels, not 4 x {c}")
    if z.device.type == "cpu":
        return subpixel_interleave_z_plain(z, bias)
    dt = _lib.kernel_dtype(z, "I")
    _lib.require(z, dt, (n, h1, w1, c4))
    if c % 8:
        raise ValueError(f"kernel I takes C % 8 == 0, got C={c}")
    bias = _lib.f32(bias)
    _lib.same_device(bias, z)
    out = z.new_empty((n, 2 * (h1 - 1), 2 * (w1 - 1), c))
    _lib.call("vt_subpixel_interleave_z" + ("_f32" if dt == torch.float32 else ""), z, bias,
              out, n, h1 - 1, w1 - 1, c)
    subpixel_interleave_z.launches += 1
    return out
