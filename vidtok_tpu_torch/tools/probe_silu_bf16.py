"""Probe of the SiLU forms on the card: the counterpart of the JAX package's
``tools/probe_silu_bf16.py``.

    python -m vidtok_tpu_torch.tools.probe_silu_bf16 [N H W] [--device cpu]

Times ``silu(x)`` over a bf16 ``[N, H, W]`` tensor (default ``64 512 512``,
a temporal-resblock-sized elementwise pass) in three forms (T4,
``silu_probe``): ``f32_logistic`` (f32, one rounding), ``bf16_tanh`` and
``bf16_logistic`` (every step in bf16), each with its bound and the share
of it reached.

Kernel: ``csrc/probe_silu.cu``. The wrapper runs its plain PyTorch version
for a CPU tensor and its kernel for a CUDA tensor (or raises), and counts
``calls`` and ``launches``. One deliberate divergence: JAX's ``run``
catches a mode's failure and prints it (on the TPU ``bf16_logistic`` was
expected to fail Mosaic's verifier); here every mode compiles for Hopper
and must run, and a failure raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.kernels import _lib
from . import Timer, bound_ms, parse_args, report

MODES = {"f32_logistic": 0, "bf16_tanh": 1, "bf16_logistic": 2}
OPS_PER_VALUE = 5  # the pointwise steps of the longest form


def silu_probe_plain(x, mode: str):
    """Plain PyTorch form of :func:`silu_probe`; x bf16 (an f32 x runs the
    same steps unrounded)."""
    if mode == "f32_logistic":
        xf = x.float()
        return (xf * torch.sigmoid(xf)).to(x.dtype)
    if mode == "bf16_tanh":
        return x * (0.5 * (torch.tanh(x * 0.5) + 1.0))
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def silu_probe(x, mode: str):
    """T4, replacing ``tools/probe_silu_bf16.py:48`` ``run`` (its kernel
    ``make_kernel``): ``y = silu(x)`` in the form ``mode``.
    ``f32_logistic``: ``x * sigmoid(x)`` in f32, rounded once to bf16.
    ``bf16_tanh``: ``x * (0.5 * (tanh(0.5 x) + 1))``, every step rounded to
    bf16. ``bf16_logistic``: ``x * 1 / (1 + exp(-x))``, every step rounded
    to bf16.

    A CPU tensor runs :func:`silu_probe_plain`. A CUDA tensor must be
    contiguous bf16 with a multiple of 8 values; it runs the kernel or
    raises. An unknown mode raises.
    """
    silu_probe.calls += 1
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {tuple(MODES)}")
    if x.device.type == "cpu":
        return silu_probe_plain(x, mode)
    _lib.require(x, torch.bfloat16, x.shape)
    if x.numel() % 8:
        raise ValueError(f"the kernel takes a multiple of 8 values, got {x.numel()}")
    out = torch.empty_like(x)
    _lib.call("vt_silu_probe", x, out, x.numel(), MODES[mode])
    silu_probe.launches += 1
    return out


silu_probe.calls = silu_probe.launches = 0
WRAPPERS = {"silu_probe": silu_probe}


def probe_input(shape, device):
    """N(0, 1) from ``RandomState(0)`` in bf16 on ``device``."""
    x = np.random.RandomState(0).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device, torch.bfloat16)


def probe_bound(n: int) -> tuple:
    """Bound of one call over n bf16 values: read and written once."""
    return bound_ms(2 * 2 * n, vec_flops=OPS_PER_VALUE * n)


def main(argv=None) -> list:
    """Print the rows for ``[N H W] [--device cpu]``; return them."""
    shape, device = parse_args(sys.argv[1:] if argv is None else argv, (64, 512, 512))
    x = probe_input(shape, device)
    timer = Timer(device)
    print(f"x {list(shape)} bf16 on {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)
    rows = []
    for mode in MODES:
        ms = timer(lambda: silu_probe(x, mode), iters=30)
        rate = f"{2 * 2 * x.numel() / ms / 1e6:8.1f} GB/s"
        rows.append(report(mode, ms, probe_bound(x.numel()), device, rate))
    return rows


if __name__ == "__main__":
    main()
