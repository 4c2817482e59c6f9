"""Seeded weights and inputs, made on the device in a few large draws.

The weights are a reference-layout state dict (names and shapes from
:func:`model.param_shapes`), in float32, the type the tokenizer keeps them
in: every convolution weight and bias uniform in +-1/sqrt(fan_in) (the
published init's bound, the zero-initialised temporal conv2 included),
every LayerNorm scale 1 + 0.1 N(0, 1) and shift 0.1 N(0, 1), every mix
factor 2 + 0.5 N(0, 1), so that every parameter does work. All uniform
values come from one draw and all normal ones from another.

A clip is a smooth pattern of three sinusoids per channel drifting across
the frame, plus noise, quantized to 8-bit levels and mapped to [-1, 1].
"""

from __future__ import annotations

import hashlib
import math

import torch

from .model import Spec, param_shapes


def derive(seed: int, purpose: str, index: int = 0) -> int:
    """A 63-bit generator seed for one purpose of one run seed."""
    digest = hashlib.sha256(f"{seed}:{purpose}:{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def state_dict(spec: Spec, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} from ``seed``."""
    shapes = param_shapes(spec)
    normal = [k for k in shapes if k.endswith(("norm.weight", "norm.bias", "mix_factor"))]
    uniform = [k for k in shapes if k not in set(normal)]
    g = torch.Generator(device).manual_seed(derive(seed, "weights"))
    u = torch.rand(sum(math.prod(shapes[k]) for k in uniform), generator=g, device=device)
    nv = torch.randn(sum(math.prod(shapes[k]) for k in normal), generator=g, device=device)
    out, at = {}, 0
    for k in uniform:
        n = math.prod(shapes[k])
        weight = k.rsplit(".", 1)[0] + ".weight"
        bound = 1.0 / math.sqrt(math.prod(shapes[weight][1:]))
        out[k] = u[at:at + n].view(shapes[k]).mul_(2 * bound).sub_(bound)
        at += n
    at = 0
    for k in normal:
        n = math.prod(shapes[k])
        mean, scale = ((1.0, 0.1) if k.endswith("norm.weight") else
                       (2.0, 0.5) if k.endswith("mix_factor") else (0.0, 0.1))
        out[k] = nv[at:at + n].view(shapes[k]).mul_(scale).add_(mean)
        at += n
    return {k: out[k] for k in shapes}


def clip(seed: int, index: int, shape, device) -> torch.Tensor:
    """Clip ``index`` of a run: float32 [B, 3, T, H, W] in [-1, 1]."""
    b, c, t, h, w = shape
    g = torch.Generator(device).manual_seed(derive(seed, "clip", index))
    freq = 2 + 7 * torch.rand((b, c, 3, 2), generator=g, device=device)
    phase = 6.3 * torch.rand((b, c, 3), generator=g, device=device)
    grid = torch.arange(max(h, w), device=device, dtype=torch.float32) / h
    yy = grid[:h].view(1, h, 1)
    xx = grid[:w].view(1, 1, w)
    tt = torch.arange(t, device=device, dtype=torch.float32).view(t, 1, 1)
    out = torch.empty(shape, device=device)
    for i in range(b):
        for ch in range(c):
            v = sum(torch.sin(freq[i, ch, k, 0] * (xx - 0.02 * tt)
                              + freq[i, ch, k, 1] * (yy + 0.01 * tt) + phase[i, ch, k])
                    for k in range(3))
            out[i, ch] = 0.5 + 0.15 * v
    out += 0.03 * torch.randn(shape, generator=g, device=device)
    return torch.round(out.clamp_(0, 1) * 255) / 255 * 2 - 1
