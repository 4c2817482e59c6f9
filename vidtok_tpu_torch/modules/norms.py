"""Normalization (channels-last, fp32 statistics).

Counterpart of ``vidtok_tpu/modules/norms.py``. Only the layernorm family
is ported so far; GroupNorm and its four statistic modes come with the
non-causal and groupnorm configurations.
"""

from __future__ import annotations

import torch
from torch import nn


def layer_norm(x, weight, bias, eps: float = 1e-6):
    """LayerNorm over the trailing channel axis with f32 statistics; the
    result is cast back to the input dtype (``ChannelLayerNorm``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def silu(x):
    """x * sigmoid(x) in the input dtype (reference ``nonlinearity``)."""
    return x * torch.sigmoid(x)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over channels of ``[..., C]``; eps 1e-6 as the reference.

    The affine parameters live in a nested ``norm`` module, as in the
    reference torch model, so state-dict keys read ``<name>.norm.weight``.
    """

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.norm = nn.LayerNorm(channels, eps=eps)

    def forward(self, x):
        return layer_norm(x, self.norm.weight, self.norm.bias, self.eps)


def make_norm(norm_type: str, channels: int) -> ChannelLayerNorm:
    if norm_type != "layernorm":
        raise NotImplementedError(
            f"norm_type {norm_type!r}: only layernorm is ported")
    return ChannelLayerNorm(channels)
