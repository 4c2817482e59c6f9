"""Normalization (channels-last, fp32 statistics).

Counterpart of ``vidtok_tpu/modules/norms.py``. LayerNorm (torch
``nn.LayerNorm(C)`` on channels-last) is per position over the channel
axis. GroupNorm (32 groups) takes its statistics over the axes its
``mode`` names, which follow how the reference folds the tensor before
normalizing:

  mode        stats per              stats over          used by
  ----------  --------------------   -----------------   -------------------
  'frame'     (b, t, group)          (h, w, c/g)         spatial and causal
                                                         3D blocks, causal
                                                         norm_out, attention
  'video'     (b, group)             (t, h, w, c/g)      non-causal mid,
                                                         attention, norm_out
  'position'  (b, t, h, w, group)    (c/g,)              causal temporal
                                                         resblocks (the
                                                         reference's fold
                                                         quirk, PARITY.md)
  'column'    (b, h, w, group)       (t, c/g)            non-causal temporal
                                                         resblocks

On an H slab of ``VideoTokenizer.forward_sharded`` the ``frame`` and
``video`` statistics, which span H, are sums over the slabs: the mean
first, then the centred square sum. LayerNorm and the other modes are
per position or per column and stay local.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..parallel.mesh import shard_of

# GroupNorm mode -> the axes of [B, T, H, W, G, C/G] its statistics span
GROUP_AXES = {"frame": (2, 3, 5), "video": (1, 2, 3, 5), "position": (5,),
              "column": (1, 5)}


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


class GroupNorm(nn.Module):
    """GroupNorm over ``[B, T, H, W, C]`` with the statistic axes of
    ``mode`` (module docstring), in f32, the result cast back to the input
    dtype. The affine parameters sit on the module itself, as the
    reference's ``nn.GroupNorm``: state-dict keys read ``<name>.weight``."""

    def __init__(self, channels: int, mode: str = "frame", num_groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        if mode not in GROUP_AXES:
            raise ValueError(f"unknown GroupNorm mode {mode!r}")
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by {num_groups} groups")
        self.mode = mode
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_params(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        b, t, h, w, c = x.shape
        g = self.num_groups
        xg = x.float().reshape(b, t, h, w, g, c // g)
        axes = GROUP_AXES[self.mode]
        shard = shard_of(self)
        if shard is not None and 2 in axes:  # H sharded: sums over the slabs
            n = shard.size * math.prod(xg.shape[a] for a in axes)
            mean = shard.sum(xg.sum(axes, keepdim=True)) / n
            var = shard.sum((xg - mean).square().sum(axes, keepdim=True)) / n
        else:
            mean = xg.mean(axes, keepdim=True)
            var = (xg - mean).square().mean(axes, keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


def make_norm(norm_type: str, channels: int, mode: str = "frame") -> nn.Module:
    """The reference ``Normalize``: ``layernorm`` (``mode`` has no effect)
    or ``groupnorm`` with the statistics of ``mode``."""
    if norm_type == "layernorm":
        return ChannelLayerNorm(channels)
    if norm_type == "groupnorm":
        return GroupNorm(channels, mode)
    raise ValueError(f"unknown norm_type {norm_type!r}")
