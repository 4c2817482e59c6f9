"""Convolutions on channels-last ``[B, T, H, W, C]`` tensors.

Counterpart of ``vidtok_tpu/modules/conv.py``. Weights keep the reference
torch layouts (Conv3d OIDHW, Conv2d OIHW, Conv1d OIk) and names, so a
released torch state dict loads as it is. The non-causal model's convs
(``Conv3d``, ``Conv1d``) pad symmetrically and hold their weights
directly; the causal wrappers nest theirs in ``.conv``. Each conv runs as one
``F.conv3d`` on the ``permute(0, 4, 1, 2, 3)`` view of the channels-last
tensor; that view is already ``channels_last_3d``, so cuDNN takes it
without a copy and returns a tensor whose inverse permute is contiguous.

Causal time padding (``time_pad = (kT - 1) + (1 - sT)``) is prepended as
``first_pad_mode`` says: ``zero`` frames (v1.0) or copies of frame 0
(``replicate``, v1.1). Given a :class:`~.stream.Stream`, the causal convs
run one chunk of a stream instead (``conv.py:240-261``, ``:297-318``): the
front is the previous chunk's cached input tail, or frame 0 repeated on
the first chunk. The TPU-only rewrites of the JAX package (the decomposed
per-frame form and the conv_in time fold) are not ported.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import shard_of


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(v)
    if len(t) != 3:
        raise ValueError(f"expected 3 values, got {v!r}")
    return t


def conv3d_cl(x, weight, bias=None, stride=(1, 1, 1), padding=(0, 0, 0)):
    """[B,T,H,W,Ci] x OIDHW weight -> [B,T',H',W',Co], computed in x.dtype."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, stride, padding)
    return y.permute(0, 2, 3, 4, 1)


def pad_time_front(x, n: int, mode: str):
    """Prepend ``n`` frames on axis 1: zeros or copies of frame 0."""
    if n == 0:
        return x
    if mode == "replicate":
        front = x[:, :1].expand(-1, n, *x.shape[2:])
    elif mode == "zero":
        front = x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))
    else:
        raise ValueError(f"unknown first_pad_mode {mode!r}")
    return torch.cat([front, x], dim=1)


def reset_conv_(weight, bias, generator=None, zero: bool = False):
    """torch's default conv init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weight and bias, as ``vidtok_tpu`` inits (``conv.py:147-165``); drawn
    on the CPU from ``generator`` so every device gets the same numbers.
    ``zero`` gives the reference zero_init (kernel and bias 0)."""
    with torch.no_grad():
        if zero:
            weight.zero_()
            if bias is not None:
                bias.zero_()
            return
        bound = 1.0 / math.sqrt(weight[0].numel())
        for p in (weight, bias):
            if p is not None:
                r = torch.empty(p.shape, dtype=torch.float32)
                p.copy_(r.uniform_(-bound, bound, generator=generator))


class Conv3d(nn.Conv3d):
    """Plain 3D conv with symmetric zero padding ``(k-1)//2`` (torch
    ``nn.Conv3d(..., padding=p)``), on channels-last tensors."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3), stride=(1, 1, 1),
                 padding=None):
        k = _triple(kernel)
        pad = tuple((kk - 1) // 2 for kk in k) if padding is None else _triple(padding)
        super().__init__(cin, cout, k, _triple(stride), pad)

    def reset_params(self, generator=None):
        reset_conv_(self.weight, self.bias, generator)

    def forward(self, x, stream=None):
        """``stream`` is None: the non-causal model has no streaming form
        (its encoder and decoder refuse one)."""
        pad = self.padding
        shard = shard_of(self)
        if shard is not None:  # H sharded: halo rows for the H padding
            x, pad = shard.halo(x, pad[1], pad[1]), (pad[0], 0, pad[2])
        return conv3d_cl(x, self.weight, self.bias, self.stride, pad)


class Conv1d(nn.Conv1d):
    """Plain temporal conv with symmetric zero padding ``(k-1)//2`` (the
    non-causal temporal resblock's ``nn.Conv1d(..., padding=p)`` over
    ``(b h w) c t``), run as a (k,1,1) 3D conv on channels-last tensors;
    the weight keeps the reference's ``[O, I, k]``."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 zero_init: bool = False):
        super().__init__(cin, cout, kernel_size, padding=(kernel_size - 1) // 2)
        self.zero_init = zero_init

    def reset_params(self, generator=None):
        reset_conv_(self.weight, self.bias, generator, self.zero_init)

    def forward(self, x, stream=None):
        """``stream`` is None, as for ``Conv3d``."""
        return conv3d_cl(x, self.weight[..., None, None], self.bias, (1, 1, 1),
                         (self.padding[0], 0, 0))


def _front(conv, x, stream):
    """A causal conv's time front: its stream-start pad, or with ``stream``
    the cached tail of the previous chunk (no cache when ``time_pad`` is
    0)."""
    if stream is None or conv.time_pad == 0:
        return pad_time_front(x, conv.time_pad, conv.first_pad_mode)
    return stream.front(conv, x, conv.time_pad)


class CausalConv3d(nn.Module):
    """Causal 3D conv: time front pad only, symmetric spatial zero pad.
    The weights sit in ``self.conv`` as in the reference wrapper.
    ``cache_offset``: see :class:`~.stream.Stream`."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3), stride=(1, 1, 1),
                 first_pad_mode: str = "zero", cache_offset: int = 0):
        super().__init__()
        kt, kh, kw = _triple(kernel)
        if kh % 2 == 0 or kw % 2 == 0:
            raise ValueError("spatial kernel sizes must be odd")
        self.stride = _triple(stride)
        self.time_pad = (kt - 1) + (1 - self.stride[0])
        self.first_pad_mode = first_pad_mode
        self.cache_offset = cache_offset
        self.conv = nn.Conv3d(cin, cout, (kt, kh, kw), self.stride)

    def reset_params(self, generator=None):
        reset_conv_(self.conv.weight, self.conv.bias, generator)

    def forward(self, x, stream=None):
        return self.conv_fronted(_front(self, x, stream))

    def conv_fronted(self, x, weight=None, bias: bool = True):
        """The conv of ``x`` that already holds its ``time_pad`` front
        frames; ``weight`` in place of ``self.conv.weight`` (the same
        values, as the caller keeps them), ``bias=False`` leaves the bias for
        the caller to add."""
        _, kh, kw = self.conv.kernel_size
        ph = kh // 2
        shard = shard_of(self)
        if shard is not None:  # H sharded: halo rows for the H padding
            x, ph = shard.halo(x, ph, ph), 0
        return conv3d_cl(x, self.conv.weight if weight is None else weight,
                         self.conv.bias if bias else None, self.stride, (0, ph, kw // 2))


class CausalConv1d(nn.Module):
    """Temporal-only causal conv, run as a (k,1,1) 3D conv on NTHWC.
    ``self.conv`` holds the reference ``nn.Conv1d`` weight ``[O, I, k]``."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 first_pad_mode: str = "zero", zero_init: bool = False,
                 cache_offset: int = 0):
        super().__init__()
        self.stride = stride
        self.time_pad = (kernel_size - 1) + (1 - stride)
        self.first_pad_mode = first_pad_mode
        self.zero_init = zero_init
        self.cache_offset = cache_offset
        self.conv = nn.Conv1d(cin, cout, kernel_size, stride)

    def reset_params(self, generator=None):
        reset_conv_(self.conv.weight, self.conv.bias, generator, self.zero_init)

    def forward(self, x, stream=None):
        x = _front(self, x, stream)
        w = self.conv.weight
        return conv3d_cl(x, w[..., None, None], self.conv.bias,
                         (self.stride, 1, 1))


class SpatialConv(nn.Conv2d):
    """Per-frame 2D conv on ``[B,T,H,W,C]`` (the reference's ``(b t) c h w``
    fold + ``nn.Conv2d``); ``padding`` is (top, bottom, left, right)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 padding: Sequence[int] = None):
        super().__init__(cin, cout, kernel_size, stride)
        p = (kernel_size - 1) // 2
        self.pad4 = (p, p, p, p) if padding is None else tuple(padding)

    def reset_params(self, generator=None):
        reset_conv_(self.weight, self.bias, generator)

    def forward(self, x):
        top, bottom, left, right = self.pad4
        shard = shard_of(self)
        if shard is not None:
            # H sharded: halo rows for the H padding (the downsample's
            # (0, 1) takes one row from the slab below; slabs start on even
            # rows, so its stride-2 grid is the whole frame's)
            x, top, bottom = shard.halo(x, top, bottom), 0, 0
        if top == bottom and left == right:
            pad = (0, top, left)
        else:
            x = F.pad(x, (0, 0, left, right, top, bottom))
            pad = (0, 0, 0)
        return conv3d_cl(x, self.weight[:, :, None], self.bias,
                         (1, self.stride[0], self.stride[1]), pad)
