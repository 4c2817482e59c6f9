"""Residual, attention and resampling blocks on ``[B, T, H, W, C]``.

Counterpart of ``vidtok_tpu/modules/blocks.py``: the causal blocks (v1.0
and v1.1) and, with ``causal=False``, the non-causal ones (symmetric
convs, ``column`` and ``video`` GroupNorm statistics), each with
``layernorm`` or ``groupnorm``. ``fused=True`` routes the spatial and
temporal resblocks, the spatial-upsample tail and the nearest temporal
upsample through kernels A, B (F on a stream), C (or I) and E (or H, or G),
and the trilinear temporal upsample through cuDNN's base convs of its input
frames and the blend kernel (``ops/kernels``), the upsamples in the forms a
:class:`~..ops.kernels.KernelForms` names, where JAX would take its Pallas
kernel: A only with layernorm, B and F only in a causal layernorm block,
E only in the causal nearest upsample; the wrappers run the plain forms on
CPU tensors. ``fused`` alone decides: where the JAX module takes a Pallas
kernel with ``fused`` off (the nearest temporal upsample whenever
``deterministic``, ``blocks.py:529-533``), the port's plain path launches
none. JAX's separate ``fused_streaming`` switch is not carried over.

On an H slab of ``VideoTokenizer.forward_sharded`` the operations that
read across H take what they need from the other slabs
(``parallel/mesh.py``): the convs their halo rows (``modules/conv.py``),
the plain spatial upsample's pad and the parity upsample one halo row
each side, the attention the whole frame's keys and values, GroupNorm its
sums (``modules/norms.py``). The parity upsample runs its kernel form on
the halo'd slab where the shard says so (as JAX's sharded graph takes
Pallas E); the other fused forms do not run sharded. The temporal convs,
resamplers and interpolation read within a slab.

The three resblocks take ``dropout`` p, JAX's ``nn.Dropout`` between the
second SiLU and ``conv2`` (``blocks.py:67-68``, ``:184-185``,
``:231-232``), active only on the training forward (``train=True``), where
its masks come from the caller's generator. Serving is unchanged by it,
kernels included: JAX declines its Pallas resblocks for a model with
dropout (``blocks.py:50``, ``:100``, ``:114``), but dropout is the identity
there, and each kernel is held to the plain path it replaces.

A block given a :class:`~.stream.Stream` runs one chunk of a stream; the
time-causal ones carry their state in it (the spatial blocks and attention
are per frame and carry none). Each module keeps one cache layout on both
paths, so a stream may switch ``fused`` between chunks; the exception is
the trilinear temporal upsample, whose fused form caches what its blend
reads and raises on the unfused form's caches.

Spans (``utils/profiling.span``): ``vt.model.down.spatial``,
``vt.model.down.temporal``, ``vt.model.up.spatial`` and
``vt.model.up.temporal`` around each down- and upsample module,
``vt.stream.cache`` around the temporal resamplers' own cache reads and
writes.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels import (KernelForms, fused_spatial_resblock,
                           fused_temporal_resblock,
                           fused_temporal_resblock_stream,
                           parity_blend_interleave, parity_blend_interleave4,
                           parity_up2x_fused, subpixel_interleave,
                           subpixel_interleave_z)
from ..ops.kernels import _lib
from ..ops.kernels.parity_upsample import parity_up2x_fused_plain
from ..ops.kernels.temporal_linear import temporal_linear_upsample
from ..parallel.mesh import shard_of
from ..utils.profiling import span
from .conv import (CausalConv1d, CausalConv3d, Conv1d, Conv3d, SpatialConv,
                   pad_time_front)
from . import interp
from .interp import (spatial_avg_pool2x, spatial_nearest_up2x,
                     temporal_avg_pool3_stride2, temporal_nearest_up2x)
from .norms import make_norm, silu


def _base_taps(weight, dtype):
    """A 3x3x3 conv weight ``[C, C, 3, 3, 3]`` as the (1,3,3) conv of its
    three time taps stacked on the output channels ``[3C, C, 1, 3, 3]``, in
    ``dtype``, channels-last as cuDNN reads it beside a channels-last
    input."""
    taps = torch.cat(weight.to(dtype).unbind(2))[:, :, None]
    return taps.contiguous(memory_format=torch.channels_last_3d)


def _norm_args(norm):
    return (norm.norm.weight, norm.norm.bias)


def _frame_conv(x, weight, padding):
    """Per-frame 2D conv of ``[B, T, H, W, C]`` (or ``[N, H, W, C]``) in
    x.dtype, as cuDNN runs it on the channels-last view: the NHWC result
    comes back without a layout copy."""
    lead = x.shape[:-3]
    xf = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    y = F.conv2d(xf, weight.to(x.dtype), None, 1, padding).permute(0, 2, 3, 1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


def dropout(h, p: float, train: bool, generator: torch.Generator = None):
    """JAX's ``nn.Dropout(p)`` on the training forward: each value kept where
    ``torch.rand(..., generator=generator) >= p`` and scaled by 1 / (1 - p),
    the rest zeroed; the identity when not ``train`` or p == 0. The mask
    comes from ``generator`` (on h's device; None: torch's default one), so
    equal generator states give equal masks."""
    if not train or p == 0.0:
        return h
    keep = torch.rand(h.shape, generator=generator, device=h.device) >= p
    return torch.where(keep, h / (1.0 - p), h.new_zeros(()))


class ResnetBlockSpatial(nn.Module):
    """Per-frame 2D residual block (``blocks.py:37-72``); kernel A with
    layernorm."""

    def __init__(self, cin: int, cout: int, norm_type: str = "layernorm",
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.kernel_ok = norm_type == "layernorm"
        self.norm1 = make_norm(norm_type, cin)
        self.conv1 = SpatialConv(cin, cout, 3)
        self.norm2 = make_norm(norm_type, cout)
        self.conv2 = SpatialConv(cout, cout, 3)
        if cin != cout:
            self.nin_shortcut = SpatialConv(cin, cout, 1)

    def forward(self, x, fused: bool = False, train: bool = False,
                generator: torch.Generator = None):
        if fused and self.kernel_ok:
            b, t = x.shape[:2]
            nin = self.nin_shortcut if hasattr(self, "nin_shortcut") else None
            y = fused_spatial_resblock(
                x.reshape((b * t,) + tuple(x.shape[2:])),
                _norm_args(self.norm1), (self.conv1.weight, self.conv1.bias),
                _norm_args(self.norm2), (self.conv2.weight, self.conv2.bias),
                None if nin is None else (nin.weight, nin.bias))
            return y.reshape((b, t) + tuple(y.shape[1:]))
        h = self.conv1(silu(self.norm1(x)))
        h = self.conv2(dropout(silu(self.norm2(h)), self.dropout, train, generator))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class ResnetBlockTemporal(nn.Module):
    """Temporal residual block (``blocks.py:75-189``). Causal: k=3 causal
    convs, GroupNorm mode ``position``; kernel B, or kernel F on a stream,
    with layernorm. Non-causal: symmetric k=3 convs (``Conv1d``), mode
    ``column``, no kernel. ``conv2`` is zero-initialized so the block
    starts as the identity. On a stream each causal conv caches 2 frames
    of its activated input (``cache_offset`` frames back with offsets)
    under its own path, on both paths."""

    def __init__(self, cin: int, cout: int, norm_type: str = "layernorm",
                 first_pad_mode: str = "zero", cache_offset: int = 0,
                 causal: bool = True, dropout: float = 0.0):
        super().__init__()
        self.first_pad_mode = first_pad_mode
        self.dropout = dropout
        self.kernel_ok = causal and norm_type == "layernorm" and cin == cout
        mode = "position" if causal else "column"
        self.norm1 = make_norm(norm_type, cin, mode)
        self.norm2 = make_norm(norm_type, cout, mode)
        if causal:
            self.conv1 = CausalConv1d(cin, cout, 3, first_pad_mode=first_pad_mode,
                                      cache_offset=cache_offset)
            self.conv2 = CausalConv1d(cout, cout, 3, first_pad_mode=first_pad_mode,
                                      zero_init=True, cache_offset=cache_offset)
            if cin != cout:
                self.nin_shortcut = CausalConv1d(cin, cout, 1,
                                                 first_pad_mode=first_pad_mode)
        else:
            self.conv1 = Conv1d(cin, cout, 3)
            self.conv2 = Conv1d(cout, cout, 3, zero_init=True)
            if cin != cout:
                self.nin_shortcut = Conv1d(cin, cout, 1)

    def forward(self, x, fused: bool = False, stream=None, train: bool = False,
                generator: torch.Generator = None):
        if fused and self.kernel_ok:
            args = (x, _norm_args(self.norm1),
                    (self.conv1.conv.weight, self.conv1.conv.bias),
                    _norm_args(self.norm2),
                    (self.conv2.conv.weight, self.conv2.conv.bias))
            if stream is None:
                return fused_temporal_resblock(*args, self.first_pad_mode)
            first = stream.first_chunk
            y, c1, c2 = fused_temporal_resblock_stream(
                *args, None if first else stream.get(self.conv1),
                None if first else stream.get(self.conv2), first,
                stream.offset(self.conv1))
            stream.put(self.conv1, c1)
            stream.put(self.conv2, c2)
            return y
        h = self.conv1(silu(self.norm1(x)), stream)
        h = self.conv2(dropout(silu(self.norm2(h)), self.dropout, train, generator),
                       stream)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x, stream)
        return x + h


class ResnetBlock3D(nn.Module):
    """Full 3D residual block of the mid stack (``blocks.py:192-236``):
    causal convs and GroupNorm mode ``frame``, or symmetric ``Conv3d`` and
    mode ``video``."""

    def __init__(self, cin: int, cout: int, norm_type: str = "layernorm",
                 first_pad_mode: str = "zero", cache_offset: int = 0,
                 causal: bool = True, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        mode = "frame" if causal else "video"
        self.norm1 = make_norm(norm_type, cin, mode)
        self.norm2 = make_norm(norm_type, cout, mode)
        if causal:
            self.conv1 = CausalConv3d(cin, cout, 3, first_pad_mode=first_pad_mode,
                                      cache_offset=cache_offset)
            self.conv2 = CausalConv3d(cout, cout, 3, first_pad_mode=first_pad_mode,
                                      cache_offset=cache_offset)
            if cin != cout:
                self.nin_shortcut = CausalConv3d(cin, cout, 1,
                                                 first_pad_mode=first_pad_mode)
        else:
            self.conv1 = Conv3d(cin, cout, 3)
            self.conv2 = Conv3d(cout, cout, 3)
            if cin != cout:
                self.nin_shortcut = Conv3d(cin, cout, 1)

    def forward(self, x, stream=None, train: bool = False,
                generator: torch.Generator = None):
        h = self.conv1(silu(self.norm1(x)), stream)
        h = self.conv2(dropout(silu(self.norm2(h)), self.dropout, train, generator),
                       stream)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x, stream)
        return x + h


class AttnBlock(nn.Module):
    """Per-frame single-head spatial self-attention (``blocks.py:239-268``):
    q/k/v/proj are 1x1 convs (causal wrappers, or plain ``Conv3d`` in the
    non-causal model), q, k and v are cast to f32, the softmax runs in f32
    and the scale is C^-1/2. GroupNorm mode ``frame``, non-causal
    ``video``."""

    def __init__(self, c: int, norm_type: str = "layernorm", causal: bool = True):
        super().__init__()
        self.norm = make_norm(norm_type, c, "frame" if causal else "video")
        conv = (lambda: CausalConv3d(c, c, 1)) if causal else (lambda: Conv3d(c, c, 1))
        self.q, self.k, self.v, self.proj_out = conv(), conv(), conv(), conv()

    def forward(self, x):
        b, t, hh, ww, c = x.shape
        h = self.norm(x)

        def proj(m, v):
            m = m if isinstance(m, Conv3d) else m.conv
            return F.linear(v, m.weight[:, :, 0, 0, 0].to(v.dtype), m.bias.to(v.dtype))

        q = proj(self.q, h).reshape(b * t, 1, hh * ww, c).float()
        k, v = proj(self.k, h), proj(self.v, h)
        shard = shard_of(self)
        if shard is not None:  # H sharded: the whole frame's keys and values
            k, v = shard.gather(torch.stack([k, v]), axis=3).unbind(0)
        k, v = (a.reshape(b * t, 1, -1, c).float() for a in (k, v))
        out = F.scaled_dot_product_attention(q, k, v).to(x.dtype)
        return x + proj(self.proj_out, out.reshape(b, t, hh, ww, c))


class SpatialDownsample(nn.Module):
    """Per-frame 2x downsample: (0,1,0,1) zero pad + 3x3 stride-2 conv, or
    without ``with_conv`` a 2x2 average pool (``blocks.py:271-283``)."""

    def __init__(self, c: int, with_conv: bool = True):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = SpatialConv(c, c, 3, stride=2, padding=(0, 1, 0, 1))

    def forward(self, x):
        with span("vt.model.down.spatial"):
            return self.conv(x) if self.with_conv else spatial_avg_pool2x(x)


class SpatialUpsample(nn.Module):
    """Per-frame nearest 2x upsample + 3x3 conv (``blocks.py:286-385``), as
    four 2x2 parity convs on the source grid whose outputs are interleaved
    by parity (kernel C when ``fused``). With ``fused`` and the ``merged``
    subpixel form, one VALID 2x2 conv of the once-padded input with the
    four parity kernels on output-channel groups, then kernel I
    (``blocks.py:350-364``). Without ``with_conv`` the nearest upsample
    alone (no parameter, no kernel); without ``subpixel`` the upsample
    then the 3x3 conv, plain (the equivalence the subpixel form is held
    to)."""

    def __init__(self, c: int, with_conv: bool = True, subpixel: bool = True):
        super().__init__()
        self.with_conv = with_conv
        self.subpixel = subpixel
        if with_conv:
            self.conv = SpatialConv(c, c, 3)

    def forward(self, x, fused: bool = False, forms: KernelForms = KernelForms()):
        with span("vt.model.up.spatial"):
            return self._up(x, fused, forms)

    def _up(self, x, fused: bool, forms: KernelForms):
        if not self.with_conv:
            return spatial_nearest_up2x(x)
        if not self.subpixel:
            return self.conv(spatial_nearest_up2x(x))
        b, t, h, w, c = x.shape
        k = self.conv.weight.to(x.dtype)                     # [O, I, 3, 3]
        # row-combined taps: parity 0 reads rows a-1, a; parity 1 rows a, a+1
        r0 = torch.stack([k[:, :, 0], k[:, :, 1] + k[:, :, 2]], dim=2)
        r1 = torch.stack([k[:, :, 0] + k[:, :, 1], k[:, :, 2]], dim=2)

        def colmix(kr):
            return (torch.stack([kr[..., 0], kr[..., 1] + kr[..., 2]], dim=-1),
                    torch.stack([kr[..., 0] + kr[..., 1], kr[..., 2]], dim=-1))

        (e00, e01), (e10, e11) = colmix(r0), colmix(r1)
        xf = x.reshape(b * t, h, w, c)
        shard = shard_of(self)
        if shard is not None:  # H sharded: halo rows for the H padding
            xp = F.pad(shard.halo(xf, 1, 1), (0, 0, 1, 1))
        else:
            xp = F.pad(xf, (0, 0, 1, 1, 1, 1))
        if fused and forms.subpixel == "merged":
            z = _frame_conv(xp, torch.cat([e00, e01, e10, e11]), 0)
            y = subpixel_interleave_z(z, self.conv.bias)     # z: [N, H+1, W+1, 4C]
            return y.reshape(b, t, 2 * h, 2 * w, c)
        xp = xp.permute(0, 3, 1, 2)                          # [N, C, H+2, W+2]

        def parity(e, pr, pc):
            y = F.conv2d(xp[:, :, pr:pr + h + 1, pc:pc + w + 1], e)
            return y.permute(0, 2, 3, 1).contiguous()        # [N, H, W, C]

        ys = (parity(e00, 0, 0), parity(e01, 0, 1),
              parity(e10, 1, 0), parity(e11, 1, 1))
        if fused:
            y = subpixel_interleave(*ys, self.conv.bias)
        else:
            y = torch.stack([torch.stack(ys[:2], dim=3),
                             torch.stack(ys[2:], dim=3)], dim=2)
            y = y.reshape(b * t, 2 * h, 2 * w, c) + self.conv.bias.to(x.dtype)
        return y.reshape(b, t, 2 * h, 2 * w, c)


class TimeDownsampleRes2x(nn.Module):
    """Blended temporal 2x downsample (``blocks.py:388-438``):
    ``a*avgpool3s2(pad(x)) + (1-a)*conv3d_s2(...)``, a = sigmoid(mix).
    Causal: the pool pads one front frame and the conv is causal. On a
    stream the pool's front after the first chunk is its cache, the last
    frame of the previous ``[front | x]`` (no offset), and the first
    chunk's front follows ``first_pad_mode``. Non-causal: one zero frame
    at the end, and a stride-(2,1,1) ``Conv3d`` padded (0,1,1) of the same
    padded clip (``blocks.py:411-417``)."""

    def __init__(self, cin: int, cout: int, first_pad_mode: str = "zero",
                 mix_factor_init: float = 2.0, causal: bool = True):
        super().__init__()
        self.first_pad_mode = first_pad_mode
        self.causal = causal
        self.mix_factor = nn.Parameter(torch.full((1,), mix_factor_init))
        if causal:
            self.conv = CausalConv3d(cin, cout, 3, stride=(2, 1, 1),
                                     first_pad_mode=first_pad_mode)
        else:
            self.conv = Conv3d(cin, cout, 3, stride=(2, 1, 1), padding=(0, 1, 1))

    def forward(self, x, stream=None):
        with span("vt.model.down.temporal"):
            return self._down(x, stream)

    def _down(self, x, stream):
        alpha = torch.sigmoid(self.mix_factor).to(x.dtype)
        if not self.causal:
            x_pad = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
            return (alpha * temporal_avg_pool3_stride2(x_pad)
                    + (1 - alpha) * self.conv(x_pad))
        if stream is None:
            x_pad = pad_time_front(x, 1, self.first_pad_mode)
        else:
            with span("vt.stream.cache"):
                x_pad = (pad_time_front(x, 1, self.first_pad_mode) if stream.first_chunk
                         else torch.cat([stream.get(self).to(x.dtype), x], dim=1))
                stream.put(self, x_pad[:, -1:].clone())
        x1 = temporal_avg_pool3_stride2(x_pad)
        x2 = self.conv(x, stream)
        return alpha * x1 + (1 - alpha) * x2


class TimeUpsampleRes2x(nn.Module):
    """Blended temporal 2x upsample (``blocks.py:441-571``):
    ``a*up + (1-a)*conv(up)``, a = sigmoid(mix). With ``causal=False`` (the
    non-causal model): nearest ``up``, a symmetric 3x3x3 ``Conv3d``, no
    parity form and no kernel (``blocks.py:536``, ``:569-570``); the rest
    of this docstring is the causal module.

    ``trilinear`` (v1.1): the first ``num_temp_upsample`` (ntu) frames are
    interpolated apart from the rest. On a stream (``blocks.py:538-553``)
    the first chunk does the same and caches its last ntu frames; a later
    chunk interpolates ``[cache | x]``, drops the first 2*ntu output
    frames, and caches ``[cache | x][-2*ntu:-ntu]`` (not the last ntu
    frames: with overlap the last ones are the look-ahead's), as JAX does.
    With ``fused`` the conv runs on the input frames (``_linear_up_fused``).
    ``nearest``
    (v1.0): the parity form of ``blocks.py:598-668``, which
    never builds the 2x tensor (kernel E when ``fused``); v1.0 cannot tile,
    and its streaming form is not ported. The blend needs ``cin == cout``;
    the JAX module's duplicate-then-conv form for other widths fails at the
    same blend, so it is not ported.

    ``fused`` alone decides whether a kernel runs, in the parity form that
    ``forms`` names: ``fused`` kernel E; ``merged`` one per-frame C->4C conv
    with ``[k_cur | k_prev]`` + kernel H; ``split`` two C->2C convs + kernel
    G (``blocks.py:633-660``), where ``k_cur = [K2 | K1+K2]`` and ``k_prev =
    [K0+K1 | K0]`` are summed in the activation dtype. The JAX module takes
    its Pallas kernel whenever ``deterministic`` is set, ``fused`` or not
    (``blocks.py:529-533``); here the plain path launches no kernel. On an
    H slab the shard's ``parity_kernel`` takes the place of ``fused``.
    """

    def __init__(self, cin: int, cout: int, num_temp_upsample: int = 1,
                 first_pad_mode: str = "zero", mix_factor_init: float = 2.0,
                 interpolation_mode: str = "trilinear", cache_offset: int = 0,
                 causal: bool = True):
        super().__init__()
        if interpolation_mode not in ("trilinear", "nearest"):
            raise ValueError(f"unknown interpolation_mode {interpolation_mode!r}")
        if cin != cout:
            raise ValueError(f"the blend needs cin == cout, got {cin}, {cout}")
        self.ntu = num_temp_upsample
        self.causal = causal
        self.parity = causal and interpolation_mode == "nearest"
        self.first_pad_mode = first_pad_mode
        self.mix_factor = nn.Parameter(torch.full((1,), mix_factor_init))
        if causal:
            self.conv = CausalConv3d(cin, cout, 3, first_pad_mode=first_pad_mode,
                                     cache_offset=cache_offset)
        else:
            self.conv = Conv3d(cin, cout, 3)

    def forward(self, x, fused: bool = False, stream=None,
                forms: KernelForms = KernelForms()):
        with span("vt.model.up.temporal"):
            return self._up(x, fused, stream, forms)

    def _up(self, x, fused: bool, stream, forms: KernelForms):
        alpha = torch.sigmoid(self.mix_factor).to(x.dtype)
        ntu = self.ntu
        if not self.causal:
            x = temporal_nearest_up2x(x)
            return alpha * x + (1 - alpha) * self.conv(x)
        if self.parity:
            if stream is not None:
                raise NotImplementedError(
                    "the nearest (v1.0) temporal upsample has no streaming form")
            shard = shard_of(self)
            if shard is None:
                return self._parity_up(x, alpha, fused, forms)
            # H sharded: its per-frame 3x3 convs read a halo row each side;
            # the output rows of the halo are dropped
            y = self._parity_up(shard.halo(x, 1, 1), alpha, shard.parity_kernel, forms)
            return y[:, :, 1:-1]
        if fused:
            return self._linear_up_fused(x, alpha, stream)
        if stream is not None and not stream.first_chunk:
            with span("vt.stream.cache"):
                xc = torch.cat([stream.get(self).to(x.dtype), x], dim=1)
                stream.put(self, xc[:, -2 * ntu:-ntu].clone())
            x = interp.temporal_linear_up2x(xc)[:, 2 * ntu:]
        else:
            if stream is not None:
                with span("vt.stream.cache"):
                    stream.put(self, x[:, -ntu:].clone())
            head, tail = x[:, :ntu], x[:, ntu:]
            x = interp.temporal_linear_up2x(head)
            if tail.shape[1] > 0:
                x = torch.cat([x, interp.temporal_linear_up2x(tail)], dim=1)
        return alpha * x + (1 - alpha) * self.conv(x, stream)

    def _linear_up_fused(self, x, alpha, stream):
        """The trilinear branch with its conv on the input frames
        (``ops/kernels/temporal_linear.temporal_linear_upsample``): cuDNN's
        (1,3,3) conv of x with the three time taps stacked (the weight cast
        and laid out once; the H padding and the shard's halo rows of
        ``conv_fronted``), then the blend kernel, which interpolates and
        blends in one pass.

        On a stream the caches are what the blend reads, not the plain
        branch's: under this module the frame before the next chunk (the
        last of the plain branch's ntu frames), under the conv the next
        chunk's front sums ``[B, 3, H, W, C]``, what the frames before it add
        to the conv of its first three output frames (the plain branch's two
        front frames and that predecessor frame, convolved). So no cached
        frame is convolved again. A later chunk of fewer than ntu frames,
        whose next predecessor is an older cached frame, raises."""
        ntu, conv = self.ntu, self.conv
        t = x.shape[1]
        prev, split, front, nxt = None, ntu, conv.first_pad_mode, None
        if stream is not None:
            with span("vt.stream.cache"):
                if stream.first_chunk:
                    front, q = "replicate", t - 1
                else:
                    prev, front, split = stream.get(self), stream.get(conv), 0
                    if prev.shape[1] != 1 or front.shape[1] != 3:
                        raise ValueError("the fused trilinear upsample reads the caches "
                                         "of its own fused form, not the unfused form's")
                    prev, front = prev.to(x.dtype), front.to(x.dtype)
                    # the plain branch caches [prev | x][-2ntu:-ntu]: the last of
                    # them is x[t - ntu - 1], or prev itself when t == ntu
                    q = t - ntu - 1
                    if q < -1:
                        raise ValueError(f"a later chunk of {t} frames is shorter than "
                                         f"the upsample's {ntu} head frames")
                nf = 2 * t - stream.offset(conv)  # the row of full the next front starts at
                if nf < 0:
                    raise ValueError(f"cache offset {stream.offset(conv)} reaches before "
                                     f"the chunk start ({2 + 2 * t} frames with the front)")
                nxt = (nf, q)
        weight = _lib.operands(f"time_up_taps_{x.dtype}", (conv.conv.weight,),
                               functools.partial(_base_taps, dtype=x.dtype))
        base = functools.partial(conv.conv_fronted, weight=weight, bias=False)
        # the blend reads the blend factor as one f32 on the device (E's rule)
        y, sums = temporal_linear_upsample(x, base, conv.conv.bias, alpha.float(), split,
                                           prev, front, nxt)
        if stream is not None:
            with span("vt.stream.cache"):
                stream.put(conv, sums)
                stream.put(self, prev if q < 0 else x[:, q:q + 1].clone())
        return y

    def _parity_up(self, x, alpha, fused: bool, forms: KernelForms):
        """The nearest upsample's parity form on ``x`` ``[B, T, H, W, C]``."""
        weight, bias = self.conv.conv.weight, self.conv.conv.bias
        if not fused:
            return parity_up2x_fused_plain(x, weight, bias, alpha, self.first_pad_mode)
        # the kernels read the blend factor as one f32 (the plain forms too):
        # cast here, so that each wrapper launches its kernel alone
        alpha = alpha.float()
        if forms.parity == "fused":
            return parity_up2x_fused(x, weight, bias, alpha, self.first_pad_mode)
        k0, k1, k2 = weight.to(x.dtype).unbind(2)       # [C, C, 3, 3] each
        k_cur = torch.cat([k2, k1 + k2])
        k_prev = torch.cat([k0 + k1, k0])
        if forms.parity == "merged":
            y4 = _frame_conv(x, torch.cat([k_cur, k_prev]), 1)
            return parity_blend_interleave4(x, y4, bias, alpha, self.first_pad_mode)
        return parity_blend_interleave(x, _frame_conv(x, k_cur, 1),
                                       _frame_conv(x, k_prev, 1), bias,
                                       alpha, self.first_pad_mode)
