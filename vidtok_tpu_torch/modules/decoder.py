"""Video decoder, all three variants (``vidtok_tpu/modules/decoder.py``).

conv_in -> mid (3D resblock, attention, 3D resblock) -> levels from the
deepest up, each ``num_res_blocks + 1`` x [spatial + temporal resblock],
a spatial 2x upsample at ``spatial_us`` levels and a temporal 2x upsample
at the ``tempo_us`` levels among them -> norm_out + SiLU + conv_out to RGB
(kernel D when ``fused`` in a causal layernorm decoder, or D' in the
``taps`` tail form). ``forms``
(:class:`~..ops.kernels.KernelForms`) picks the upsamples' and the tail's
kernel forms when ``fused`` is set.

* ``causal`` (v1.0): zero stream-start pads; the temporal upsample is
  nearest whatever ``interpolation_mode`` says (kernel E when ``fused``);
  the first ``tdf - 1`` decoded frames are dropped (``decoder.py:291-293``).
* ``causal_v1_1``: replicate pads, ``interpolation_mode`` (trilinear in
  the released configs); every decoded frame is returned and the model
  crops to the input length.
* ``noncausal`` (``Decoder3D``): symmetric convs, a spatial upsample at
  every level but the first whatever ``spatial_us`` says, a nearest
  temporal upsample with no parity form, ``video`` GroupNorm statistics
  in the mid stack and ``norm_out``, no crop and no tail kernel
  (``decoder.py:60-78``, ``:100-293``); no streaming form.

Given a :class:`~.stream.Stream`, ``forward`` decodes one chunk of a
stream. Each stage's ``cache_offset`` (:meth:`Decoder.stage_offsets`)
applies when the stream uses offsets (overlap-tiled decode). The tail
caches the last two RAW pre-norm frames (``decoder.py:205-250``), on both
paths: it runs on ``[2 cached | chunk]`` (the first chunk: frame 0 twice)
and drops the first two output frames, which equals the activated-input
cache of a streaming conv_out because LayerNorm+SiLU is per position.

The training forward (``train=True``, no stream) applies the resblocks'
``dropout`` (masks from its ``generator``; ``use_checkpoint`` needs
``dropout`` 0, ``decoder.py:122``), recomputes every
resblock, mid block, the attention and the upsamples in the backward when
``use_checkpoint`` is set (``decoder.py:120-143``), and with
``return_features`` also returns ``conv_out``'s input (norm_out + SiLU),
which the adaptive GAN weight differentiates through ``conv_out``. It
runs the plain path: the kernels have no backward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.kernels import KernelForms, decoder_tail_rgb, decoder_tail_rgb_taps
from ..utils.profiling import span
from .blocks import (ResnetBlockSpatial, ResnetBlockTemporal, SpatialUpsample,
                     TimeUpsampleRes2x)
from .encoder import _Mid, call, check_dropout, conv3, first_pad_mode, no_stream
from .norms import make_norm, silu


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_ch: int = 3, z_channels: int = 4,
                 spatial_us: Optional[Sequence[int]] = None,
                 tempo_us: Optional[Sequence[int]] = None,
                 variant: str = "causal_v1_1", norm_type: str = "layernorm",
                 interpolation_mode: str = "trilinear", tanh_out: bool = False,
                 time_downsample_factor: int = 4, use_checkpoint: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        check_dropout(dropout, use_checkpoint)
        n = len(ch_mult)
        self.use_checkpoint = use_checkpoint
        self.tanh_out = tanh_out
        self.variant = variant
        pad, causal = self.first_pad_mode, self.causal
        self.tail_kernel = causal and norm_type == "layernorm"
        # v1.0 drops its first tdf-1 output frames
        self.crop = time_downsample_factor - 1 if variant == "causal" else 0
        if variant != "causal_v1_1":
            interpolation_mode = "nearest"
        if spatial_us is None or not causal:
            spatial_us = range(1, n)
        self.spatial_us = tuple(spatial_us)
        self.tempo_us = tuple((1, 2) if tempo_us is None else tempo_us)
        mid_off, level_offs, up_offs, out_off = self.stage_offsets(n)

        c = ch * ch_mult[n - 1]
        self.conv_in = conv3(z_channels, c, causal, pad, mid_off)
        self.mid = _Mid(c, norm_type, pad, mid_off, causal, dropout)
        levels = {}
        ntu = 1
        for i in reversed(range(n)):
            c_out = ch * ch_mult[i]
            level, tlevel = nn.Module(), nn.Module()
            level.block = nn.ModuleList()
            tlevel.block = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlockSpatial(c, c_out, norm_type, dropout))
                tlevel.block.append(ResnetBlockTemporal(c_out, c_out, norm_type, pad,
                                                        level_offs[i], causal, dropout))
                c = c_out
            if i in self.spatial_us:
                level.upsample = SpatialUpsample(c)
                if i in self.tempo_us:
                    tlevel.upsample = TimeUpsampleRes2x(
                        c, c, ntu, pad, interpolation_mode=interpolation_mode,
                        cache_offset=up_offs[i], causal=causal)
                    ntu *= 2
            levels[i] = (level, tlevel)
        # indexed by level, as the reference's ``up.insert(0, ...)``
        self.up = nn.ModuleList(levels[i][0] for i in range(n))
        self.up_temporal = nn.ModuleList(levels[i][1] for i in range(n))
        self.norm_out = make_norm(norm_type, c, "frame" if causal else "video")
        self.conv_out = conv3(c, out_ch, causal, pad, out_off)

    @property
    def causal(self) -> bool:
        return self.variant != "noncausal"

    @property
    def first_pad_mode(self) -> str:
        """The interior causal convs' stream-start pad."""
        return first_pad_mode(self.variant)

    def stage_offsets(self, n: int):
        """Per-stage cache offsets for overlap-tiled decode (``decoder.py:
        80-98``): walking the decode order with ``cur = 1``, the temporal
        blocks of a level get ``cur``; a temporal upsample's conv, which
        runs on upsampled frames, gets ``2 * cur``, and doubles ``cur``;
        conv_in and the mid stack get 1 and the tail the final ``cur``.
        Returns (mid, {level: offset}, {level: upsample offset}, tail)."""
        cur = 1
        level_offs, up_offs = {}, {}
        for i in reversed(range(n)):
            level_offs[i] = cur
            if i in self.tempo_us:
                up_offs[i] = 2 * cur
                cur *= 2
        return 1, level_offs, up_offs, cur

    def forward(self, z, fused: bool = False, stream=None,
                forms: KernelForms = KernelForms(), train: bool = False,
                return_features: bool = False, generator=None):
        """z: [B, T', H', W', Cz] -> [B, tdf*T' - crop, H, W, out_ch]; with
        ``return_features`` (no stream), (that, conv_out's input). Spanned
        as ``vt.model.decoder``."""
        no_stream(self, stream)
        if return_features and stream is not None:
            raise ValueError("return_features has no streaming form")
        with span("vt.model.decoder"):
            remat = train and self.use_checkpoint and stream is None
            h = self.mid(self.conv_in(z, stream), stream, remat, train, generator)
            for level, tlevel in zip(reversed(self.up), reversed(self.up_temporal)):
                for sp, tm in zip(level.block, tlevel.block):
                    h = call(remat, sp, h, fused=fused, train=train, generator=generator)
                    h = call(remat, tm, h, fused=fused, stream=stream, train=train,
                             generator=generator)
                if hasattr(level, "upsample"):
                    h = call(remat, level.upsample, h, fused=fused, forms=forms)
                if hasattr(tlevel, "upsample"):
                    h = call(remat, tlevel.upsample, h, fused=fused, stream=stream,
                             forms=forms)
            if stream is not None:
                h = stream.front(self.conv_out, h, 2)
            pre = None
            if fused and self.tail_kernel and not return_features:
                norm = self.norm_out.norm
                conv = self.conv_out.conv
                rgb = decoder_tail_rgb_taps if forms.tail == "taps" else decoder_tail_rgb
                h = rgb(h, (norm.weight, norm.bias), (conv.weight, conv.bias),
                        self.first_pad_mode)
            else:
                pre = silu(self.norm_out(h))
                h = self.conv_out(pre)
            if stream is not None:
                h = h[:, 2:]
            if self.tanh_out:
                h = torch.tanh(h)
            if return_features:
                return h[:, self.crop:], pre
            return h[:, self.crop:]
