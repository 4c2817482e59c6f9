"""Video encoder, all three variants (``vidtok_tpu/modules/encoder.py``).

Per level: ``num_res_blocks`` x [spatial resblock + temporal resblock],
a spatial 2x downsample at ``spatial_ds`` levels and a temporal 2x
downsample at the ``tempo_ds`` levels among them; then the mid stack
(3D resblock, attention, 3D resblock), norm_out + SiLU and conv_out to
``2*z_channels`` when ``double_z``. Module names follow the reference torch
model (``down.{i}.block.{j}``, ``down_temporal.{i}.downsample``,
``mid.block_1``, ...).

``variant``:

* ``causal`` (v1.0): interior convs zero-pad the stream start; the input
  gets ``tdf - 1`` front frames whenever ``T % tdf != 0``.
* ``causal_v1_1``: interior convs repeat frame 0; the input is padded to
  the next multiple of ``tdf``.
* ``noncausal`` (``Encoder3D``): symmetric convs, no input padding (T must
  be a multiple of ``tdf``), a spatial downsample at every level but the
  last whatever ``spatial_ds`` says, GroupNorm statistics over the whole
  clip in the mid stack and ``norm_out`` (``video``) and over time in the
  temporal blocks (``column``); no streaming form.

Given a :class:`~.stream.Stream`, ``forward`` encodes one chunk of a
stream: it skips ``pad_input`` (the engine pads the first chunk only,
``autoencoder.py:461``), and the causal convs, temporal blocks and
downsamples carry their caches in the stream.

``use_checkpoint`` (activation checkpointing, ``encoder.py:117-171``):
on the training forward (``train=True``, no stream) every resblock,
resampling block, mid block and the attention are recomputed in the
backward instead of keeping their activations
(``torch.utils.checkpoint``, non-reentrant); values and gradients are
unchanged. ``dropout`` (the resblocks', active on the training forward,
its masks drawn from the forward's ``generator``) and ``use_checkpoint``
exclude each other, as JAX asserts (``encoder.py:126``): a recomputed
block would draw another mask.
"""

from __future__ import annotations

from typing import Optional, Sequence

from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import span
from .blocks import (AttnBlock, ResnetBlock3D, ResnetBlockSpatial,
                     ResnetBlockTemporal, SpatialDownsample,
                     TimeDownsampleRes2x)
from .conv import CausalConv3d, Conv3d, pad_time_front
from .norms import make_norm, silu

VARIANTS = ("causal", "causal_v1_1", "noncausal")


def first_pad_mode(variant: str) -> str:
    """The interior causal convs' stream-start pad of a variant (the
    non-causal variant has none; ``zero`` as in JAX)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return "replicate" if variant == "causal_v1_1" else "zero"


def conv3(cin: int, cout: int, causal: bool, pad: str, cache_offset: int = 0):
    """conv_in / conv_out: a causal 3x3x3 conv, or a symmetric one."""
    if causal:
        return CausalConv3d(cin, cout, 3, first_pad_mode=pad, cache_offset=cache_offset)
    return Conv3d(cin, cout, 3)


def call(remat: bool, module: nn.Module, h, **kwargs):
    """``module(h, **kwargs)``, recomputed in the backward when ``remat``."""
    if remat:
        return checkpoint(module, h, use_reentrant=False, **kwargs)
    return module(h, **kwargs)


def no_stream(module: nn.Module, stream) -> None:
    if stream is not None and not module.causal:
        raise ValueError("the non-causal model has no streaming form: its convs "
                         "see the whole clip")


def check_dropout(dropout: float, use_checkpoint: bool) -> None:
    if dropout > 0.0 and use_checkpoint:
        raise ValueError("use_checkpoint requires dropout=0: a recomputed block "
                         "would draw another dropout mask")


class _Mid(nn.Module):
    def __init__(self, c: int, norm_type: str, first_pad_mode: str,
                 cache_offset: int = 0, causal: bool = True, dropout: float = 0.0):
        super().__init__()
        self.block_1 = ResnetBlock3D(c, c, norm_type, first_pad_mode, cache_offset,
                                     causal, dropout)
        self.attn_1 = AttnBlock(c, norm_type, causal)
        self.block_2 = ResnetBlock3D(c, c, norm_type, first_pad_mode, cache_offset,
                                     causal, dropout)

    def forward(self, h, stream=None, remat: bool = False, train: bool = False,
                generator=None):
        h = call(remat, self.block_1, h, stream=stream, train=train, generator=generator)
        h = call(remat, self.attn_1, h)
        return call(remat, self.block_2, h, stream=stream, train=train,
                    generator=generator)


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, in_channels: int = 3,
                 z_channels: int = 4, double_z: bool = True,
                 spatial_ds: Optional[Sequence[int]] = None,
                 tempo_ds: Optional[Sequence[int]] = None,
                 variant: str = "causal_v1_1", norm_type: str = "layernorm",
                 time_downsample_factor: int = 4,
                 init_pad_mode: str = "replicate", use_checkpoint: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        check_dropout(dropout, use_checkpoint)
        n = len(ch_mult)
        self.use_checkpoint = use_checkpoint
        self.tdf = time_downsample_factor
        self.init_pad_mode = init_pad_mode
        self.variant = variant
        pad, causal = self.first_pad_mode, self.causal
        if spatial_ds is None or not causal:
            spatial_ds = range(n - 1)
        self.spatial_ds = tuple(spatial_ds)
        self.tempo_ds = tuple((n - 2, n - 3) if tempo_ds is None else tempo_ds)

        self.conv_in = conv3(in_channels, ch, causal, pad)
        self.down = nn.ModuleList()
        self.down_temporal = nn.ModuleList()
        c = ch
        for i in range(n):
            c_out = ch * ch_mult[i]
            level, tlevel = nn.Module(), nn.Module()
            level.block = nn.ModuleList()
            tlevel.block = nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlockSpatial(c, c_out, norm_type, dropout))
                tlevel.block.append(ResnetBlockTemporal(c_out, c_out, norm_type, pad,
                                                        causal=causal, dropout=dropout))
                c = c_out
            if i in self.spatial_ds:
                level.downsample = SpatialDownsample(c)
                if i in self.tempo_ds:
                    tlevel.downsample = TimeDownsampleRes2x(c, c, pad, causal=causal)
            self.down.append(level)
            self.down_temporal.append(tlevel)
        self.mid = _Mid(c, norm_type, pad, causal=causal, dropout=dropout)
        self.norm_out = make_norm(norm_type, c, "frame" if causal else "video")
        self.conv_out = conv3(c, 2 * z_channels if double_z else z_channels, causal, pad)

    @property
    def causal(self) -> bool:
        return self.variant != "noncausal"

    @property
    def first_pad_mode(self) -> str:
        """The interior causal convs' stream-start pad."""
        return first_pad_mode(self.variant)

    def pad_input(self, x):
        """Front-pad T with ``init_pad_mode`` frames when it is not a
        multiple of the time downsample factor (``encoder.py:80-101``):
        ``tdf - 1`` frames (v1.0), or up to the next multiple (v1.1); the
        non-causal model pads nothing."""
        t = x.shape[1]
        if t % self.tdf == 0 or not self.causal:
            return x
        n = self.tdf - t % self.tdf if self.variant == "causal_v1_1" else self.tdf - 1
        mode = "replicate" if self.init_pad_mode == "replicate" else "zero"
        return pad_time_front(x, n, mode)

    def forward(self, x, fused: bool = False, stream=None, train: bool = False,
                generator=None):
        """x: [B, T, H, W, C] -> posterior parameters [B, T', H', W', 2Cz].
        ``train``: the training forward (activation checkpointing when
        ``use_checkpoint``, dropout masks from ``generator``). Spanned as
        ``vt.model.encoder``."""
        no_stream(self, stream)
        with span("vt.model.encoder"):
            if stream is None:
                x = self.pad_input(x)
            remat = train and self.use_checkpoint and stream is None
            h = self.conv_in(x, stream)
            for level, tlevel in zip(self.down, self.down_temporal):
                for sp, tm in zip(level.block, tlevel.block):
                    h = call(remat, sp, h, fused=fused, train=train, generator=generator)
                    h = call(remat, tm, h, fused=fused, stream=stream, train=train,
                             generator=generator)
                if hasattr(level, "downsample"):
                    h = call(remat, level.downsample, h)
                if hasattr(tlevel, "downsample"):
                    h = call(remat, tlevel.downsample, h, stream=stream)
            h = self.mid(h, stream, remat, train, generator)
            return self.conv_out(silu(self.norm_out(h)), stream)

