"""Reference module of VidTok's causal KL tokenizers, v1.0 and v1.1: the
plain PyTorch model, its seeded weights, its answers, its frozen kernel
calls and FLOP, and the numbers a run's check compares. A configuration
file names it with ``"reference": "causal_kl"``; the harness reads the
model through the names of the contract section at the end of this file
(``vtbench/README.md``).

The model follows the published one (github.com/microsoft/VidTok,
``vidtok/modules/model_3dcausal.py`` and ``model_3dcausal_v1_1.py``) in its
plainest form, on ``[B, C, T, H, W]`` tensors in float32, with the weights
given as a reference-layout state dict (``{name: tensor}``). It imports
nothing of the program it judges and takes nothing the program made.

Each causal operation reads a front of earlier frames: at the start of a
clip its pad (zeros for v1.0's interior convs, copies of frame 0 for
v1.1's), later the cached tail of the previous chunk. So one code path
gives both the whole clip (no :class:`Stream`) and a stream of chunks (a
:class:`Stream` per chunk). Because every operation is causal in time and
per frame in space, a v1.0 clip encoded and decoded in chunks of whole
latent frames equals the clip done at once; :func:`forward` uses that to
bound memory at long clips.

Departures from the published code, none of which changes a value beyond
rounding: the spatial and temporal convolutions run as ``conv3d`` with a
time kernel of 1 or a space kernel of 1; the nearest temporal upsample
repeats frames and then convolves (the published ``DecoderCausal3D`` does
the same); attention is written out as softmax(q k^T / sqrt(C)) v.

``quant="fp8"`` rounds both operands of every convolution and matrix
product to float8 e4m3 with one scale per tensor (its largest magnitude
onto 448) before computing in float32: the control that the benchmark's
comparison has to reject.

The weights (:func:`weights`) are drawn by ``weights.state_dict`` in float32,
the type the tokenizer keeps them in: every convolution weight and bias
uniform in +-1/sqrt(fan_in) (the published init's bound, the
zero-initialised temporal conv2 included), every LayerNorm scale
1 + 0.1 N(0, 1) and shift 0.1 N(0, 1), every mix factor 2 + 0.5 N(0, 1), so
that every parameter does work.
"""

from __future__ import annotations

import json
import math
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vtbench.reference import weights as W
from vtbench.reference.compare import output_rel_l2
from vtbench.reference.work import chunk_bounds

EPS = 1e-6
FP8_MAX = 448.0


@dataclass(frozen=True)
class Spec:
    """The sizes and variant of a causal VidTok tokenizer, from a config's
    ``model`` section."""

    variant: str            # "v1_0" (EncoderCausal3D) or "v1_1"
    ch: int
    ch_mult: Tuple[int, ...]
    num_res_blocks: int
    z_channels: int
    double_z: bool
    tdf: int
    init_pad_mode: str
    spatial_ds: Tuple[int, ...]
    tempo_ds: Tuple[int, ...]
    spatial_us: Tuple[int, ...]
    tempo_us: Tuple[int, ...]

    @property
    def pad_mode(self) -> str:
        """The interior causal convs' pad at a clip's start."""
        return "replicate" if self.variant == "v1_1" else "zero"

    @property
    def trilinear(self) -> bool:
        return self.variant == "v1_1"


_VARIANT = {"EncoderCausal3D": "v1_0", "EncoderCausal3DV1_1": "v1_1",
            "vidtok.modules.model_3dcausal.EncoderCausal3DPadding": "v1_0",
            "vidtok.modules.model_3dcausal_v1_1.EncoderCausal3DPadding": "v1_1"}


def read_config(config: dict) -> Spec:
    """The :class:`Spec` of a config dict (``{"model": ...}`` or the model
    section); KL, layernorm, causal models only."""
    model = config.get("model", config)
    p = model["params"]
    enc = p["encoder_config"]
    if enc["target"] not in _VARIANT:
        raise ValueError(f"the reference has no model for {enc['target']!r}")
    ep = enc["params"]
    dp = p.get("decoder_config", enc)["params"]
    if ep.get("norm_type") != "layernorm":
        raise ValueError("the reference models layernorm tokenizers only")
    if "DiagonalGaussian" not in p["regularizer_config"]["target"]:
        raise ValueError("the reference models the KL regularizer only")
    n = len(ep["ch_mult"])
    return Spec(
        variant=_VARIANT[enc["target"]], ch=ep["ch"], ch_mult=tuple(ep["ch_mult"]),
        num_res_blocks=ep["num_res_blocks"], z_channels=ep["z_channels"],
        double_z=ep.get("double_z", True), tdf=ep.get("time_downsample_factor", 4),
        init_pad_mode=ep.get("init_pad_mode", "replicate"),
        spatial_ds=tuple(ep.get("spatial_ds") or range(n - 1)),
        tempo_ds=tuple(ep.get("tempo_ds") or (n - 2, n - 3)),
        spatial_us=tuple(dp.get("spatial_us") or range(1, n)),
        tempo_us=tuple(dp.get("tempo_us") or (1, 2)))


# -- the parameters ---------------------------------------------------------

def param_shapes(spec: Spec) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the tokenizer, by its name in the published
    state dict, with its shape."""
    out: Dict[str, Tuple[int, ...]] = {}
    n = len(spec.ch_mult)

    def norm(name, c):
        out[f"{name}.norm.weight"] = (c,)
        out[f"{name}.norm.bias"] = (c,)

    def conv(name, shape):
        out[f"{name}.weight"] = shape
        out[f"{name}.bias"] = (shape[0],)

    def spatial_block(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", (cout, cin, 3, 3))
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", (cout, cout, 3, 3))
        if cin != cout:
            conv(f"{name}.nin_shortcut", (cout, cin, 1, 1))

    def temporal_block(name, c):
        norm(f"{name}.norm1", c)
        conv(f"{name}.conv1.conv", (c, c, 3))
        norm(f"{name}.norm2", c)
        conv(f"{name}.conv2.conv", (c, c, 3))

    def mid(name, c):
        for b in ("block_1", "block_2"):
            norm(f"{name}.{b}.norm1", c)
            conv(f"{name}.{b}.conv1.conv", (c, c, 3, 3, 3))
            norm(f"{name}.{b}.norm2", c)
            conv(f"{name}.{b}.conv2.conv", (c, c, 3, 3, 3))
        norm(f"{name}.attn_1.norm", c)
        for m in ("q", "k", "v", "proj_out"):
            conv(f"{name}.attn_1.{m}.conv", (c, c, 1, 1, 1))

    ch, mult, nrb = spec.ch, spec.ch_mult, spec.num_res_blocks
    conv("encoder.conv_in.conv", (ch, 3, 3, 3, 3))
    c = ch
    for i in range(n):
        for j in range(nrb):
            spatial_block(f"encoder.down.{i}.block.{j}", c, ch * mult[i])
            c = ch * mult[i]
            temporal_block(f"encoder.down_temporal.{i}.block.{j}", c)
        if i in spec.spatial_ds:
            conv(f"encoder.down.{i}.downsample.conv", (c, c, 3, 3))
            if i in spec.tempo_ds:
                out[f"encoder.down_temporal.{i}.downsample.mix_factor"] = (1,)
                conv(f"encoder.down_temporal.{i}.downsample.conv.conv", (c, c, 3, 3, 3))
    mid("encoder.mid", c)
    norm("encoder.norm_out", c)
    zc = 2 * spec.z_channels if spec.double_z else spec.z_channels
    conv("encoder.conv_out.conv", (zc, c, 3, 3, 3))

    c = ch * mult[-1]
    conv("decoder.conv_in.conv", (c, spec.z_channels, 3, 3, 3))
    mid("decoder.mid", c)
    for i in reversed(range(n)):
        for j in range(nrb + 1):
            spatial_block(f"decoder.up.{i}.block.{j}", c, ch * mult[i])
            c = ch * mult[i]
            temporal_block(f"decoder.up_temporal.{i}.block.{j}", c)
        if i in spec.spatial_us:
            conv(f"decoder.up.{i}.upsample.conv", (c, c, 3, 3))
            if i in spec.tempo_us:
                out[f"decoder.up_temporal.{i}.upsample.mix_factor"] = (1,)
                conv(f"decoder.up_temporal.{i}.upsample.conv.conv", (c, c, 3, 3, 3))
    norm("decoder.norm_out", c)
    conv("decoder.conv_out.conv", (3, c, 3, 3, 3))
    return out


# -- streams ----------------------------------------------------------------

class Stream:
    """One chunk of a causal stream: ``old`` is what the previous chunk left
    (None on the first chunk, which pads as the clip start does), ``new``
    collects what this chunk leaves. With ``offsets`` (the overlapped
    decode) a cache is taken the stage's offset of frames back from the
    chunk's end, as if the chunk's look-ahead frames had not been seen."""

    def __init__(self, old: Optional[dict] = None, offsets: bool = False):
        self.old = old
        self.new: dict = {}
        self.offsets = offsets

    @property
    def first(self) -> bool:
        return self.old is None


class Ctx:
    """The weights, the variant and the arithmetic of one evaluation."""

    def __init__(self, params: Dict[str, torch.Tensor], spec: Spec, quant: str = "none"):
        if quant not in ("none", "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.p = params
        self.spec = spec
        self.quant = quant

    def w(self, name):
        return self.p[name].float()

    def q(self, t):
        """An operand of a product, as the arithmetic rounds it."""
        if self.quant == "none":
            return t
        scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _pad_front(x, n: int, mode: str):
    if n == 0:
        return x
    if mode == "replicate":
        head = x[:, :, :1].expand(-1, -1, n, -1, -1)
    else:
        head = torch.zeros_like(x[:, :, :1]).expand(-1, -1, n, -1, -1)
    return torch.cat([head, x], dim=2)


def _front(st: Optional[Stream], key: str, x, n: int, mode: str, offset: int = 0):
    """``[n earlier frames | x]``: the clip-start pad, or the previous
    chunk's cached tail; caches this chunk's tail for the next."""
    if st is None or st.first:
        full = _pad_front(x, n, mode)
    else:
        full = torch.cat([st.old[key], x], dim=2)
    if st is not None:
        end = full.shape[2] - (offset if st.offsets else 0)
        if end - n < 0:
            raise ValueError(f"{key}: offset {offset} reaches before the chunk")
        st.new[key] = full[:, :, end - n:end].clone()
    return full


def layer_norm(ctx: Ctx, name: str, x):
    """LayerNorm over channels at every position (eps 1e-6)."""
    y = F.layer_norm(x.movedim(1, -1), (x.shape[1],), ctx.w(f"{name}.norm.weight"),
                     ctx.w(f"{name}.norm.bias"), EPS)
    return y.movedim(-1, 1)


def silu(x):
    return x * torch.sigmoid(x)


def conv(ctx: Ctx, name: str, x, stride=(1, 1, 1), padding=(0, 0, 0)):
    """``conv3d`` with the named weight, read as [O, I, kT, kH, kW] (a 2D
    weight has kT 1, a 1D weight kH = kW = 1)."""
    w = ctx.w(f"{name}.weight")
    if w.dim() == 4:
        w = w[:, :, None]
    elif w.dim() == 3:
        w = w[..., None, None]
    return F.conv3d(ctx.q(x), ctx.q(w), ctx.w(f"{name}.bias"), stride, padding)


def causal_conv(ctx, st, name, x, offset: int = 0, stride: int = 1):
    """A causal conv with a k-frame kernel: k - stride earlier frames in
    front, spatial zero pad k // 2."""
    w = ctx.p[f"{name}.weight"]
    kt = w.shape[2]
    ks = w.shape[3] if w.dim() == 5 else 1
    full = _front(st, name, x, kt - stride, ctx.spec.pad_mode, offset)
    return conv(ctx, name, full, (stride, 1, 1), (0, ks // 2, ks // 2))


def spatial_block(ctx, name, x):
    h = conv(ctx, f"{name}.conv1", silu(layer_norm(ctx, f"{name}.norm1", x)),
             padding=(0, 1, 1))
    h = conv(ctx, f"{name}.conv2", silu(layer_norm(ctx, f"{name}.norm2", h)),
             padding=(0, 1, 1))
    if f"{name}.nin_shortcut.weight" in ctx.p:
        x = conv(ctx, f"{name}.nin_shortcut", x)
    return x + h


def temporal_block(ctx, st, name, x, offset: int = 0):
    h = causal_conv(ctx, st, f"{name}.conv1.conv",
                    silu(layer_norm(ctx, f"{name}.norm1", x)), offset)
    h = causal_conv(ctx, st, f"{name}.conv2.conv",
                    silu(layer_norm(ctx, f"{name}.norm2", h)), offset)
    return x + h


def block_3d(ctx, st, name, x, offset: int = 0):
    h = causal_conv(ctx, st, f"{name}.conv1.conv",
                    silu(layer_norm(ctx, f"{name}.norm1", x)), offset)
    h = causal_conv(ctx, st, f"{name}.conv2.conv",
                    silu(layer_norm(ctx, f"{name}.norm2", h)), offset)
    return x + h


def attention(ctx, name, x):
    """Single-head self-attention over the positions of each frame."""
    b, c, t, hh, ww = x.shape
    h = layer_norm(ctx, f"{name}.norm", x)
    q, k, v = (conv(ctx, f"{name}.{m}.conv", h) for m in ("q", "k", "v"))

    def frames(a):  # [B, C, T, H, W] -> [B*T, HW, C]
        return a.permute(0, 2, 3, 4, 1).reshape(b * t, hh * ww, c)

    q, k, v = frames(q), frames(k), frames(v)
    att = torch.softmax(ctx.q(q) @ ctx.q(k).transpose(1, 2) / math.sqrt(c), dim=-1)
    o = (ctx.q(att) @ ctx.q(v)).reshape(b, t, hh, ww, c).permute(0, 4, 1, 2, 3)
    return x + conv(ctx, f"{name}.proj_out.conv", o)


def mid(ctx, st, name, x, offset: int = 0):
    x = block_3d(ctx, st, f"{name}.block_1", x, offset)
    x = attention(ctx, f"{name}.attn_1", x)
    return block_3d(ctx, st, f"{name}.block_2", x, offset)


def spatial_down(ctx, name, x):
    """Zero pad one row below and one column right, 3x3 conv, stride 2."""
    return conv(ctx, f"{name}.conv", F.pad(x, (0, 1, 0, 1)), stride=(1, 2, 2))


def time_down(ctx, st, name, x):
    """a * avgpool(3, stride 2) + (1 - a) * causal conv(stride 2), a =
    sigmoid(mix_factor); both read one earlier frame."""
    a = torch.sigmoid(ctx.w(f"{name}.mix_factor"))
    pooled = F.avg_pool3d(_front(st, f"{name}.pool", x, 1, ctx.spec.pad_mode),
                          (3, 1, 1), (2, 1, 1))
    return a * pooled + (1 - a) * causal_conv(ctx, st, f"{name}.conv.conv", x, stride=2)


def spatial_up(ctx, name, x):
    """Nearest 2x in H and W, then a 3x3 conv."""
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    return conv(ctx, f"{name}.conv", x, padding=(0, 1, 1))


def _linear_up2x(x):
    """Linear 2x in time, align_corners False, edges clamped."""
    return F.interpolate(x, scale_factor=(2, 1, 1), mode="trilinear", align_corners=False)


def time_up(ctx, st, name, x, ntu: int, offset: int = 0):
    """a * up + (1 - a) * causal conv(up), a = sigmoid(mix_factor). v1.0:
    nearest (each frame twice). v1.1: linear, the first ``ntu`` frames of
    a clip apart from the rest; on a stream a later chunk interpolates
    ``[ntu cached frames | x]`` and drops the cached frames' outputs."""
    a = torch.sigmoid(ctx.w(f"{name}.mix_factor"))
    if not ctx.spec.trilinear:
        up = x.repeat_interleave(2, dim=2)
    elif st is not None and not st.first:
        xc = torch.cat([st.old[name], x], dim=2)
        st.new[name] = xc[:, :, -2 * ntu:-ntu].clone()
        up = _linear_up2x(xc)[:, :, 2 * ntu:]
    else:
        if st is not None:
            st.new[name] = x[:, :, -ntu:].clone()
        up = _linear_up2x(x[:, :, :ntu])
        if x.shape[2] > ntu:
            up = torch.cat([up, _linear_up2x(x[:, :, ntu:])], dim=2)
    return a * up + (1 - a) * causal_conv(ctx, st, f"{name}.conv.conv", up, offset)


def pad_input(spec: Spec, x):
    """The clip's front pad before encoding: v1.0 ``tdf - 1`` frames when
    T is not a multiple of ``tdf``, v1.1 up to the next multiple."""
    t = x.shape[2]
    if t % spec.tdf == 0:
        return x
    n = spec.tdf - t % spec.tdf if spec.variant == "v1_1" else spec.tdf - 1
    return _pad_front(x, n, "replicate" if spec.init_pad_mode == "replicate" else "zero")


def encode_raw(ctx: Ctx, x, st: Optional[Stream] = None):
    """[B, 3, T, H, W] (padded) -> posterior parameters [B, 2Cz, T/tdf, ...]."""
    spec = ctx.spec
    h = causal_conv(ctx, st, "encoder.conv_in.conv", x)
    for i in range(len(spec.ch_mult)):
        for j in range(spec.num_res_blocks):
            h = spatial_block(ctx, f"encoder.down.{i}.block.{j}", h)
            h = temporal_block(ctx, st, f"encoder.down_temporal.{i}.block.{j}", h)
        if i in spec.spatial_ds:
            h = spatial_down(ctx, f"encoder.down.{i}.downsample", h)
            if i in spec.tempo_ds:
                h = time_down(ctx, st, f"encoder.down_temporal.{i}.downsample", h)
    h = mid(ctx, st, "encoder.mid", h)
    return causal_conv(ctx, st, "encoder.conv_out.conv",
                       silu(layer_norm(ctx, "encoder.norm_out", h)))


def mode(spec: Spec, params):
    """The KL posterior's mode: its mean channels."""
    return params[:, :spec.z_channels]


def stage_offsets(spec: Spec):
    """The overlapped decode's cache offset of each decoder stage: the
    temporal blocks of a level its frames per latent frame, a temporal
    upsample's conv twice that; the mid stack 1, the output conv the last."""
    cur, level, up = 1, {}, {}
    for i in reversed(range(len(spec.ch_mult))):
        level[i] = cur
        if i in spec.tempo_us:
            up[i] = 2 * cur
            cur *= 2
    return level, up, cur


def decode(ctx: Ctx, z, st: Optional[Stream] = None):
    """[B, Cz, T', H', W'] -> [B, 3, tdf * T', H, W], before the v1.0 crop."""
    spec = ctx.spec
    level_off, up_off, out_off = stage_offsets(spec)
    h = causal_conv(ctx, st, "decoder.conv_in.conv", z, 1)
    h = mid(ctx, st, "decoder.mid", h, 1)
    ntu = 1
    for i in reversed(range(len(spec.ch_mult))):
        for j in range(spec.num_res_blocks + 1):
            h = spatial_block(ctx, f"decoder.up.{i}.block.{j}", h)
            h = temporal_block(ctx, st, f"decoder.up_temporal.{i}.block.{j}", h,
                               level_off[i])
        if i in spec.spatial_us:
            h = spatial_up(ctx, f"decoder.up.{i}.upsample", h)
            if i in spec.tempo_us:
                h = time_up(ctx, st, f"decoder.up_temporal.{i}.upsample", h, ntu,
                            up_off[i])
                ntu *= 2
    return causal_conv(ctx, st, "decoder.conv_out.conv",
                       silu(layer_norm(ctx, "decoder.norm_out", h)), out_off)


def _chunks(n: int, size: int):
    return [(s, min(n, s + size)) for s in range(0, n, size)]


@torch.no_grad()
def forward(ctx: Ctx, x, chunk_latents: Optional[int] = None):
    """(z, x_rec) of a whole clip x [B, 3, T, H, W]: encode, the posterior's
    mode, decode, v1.0's crop, at most T frames. With ``chunk_latents`` the clip runs as
    a stream of chunks of that many latent frames, which gives the same
    values with the memory of one chunk."""
    spec = ctx.spec
    t = x.shape[2]
    xp = pad_input(spec, x)
    if chunk_latents is not None and spec.trilinear:
        raise ValueError("a linear upsample reads the next frame: chunks of a "
                         "v1.1 clip do not give the whole clip's values")
    if chunk_latents is None:
        z = mode(spec, encode_raw(ctx, xp))
        dec = decode(ctx, z)
    else:
        zs, old = [], None
        for s, e in _chunks(xp.shape[2] // spec.tdf, chunk_latents):
            st = Stream(old)
            zs.append(mode(spec, encode_raw(ctx, xp[:, :, s * spec.tdf:e * spec.tdf], st)))
            old = st.new
        z = torch.cat(zs, dim=2)
        decs, old = [], None
        for s, e in _chunks(z.shape[2], chunk_latents):
            st = Stream(old)
            decs.append(decode(ctx, z[:, :, s:e], st))
            old = st.new
        dec = torch.cat(decs, dim=2)
    if spec.variant == "v1_0":  # v1.0's decoder drops its first tdf - 1 frames
        dec = dec[:, :, spec.tdf - 1:]
    return z, dec[:, :, -t:]


# -- the tiled (chunked, overlapped) schedule of the v1.1 model -------------

@torch.no_grad()
def encode_chunk(ctx: Ctx, x, old: Optional[dict]):
    """One step of the encoder stream: x [B, 3, t, H, W] is a clip's first
    chunk when ``old`` is None (padded as a clip), else the chunk after the
    one that returned ``old``. Returns (z, cache for the next chunk)."""
    st = Stream(old)
    if old is None:
        x = pad_input(ctx.spec, x)
    z = mode(ctx.spec, encode_raw(ctx, x, st))
    return z, st.new


@torch.no_grad()
def forward_tiled(ctx: Ctx, x, t_chunk_enc: int = 16, overlap: bool = True):
    """(z, x_rec) of the published tiled v1.1 forward: the encoder over frame
    0, then ``t_chunk_enc`` frames at a time; the decoder over latent frame
    0, then ``t_chunk_enc // tdf`` at a time, each chunk but the last with
    one latent frame of look-ahead whose ``tdf`` frames are dropped, the
    caches taken at each stage's offset; the output cropped to T frames."""
    spec = ctx.spec
    if spec.variant != "v1_1":
        raise ValueError("the published tiled forward is the v1.1 model's")
    zs, old = [], None
    for s, e in chunk_bounds(x.shape[2], t_chunk_enc):
        z, old = encode_chunk(ctx, x[:, :, s:e], old)
        zs.append(z)
    z = torch.cat(zs, dim=2)
    t_lat = z.shape[2]
    outs, old = [], None
    for s, e in chunk_bounds(t_lat, t_chunk_enc // spec.tdf):
        ahead = overlap and e + 1 <= t_lat
        st = Stream(old, offsets=overlap)
        dec = decode(ctx, z[:, :, s:e + 1] if ahead else z[:, :, s:e], st)
        old = st.new
        outs.append(dec[:, :, :dec.shape[2] - spec.tdf] if ahead else dec)
    return z, torch.cat(outs, dim=2)[:, :, -x.shape[2]:]


# -- the frozen kernel calls and the model's FLOP ----------------------------

def _calls(spec: Spec, shape, entry: str, first: bool, t_chunk_enc: int) -> Counter:
    """Kernel calls of one request of ``shape`` [B, 3, T, H, W] with the
    kernels on, by (kernel, call key) as ``work.work`` keys them: a frozen
    copy of ``chip_smoke.model_calls`` (the walk of the encoder and
    decoder, or the tiled schedule), with the encoder stream's single
    chunk added. ``entry``: ``forward`` (non-tiled: B at every temporal
    resblock, key (shape, mode)), ``forward_tiled`` (the overlapped chunk
    loop: F, key (shape, first_chunk, offset)) or ``encode_chunk`` (one
    encoder chunk of T frames, the stream's first when ``first``). A at
    every spatial resblock (N, H, W, Cin, C), C at every spatial upsample,
    at every temporal upsample E (v1.0) or J and K (v1.1: J keyed (shape,
    the frames interpolated apart, a later tiled chunk's cached front), K
    by the doubled shape), D on the decoder's last activations (tiled:
    with the 2 cached frames)."""
    from vtbench.reference.work import chunk_schedule

    mode = "replicate" if spec.variant == "v1_1" else "zero"
    ch, mult, nrb, tdf = spec.ch, spec.ch_mult, spec.num_res_blocks, spec.tdf
    n = len(mult)
    b, _, t, size, _ = shape
    stream = entry != "forward"
    calls = Counter()

    def temporal(f, s, c, first_chunk, off):
        x = (b, f, s, s, c)
        if stream:
            calls["fused_temporal_resblock_stream", (x, first_chunk, off)] += 1
        else:
            calls["fused_temporal_resblock", (x, mode)] += 1

    def encode(f, first_chunk):
        s, c = size, ch
        for i in range(n):
            for _ in range(nrb):
                calls["fused_spatial_resblock", (b * f, s, s, c, ch * mult[i])] += 1
                c = ch * mult[i]
                temporal(f, s, c, first_chunk, 0)
            if i in spec.spatial_ds:
                s //= 2
                f //= 2 if i in spec.tempo_ds else 1
        return f, s

    def decode(f, s, first_chunk):
        c, cur, offs, ntu = ch * mult[-1], 1, {}, 1
        for i in reversed(range(n)):
            offs[i] = cur
            cur *= 2 if i in spec.tempo_us else 1
        for i in reversed(range(n)):
            for _ in range(nrb + 1):
                calls["fused_spatial_resblock", (b * f, s, s, c, ch * mult[i])] += 1
                c = ch * mult[i]
                temporal(f, s, c, first_chunk, offs[i])
            if i in spec.spatial_us:
                calls["subpixel_interleave", (b * f, s, s, c)] += 1
                s *= 2
                if i in spec.tempo_us:
                    if spec.variant == "v1_0":
                        calls["parity_up2x_fused", ((b, f, s, s, c), mode)] += 1
                    else:
                        later = stream and not first_chunk
                        calls["temporal_linear_up2x",
                              ((b, f, s, s, c), 0 if later else ntu, later)] += 1
                        calls["linear_blend", (b, 2 * f, s, s, c)] += 1
                    f *= 2
                    ntu *= 2
        frames = f + 2 if stream else f
        calls["decoder_tail_rgb", ((b, frames, s, s, c), mode)] += 1

    if entry == "encode_chunk":
        if first:
            t = -(-t // tdf) * tdf
        encode(t, first)
        return calls
    if entry == "forward":
        if spec.variant == "v1_0" and t % tdf:
            t += tdf - 1
        elif spec.variant == "v1_1":
            t = -(-t // tdf) * tdf
        decode(*encode(t, True), True)
        return calls
    if entry != "forward_tiled":
        raise ValueError(f"unknown entry {entry!r}")
    enc, dec = chunk_schedule(t, tdf, t_chunk_enc)
    lat = [encode(f, i == 0) for i, f in enumerate(enc)][0][1]
    for i, f in enumerate(dec):
        decode(f, lat, i == 0)
    return calls


# The share of an upsample's counted FLOP that its function needs. The
# reference convolves the doubled tensor, as the published model does: a
# spatial upsample's 3x3 conv on the nearest-doubled frame is four 2x2
# convs of the input frame, one for each output parity (4/9 of it); a
# temporal upsample's causal 3-frame conv on the doubled (nearest or
# linear) frames is a blend of the three base convs of each input frame
# (1/2 of it), as kernel E computes it.
FUNCTION_SHARE = {"spatial_up": 4 / 9, "time_up": 1 / 2}


@contextmanager
def _function_flops(counted: dict):
    """Count each upsample of the reference apart: ``counted[name]`` gets
    the FLOP its calls were counted at."""
    from torch.utils.flop_counter import FlopCounterMode

    scope = globals()
    saved = {name: scope[name] for name in FUNCTION_SHARE}

    def apart(name, fn):
        def run(*args, **kwargs):
            with FlopCounterMode(display=False) as c:
                out = fn(*args, **kwargs)
            counted[name] = counted.get(name, 0) + c.get_total_flops()
            return out
        return run

    try:
        for name, fn in saved.items():
            scope[name] = apart(name, fn)
        yield
    finally:
        scope.update(saved)


def _flops(spec: Spec, shape, entry: str, first: bool, t_chunk_enc: int) -> float:
    """FLOP of the model's function for one request, counted by
    ``torch.utils.flop_counter`` over the reference on the meta device
    (every convolution and matrix product), with the upsamples' convs
    counted as their function needs them (``FUNCTION_SHARE``), as
    ``work.work`` counts kernel E."""
    from torch.utils.flop_counter import FlopCounterMode

    params = {k: torch.empty(s, device="meta") for k, s in param_shapes(spec).items()}
    ctx = Ctx(params, spec)
    x = torch.empty(shape, device="meta")
    old = None
    if entry == "encode_chunk" and not first:  # the cache of a first chunk
        _, old = encode_chunk(ctx, x[:, :, :1], None)
    counted = {}
    with _function_flops(counted), FlopCounterMode(display=False) as counter:
        if entry == "forward":
            forward(ctx, x)
        elif entry == "forward_tiled":
            forward_tiled(ctx, x, t_chunk_enc)
        elif entry == "encode_chunk":
            encode_chunk(ctx, x, old)
        else:
            raise ValueError(f"unknown entry {entry!r}")
    total = counter.get_total_flops()
    for name, flops in counted.items():
        total -= (1 - FUNCTION_SHARE[name]) * flops
    return float(total)


# -- the contract: the names the harness reads through the configuration ----
# (``harness.CONTRACT``; vtbench/README.md says what each one is);
# ``read_config`` is above

PROGRAM_OPTIONS = {"fused": True}
# the parameters drawn normal, by the end of their name: (mean, scale)
NORMAL = {"norm.weight": (1.0, 0.1), "norm.bias": (0.0, 0.1), "mix_factor": (2.0, 0.5)}


def weights(spec: Spec, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} from ``seed``."""
    return W.state_dict(param_shapes(spec), seed, device, NORMAL)


def load(tok, params: dict, traffic: dict) -> None:
    """The engine's core takes the reference layout as its state dict; a
    tiled traffic sets the engine's chunking."""
    tok.core.load_state_dict(params, strict=True)
    tiling = traffic.get("tiling")
    if tiling:
        tok.use_tiling = True
        tok.use_overlap = tiling["use_overlap"]
        tok.t_chunk_enc = tiling["t_chunk_enc"]
        tok.t_chunk_dec = tiling["t_chunk_enc"] // tok.time_downsample_factor


def shapes(spec: Spec, traffic: dict, frames: int) -> list:
    """z's shape, and a forward's reconstruction's, for ``frames`` input
    frames of the traffic's clips."""
    b, c, _, h, w = traffic["clip"]
    down = 2 ** len(spec.spatial_ds)
    z = (b, spec.z_channels, -(-frames // spec.tdf), h // down, w // down)
    return [z] if traffic["entry"] == "encode_chunk" else [z, (b, c, frames, h, w)]


# the worst relative L2 of z and of a forward's reconstruction
NUMBERS = {"z_rel": output_rel_l2(0), "rec_rel": output_rel_l2(1)}


context = Ctx


def _answer_forward(ctx, x, traffic, state):
    return forward(ctx, x, traffic["check"].get("chunk_latents")), None


def _answer_forward_tiled(ctx, x, traffic, state):
    tiling = traffic["tiling"]
    return forward_tiled(ctx, x, tiling["t_chunk_enc"], tiling["use_overlap"]), None


def _answer_encode_chunk(ctx, x, traffic, state):
    z, state = encode_chunk(ctx, x, state)
    return (z,), state


ENTRIES = {"forward": _answer_forward, "forward_tiled": _answer_forward_tiled,
           "encode_chunk": _answer_encode_chunk}


def _t_chunk_enc(traffic: dict) -> int:
    return (traffic.get("tiling") or {}).get("t_chunk_enc", 16)


def kernel_calls(spec: Spec, traffic: dict, shape, first: bool) -> Counter:
    """The frozen kernel calls of one request of the traffic's entry over
    input ``shape`` (a stream's chunk: the stream's first when ``first``)."""
    return _calls(spec, shape, traffic["entry"], first, _t_chunk_enc(traffic))


def model_flops(spec: Spec, traffic: dict, shape, first: bool) -> float:
    """The model function's FLOP for the same request."""
    return _flops(spec, shape, traffic["entry"], first, _t_chunk_enc(traffic))


def _answer_altered(tok):
    """The last latent frame of every z negated where the regularizer
    produces it (channels-last [B, T', H', W', C])."""
    core = tok.core
    regularize = core.regularize

    def altered(*a, **k):
        z, log = regularize(*a, **k)
        z = z.clone()
        z[:, -1] = -z[:, -1]
        return z, log

    core.regularize = altered


def _state_unchanged(tok):
    """Every chunk step after the first returns the cache it was given."""
    core = tok.core
    encode_raw, decode = core.encode_raw, core.decode

    def enc(x, fused=False, streaming=False, first_chunk=True, cache=None):
        out = encode_raw(x, fused, streaming, first_chunk, cache)
        if streaming and cache is not None:
            return out[0], cache
        return out

    def dec(z, *a, streaming=False, cache=None, **k):
        out = decode(z, *a, streaming=streaming, cache=cache, **k)
        if streaming and cache is not None:
            return out[0], cache
        return out

    core.encode_raw, core.decode = enc, dec


def faults(traffic: dict) -> dict:
    """An answer altered where it is produced, in every traffic; a step
    that returns its state unchanged, where state is carried between
    chunks (the tiled forward and the stream). A batch of one on one chip
    cannot leave out half of a batch nor an exchange between chips."""
    out = {"answer": _answer_altered}
    if traffic["entry"] != "forward":
        out["state"] = _state_unchanged
    return out


def tiny(config: dict, ch: int = 32) -> dict:
    """The configuration at the CPU tests' width: ``ch`` 32, the published
    topology and factors kept."""
    cfg = json.loads(json.dumps(config))
    for k in ("encoder_config", "decoder_config"):
        cfg["model"]["params"][k]["params"]["ch"] = ch
    return cfg
