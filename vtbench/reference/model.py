"""Plain PyTorch reference of VidTok's causal KL tokenizers, v1.0 and v1.1.

It follows the published model (github.com/microsoft/VidTok,
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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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


def spec_of(config: dict) -> Spec:
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

def chunk_bounds(n: int, size: int):
    """[(0, 1), (1, 1 + size), ...]: the first frame alone, then ``size``
    frames at a time."""
    out = [(0, 1)]
    while out[-1][1] < n:
        out.append((out[-1][1], min(n, out[-1][1] + size)))
    return out


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
