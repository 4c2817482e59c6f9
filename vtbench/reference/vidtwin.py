"""Reference module of VidTwin, the structure/dynamics video VAE: the plain
PyTorch model, its seeded weights, its answers, its FLOP and the numbers a
run's check compares. A configuration file names it with
``"reference": "vidtwin"``; the harness reads the model through the names
of the contract section at the end of this file (``vtbench/README.md``).

The model follows the published one ("VidTwin: Video VAE with Decoupled
Structure and Dynamics", CVPR 2025; github.com/microsoft/VidTok,
``vidtwin/models/vidtwin_ae.py`` ``VidAutoEncoderQformerCompactSymVidVAE``,
``vidtwin/modules/st_transformer.py``, ``vidtwin/modules/qformer.py``) in its
plainest form, in float32, with the weights given as a state dict under
the published names (``encoder.blocks.3.attn_temp.qkv.weight``). It imports
nothing of the program it judges and takes nothing the program made.

* Encoder: a 1 x 16 x 16 patch conv, the 2-D sincos position embedding,
  ``depth`` blocks: attention over the positions of each frame, then
  attention over the frames of each position (causal; the 1-D sincos
  time embedding added in block 0 only), then a tanh-GELU MLP, each branch
  after a LayerNorm without weights modulated by the block's
  ``scale_shift_table`` and gated (both attention branches by
  ``gate_msa``). Output z ``[B, hidden, T', H', W']``.
* Structure: at each position a Q-Former (post-LN BERT layers, its query
  tokens self-attending, cross-attending the position's frames in every
  second layer from the first, an exact-GELU MLP) makes ``num_query``
  tokens, which a conv pyramid squeezes to the posterior; its mode is
  u_S ``[B, Fq, h, w, expect_ch]``.
* Dynamics: z (after strided convs under ``downsample_motion``) averaged
  over H and over W, one conv head, the posterior's mode: u_Dx
  ``[B, d, F, W']``, u_Dy ``[B, d, F, H']``.
* Decoder: u_S back up the pyramid and token-mixed to the frames, the
  motion latents embedded and broadcast over the other axis, the sum
  through the same transformer, the modulated linear head, unpatchify.

Departures from the published code: its ST attention runs through
flash-attn in bf16, here attention is written out in float32
(softmax(q k^T / sqrt(d)) v, the temporal one with the causal mask); the
2-D sincos grid is built as written upstream (``meshgrid(w, h)`` reshaped
to ``(2, 1, W', H')``, a transposition a square grid hides), in float64;
the Q-Former's text branch (its ``intermediate`` / ``output`` FFN) is not
built, since no text enters; the posteriors give their mode, never a
sample. Every operation is per sample, so :func:`forward` may run the
batch in blocks (``BATCH_BLOCK``) and give the same values.

``quant="fp8"`` rounds both operands of every convolution and matrix
product (the two products of each attention included) to float8 e4m3 with
one scale per tensor (its largest magnitude onto 448) before computing in
float32: the control that the benchmark's comparison has to reject.
``quant="bf16"`` rounds them to bfloat16 the same way: the reference's own
distance at the served precision, which the CPU tests bound the port by.

The weights (:func:`weights`) are drawn by ``weights.state_dict`` in float32
and scaled so that each layer keeps the scale of what it reads (``GAIN``):
every linear and conv weight uniform in +-sqrt(3 / fan_in) (variance
1 / fan_in, xavier's for a square layer), those of the glue's layers that a
ReLU follows in +-2 / sqrt(fan_in), every bias in +-1 / sqrt(fan_in) (the
zero-initialised ``final_layer.linear`` and ``attn_temp.proj`` included);
every LayerNorm scale 1 + 0.1 N(0, 1) and shift 0.1 N(0, 1); the query
tokens N(0, 1) (the Q-Former's first LayerNorm takes their scale away); the
modulation tables N(0, 0.3^2) (``NORMAL``). Why these scales: at
+-1/sqrt(fan_in) each ReLU layer of the glue halves the power it passes, the
latents' fields reach the decoder at a tenth of the position embedding and
x_rec hardly depends on them; at He's 2 / fan_in the motion fields reach
~10 times it, and the decoder's temporal attention, which reads the
unnormalised stream, saturates, so that on an H100 at the cell's size the
served bf16 put x_rec 0.04-0.18 from float32 against the float8 control's
0.20-0.35. The glue's 4 / (3 fan_in) lies between. Upstream starts the
tables at N(0, 1 / hidden), where the gated branches add little to the
stream and a block's fault hardly shows; at N(0, 0.3^2) each branch does
work and the decoder stays smooth (at N(0, 0.5^2) bf16 put x_rec 0.04-0.07
from float32 against the control's 0.17-0.20). On the CPU tests' tiny copy
each planted fault (``faults``) moves z or x_rec to 3.2 times its limit or
more, and the float8 control to 1.2 times or more.
"""

from __future__ import annotations

import copy
import math
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from vtbench.reference import weights as W
from vtbench.reference.compare import output_rel_l2

FP8_MAX = 448.0
ST_EPS = 1e-6       # the transformer's LayerNorms without weights
QFORMER_EPS = 1e-12  # the Q-Former's BERT LayerNorms
# samples a block of the float32 forward runs at once: a [32,3,16,224²]
# request needs a few GB of the card's 80 at once, so it runs whole
BATCH_BLOCK = 32


@dataclass(frozen=True)
class Transformer:
    """One factorized space-time transformer of the config."""

    input_size: Tuple[int, int, int]   # (T, H, W)
    in_channels: int
    patch: Tuple[int, int, int]
    hidden: int
    depth: int
    heads: int
    mlp: int
    causal: bool

    @property
    def grid(self) -> Tuple[int, int, int]:
        return tuple(-(-self.input_size[i] // self.patch[i]) for i in range(3))


@dataclass(frozen=True)
class Spec:
    """The sizes of a VidTwin configuration, from its ``model`` section."""

    enc: Transformer
    dec: Transformer
    queries: int
    q_hidden: int
    q_layers: int
    q_heads: int
    q_inter: int
    q_cross_every: int
    expect_ch: int
    d_dim: int
    init_ch: int
    cont_blocks: int
    motion_blocks: int
    downsample_motion: bool


_TARGETS = ("VidTwinVAE", "VidAutoEncoderQformerCompactSymVidVAE")


def _transformer(p: dict) -> Transformer:
    if p.get("temporal_group", False):
        raise ValueError("the reference models ungrouped temporal attention only")
    hidden = p.get("hidden_size", 768)
    return Transformer(tuple(p.get("input_size", (16, 224, 224))), p.get("in_channels", 3),
                       tuple(p.get("patch_size", (1, 16, 16))), hidden, p.get("depth", 16),
                       p.get("num_heads", 12), int(hidden * p.get("mlp_ratio", 4.0)),
                       p.get("temporal_casual", True))


def read_config(config: dict) -> Spec:
    """The :class:`Spec` of a config dict (``{"model": ...}`` or the model
    section); the shipped Gaussian VidTwin only, without content shuffling
    (a random permutation) and with both parts decoded."""
    model = config.get("model", config)
    if str(model.get("target", "")).rsplit(".", 1)[-1] not in _TARGETS:
        raise ValueError(f"the reference has no model for {model.get('target')!r}")
    p = model["params"]
    if p.get("shuffle_content", False) or p.get("partial_content_motion", "all") != "all":
        raise ValueError("the reference decodes structure and dynamics, unshuffled")
    q = (p.get("temporal_qformer_config") or {}).get("params") or {}
    return Spec(
        enc=_transformer(p["encoder_config"].get("params") or {}),
        dec=_transformer(p["decoder_config"].get("params") or {}),
        queries=q.get("num_query_tokens", 3), q_hidden=q.get("query_hidden_size", 64),
        q_layers=q.get("num_hidden_layers", 6), q_heads=q.get("num_attention_heads", 8),
        q_inter=q.get("intermediate_size", 768),
        q_cross_every=q.get("cross_attention_frequency", 2),
        expect_ch=p.get("expect_ch", 4), d_dim=p.get("d_dim", 16),
        init_ch=p.get("init_ch", 128), cont_blocks=p.get("cont_num_blocks", 2),
        motion_blocks=p.get("motion_num_blocks", 2),
        downsample_motion=p.get("downsample_motion", False))


# -- the parameters ---------------------------------------------------------

def _down(n: int, blocks: int) -> int:
    """A side after ``blocks`` 3x3 stride-2 convs with padding 1."""
    for _ in range(blocks):
        n = (n + 1) // 2
    return n


def param_shapes(spec: Spec) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the model, by its name in the published state
    dict, with its shape."""
    out: Dict[str, Tuple[int, ...]] = {}

    def layer(name, shape):
        out[f"{name}.weight"] = tuple(shape)
        out[f"{name}.bias"] = (shape[0],)

    def blocks(root, t: Transformer):
        c = t.hidden
        for i in range(t.depth):
            b = f"{root}.blocks.{i}"
            out[f"{b}.scale_shift_table"] = (6, c)
            for a in ("attn", "attn_temp"):
                layer(f"{b}.{a}.qkv", (3 * c, c))
                layer(f"{b}.{a}.proj", (c, c))
            layer(f"{b}.mlp.fc1", (t.mlp, c))
            layer(f"{b}.mlp.fc2", (c, t.mlp))

    e, d = spec.enc, spec.dec
    blocks("encoder", e)
    layer("encoder.x_embedder.proj", (e.hidden, e.in_channels) + e.patch)
    blocks("decoder", d)
    out["decoder.final_layer.scale_shift_table"] = (2, d.hidden)
    layer("decoder.final_layer.linear", (math.prod(d.patch) * d.in_channels, d.hidden))

    cq = spec.q_hidden
    out["temporal_qformer.query_embeds"] = (spec.queries, cq)
    layer("temporal_qformer.qformer.layernorm", (cq,))
    for i in range(spec.q_layers):
        base = f"temporal_qformer.qformer.encoder.layer.{i}"
        kinds = ["attention"] + (["crossattention"] if i % spec.q_cross_every == 0 else [])
        for kind in kinds:
            kv = e.hidden if kind == "crossattention" else cq
            layer(f"{base}.{kind}.attention.query", (cq, cq))
            layer(f"{base}.{kind}.attention.key", (cq, kv))
            layer(f"{base}.{kind}.attention.value", (cq, kv))
            layer(f"{base}.{kind}.output.dense", (cq, cq))
            layer(f"{base}.{kind}.output.LayerNorm", (cq,))
        layer(f"{base}.intermediate_query.dense", (spec.q_inter, cq))
        layer(f"{base}.output_query.dense", (cq, spec.q_inter))
        layer(f"{base}.output_query.LayerNorm", (cq,))

    ch = spec.init_ch
    layer("conv_in", (ch, cq, 3, 3))
    for j in range(spec.cont_blocks):
        layer(f"content_downsample_blocks.{2 * j}", (2 * ch, ch, 3, 3))
        ch *= 2
    layer("bottle_down", (2 * spec.expect_ch, ch, 3, 3))
    layer("bottle_up", (ch, spec.expect_ch, 3, 3))
    for j in range(spec.cont_blocks):
        layer(f"content_upsample_blocks.{3 * j}", (ch // 2, ch, 3, 3))
        ch //= 2
    layer("conv_out", (cq, ch, 3, 3))
    layer("cont_emb.0", (e.hidden, cq))
    layer("cont_emb.2", (e.grid[0], spec.queries, 1))

    c = e.hidden
    layer("motion_emb.0", (c, spec.d_dim))
    layer("motion_emb.2", (c, c))
    layer("motion_head", (2 * spec.d_dim, c, 3, 3))
    if spec.downsample_motion:
        for j in range(spec.motion_blocks):
            layer(f"downsample_motion_module.{2 * j}", (c, c, 3, 3))
        _, gh, gw = e.grid
        layer("up_motion.0", (gh, _down(gw, spec.motion_blocks)))
        layer("up_motion.2", (gh, gh))
    return out


# -- the arithmetic ---------------------------------------------------------

class Ctx:
    """The weights, the sizes and the arithmetic of one evaluation."""

    def __init__(self, params: Dict[str, torch.Tensor], spec: Spec, quant: str = "none"):
        if quant not in ("none", "bf16", "fp8"):
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
        if self.quant == "bf16":
            return t.to(torch.bfloat16).float()
        scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(ctx: Ctx, name: str, x):
    return F.linear(ctx.q(x), ctx.q(ctx.w(f"{name}.weight")), ctx.w(f"{name}.bias"))


def conv(ctx: Ctx, name: str, x, stride=1, padding=0):
    """A 1-, 2- or 3-D conv by the rank of the named weight."""
    w = ctx.w(f"{name}.weight")
    fn = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[w.dim()]
    return fn(ctx.q(x), ctx.q(w), ctx.w(f"{name}.bias"), stride, padding)


def layer_norm(ctx: Ctx, name: str, x):
    """The Q-Former's affine LayerNorm over the last axis (eps 1e-12)."""
    return F.layer_norm(x, x.shape[-1:], ctx.w(f"{name}.weight"), ctx.w(f"{name}.bias"),
                        QFORMER_EPS)


def modulate(x, shift, scale):
    """A LayerNorm without weights (eps 1e-6), scaled by 1 + scale and
    shifted."""
    return F.layer_norm(x, x.shape[-1:], eps=ST_EPS) * (1 + scale) + shift


def attend(ctx: Ctx, q, k, v, causal: bool = False):
    """softmax(q k^T / sqrt(d)) v over [..., n, d] heads, in float32; with
    ``causal`` query i sees keys 0..i."""
    s = ctx.q(q) @ ctx.q(k).transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        n, m = s.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return ctx.q(torch.softmax(s, dim=-1)) @ ctx.q(v)


def self_attention(ctx: Ctx, name: str, x, heads: int, causal: bool):
    """The transformer's multi-head attention over [N, n, C] sequences:
    one qkv projection, the output projection."""
    n, m, c = x.shape
    qkv = linear(ctx, f"{name}.qkv", x).reshape(n, m, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = attend(ctx, q, k, v, causal).transpose(1, 2).reshape(n, m, c)
    return linear(ctx, f"{name}.proj", o)


def sincos_1d(dim: int, pos):
    """[len(pos), dim] in float64: sin, then cos, of the positions over
    10000^(2i / dim)."""
    omega = 1.0 / 10000 ** (torch.arange(dim // 2, dtype=torch.float64) / (dim / 2.0))
    out = pos.reshape(-1, 1).double() * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_2d(dim: int, gh: int, gw: int):
    """[gh gw, dim]: the published grid, ``meshgrid(w, h)`` stacked and
    reshaped ``(2, 1, gw, gh)`` as written, its first half embedding
    grid[0], its second grid[1]."""
    h = torch.arange(gh, dtype=torch.float64)
    w = torch.arange(gw, dtype=torch.float64)
    grid = torch.stack(torch.meshgrid(w, h, indexing="xy")).reshape(2, 1, gw, gh)
    return torch.cat([sincos_1d(dim // 2, grid[0]), sincos_1d(dim // 2, grid[1])], dim=1)


def st_block(ctx: Ctx, name: str, x, t: Transformer, tpe=None):
    """One block over tokens [B, T', S, C]."""
    b, f, s, c = x.shape
    shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = ctx.w(f"{name}.scale_shift_table")
    h = modulate(x, shift_a, scale_a).reshape(b * f, s, c)
    x = x + gate_a * self_attention(ctx, f"{name}.attn", h, t.heads, False).reshape(b, f, s, c)
    h = x.transpose(1, 2).reshape(b * s, f, c)
    if tpe is not None:
        h = h + tpe
    h = self_attention(ctx, f"{name}.attn_temp", h, t.heads, t.causal)
    x = x + gate_a * h.reshape(b, s, f, c).transpose(1, 2)
    h = linear(ctx, f"{name}.mlp.fc1", modulate(x, shift_m, scale_m))
    h = linear(ctx, f"{name}.mlp.fc2", F.gelu(h, approximate="tanh"))
    return x + gate_m * h


def blocks(ctx: Ctx, root: str, t: Transformer, x):
    """Tokens [B, T', S, C] with the position embeddings through the blocks."""
    f, gh, gw = t.grid
    x = x + sincos_2d(t.hidden, gh, gw).float().to(x.device)
    tpe = sincos_1d(t.hidden, torch.arange(f)).float().to(x.device)
    for i in range(t.depth):
        x = st_block(ctx, f"{root}.blocks.{i}", x, t, tpe if i == 0 else None)
    return x


def encoder(ctx: Ctx, x):
    """Clip [B, C, T, H, W] -> z [B, hidden, T', H', W']; the clip is
    zero-padded at the end of T, H and W to whole patches."""
    t = ctx.spec.enc
    pads = [(-x.shape[2 + i]) % t.patch[i] for i in range(3)]
    x = F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0]))
    z = conv(ctx, "encoder.x_embedder.proj", x, stride=t.patch)   # [B, C, T', H', W']
    b, c, f, gh, gw = z.shape
    h = blocks(ctx, "encoder", t, z.flatten(2).transpose(1, 2).reshape(b, f, gh * gw, c))
    return h.reshape(b, f * gh * gw, c).transpose(1, 2).reshape(b, c, f, gh, gw)


def bert_attention(ctx: Ctx, name: str, x, kv):
    """Post-LN attention: LN(dense(attn(x, kv)) + x), q from x, k and v
    from kv."""
    heads = ctx.spec.q_heads
    b, n, c = x.shape

    def split(t):
        return t.reshape(b, t.shape[1], heads, c // heads).transpose(1, 2)

    q = split(linear(ctx, f"{name}.attention.query", x))
    k = split(linear(ctx, f"{name}.attention.key", kv))
    v = split(linear(ctx, f"{name}.attention.value", kv))
    o = attend(ctx, q, k, v).transpose(1, 2).reshape(b, n, c)
    return layer_norm(ctx, f"{name}.output.LayerNorm",
                      linear(ctx, f"{name}.output.dense", o) + x)


def qformer(ctx: Ctx, states):
    """[N, L, hidden] encoder states -> [N, num_query, q_hidden]."""
    spec = ctx.spec
    root = "temporal_qformer.qformer"
    q = ctx.w("temporal_qformer.query_embeds")
    x = layer_norm(ctx, f"{root}.layernorm", q[None].expand(states.shape[0], -1, -1))
    for i in range(spec.q_layers):
        base = f"{root}.encoder.layer.{i}"
        x = bert_attention(ctx, f"{base}.attention", x, x)
        if i % spec.q_cross_every == 0:
            x = bert_attention(ctx, f"{base}.crossattention", x, states)
        h = F.gelu(linear(ctx, f"{base}.intermediate_query.dense", x))
        x = layer_norm(ctx, f"{base}.output_query.LayerNorm",
                       linear(ctx, f"{base}.output_query.dense", h) + x)
    return x


def structure(ctx: Ctx, z):
    """z [B, C, F, H', W'] -> u_S [B, Fq, h, w, expect_ch]: the Q-Former
    over each position's frames, the pyramid down, the posterior's mode
    (its mean channels)."""
    spec = ctx.spec
    b, c, f, hh, ww = z.shape
    zc = qformer(ctx, z.permute(0, 3, 4, 2, 1).reshape(b * hh * ww, f, c))
    fq, cq = zc.shape[1:]
    h = zc.reshape(b, hh, ww, fq, cq).permute(0, 3, 4, 1, 2).reshape(b * fq, cq, hh, ww)
    h = conv(ctx, "conv_in", h, padding=1)
    for j in range(spec.cont_blocks):
        h = F.relu(conv(ctx, f"content_downsample_blocks.{2 * j}", h, stride=2, padding=1))
    h = conv(ctx, "bottle_down", h, padding=1)[:, :spec.expect_ch]
    return h.permute(0, 2, 3, 1).reshape((b, fq) + tuple(h.shape[2:]) + (spec.expect_ch,))


def dynamics(ctx: Ctx, z):
    """z [B, C, F, H', W'] -> (u_Dx [B, d, F, W'], u_Dy [B, d, F, H']): the
    strided convs, the means over H and over W, the head, the posteriors'
    modes."""
    spec = ctx.spec
    b, c, f, hh, ww = z.shape
    if spec.downsample_motion:
        h = z.transpose(1, 2).reshape(b * f, c, hh, ww)
        for j in range(spec.motion_blocks):
            h = F.relu(conv(ctx, f"downsample_motion_module.{2 * j}", h, stride=2, padding=1))
        z = h.reshape(b, f, c, h.shape[2], h.shape[3]).transpose(1, 2)
    d = spec.d_dim
    u_dx = conv(ctx, "motion_head", z.mean(3), padding=1)[:, :d]
    u_dy = conv(ctx, "motion_head", z.mean(4), padding=1)[:, :d]
    return u_dx, u_dy


@torch.no_grad()
def encode(ctx: Ctx, x):
    """(z, u_S, u_Dx, u_Dy) of a clip x [B, C, T, H, W]."""
    z = encoder(ctx, x)
    return (z, structure(ctx, z)) + dynamics(ctx, z)


def content_field(ctx: Ctx, u_s):
    """u_S [B, Fq, h, w, c] -> [B, F, H', W', hidden]: the pyramid up
    (nearest 2x after each up conv), a centre crop, the token mix from the
    queries to the frames."""
    spec = ctx.spec
    f, hh, ww = spec.enc.grid
    b, fq = u_s.shape[:2]
    h = F.relu(conv(ctx, "bottle_up", u_s.flatten(0, 1).permute(0, 3, 1, 2), padding=1))
    for j in range(spec.cont_blocks):
        h = F.relu(conv(ctx, f"content_upsample_blocks.{3 * j}", h, padding=1))
        h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    h = conv(ctx, "conv_out", h, padding=1)
    if h.shape[2] > hh:
        top = (h.shape[2] - hh) // 2
        h = h[:, :, top:top + hh, top:top + ww]
    cq = h.shape[1]
    h = h.reshape(b, fq, cq, hh, ww).permute(0, 3, 4, 1, 2).reshape(b * hh * ww, fq, cq)
    h = F.relu(conv(ctx, "cont_emb.2", F.relu(linear(ctx, "cont_emb.0", h))))
    return h.reshape(b, hh, ww, f, -1).permute(0, 3, 1, 2, 4)


def motion_field(ctx: Ctx, u):
    """A motion latent [B, d, F, S] -> [B, F, S', hidden]: the embedding,
    then, under ``downsample_motion``, the mix back up to the grid's side."""
    v = F.relu(linear(ctx, "motion_emb.0", u.permute(0, 2, 3, 1)))
    v = F.relu(linear(ctx, "motion_emb.2", v))
    if ctx.spec.downsample_motion:
        v = F.relu(linear(ctx, "up_motion.0", v.transpose(2, 3)))
        v = F.relu(linear(ctx, "up_motion.2", v)).transpose(2, 3)
    return v


def decoder(ctx: Ctx, field):
    """[B, F, H', W', hidden] -> clip [B, C, T, H, W]."""
    t = ctx.spec.dec
    b, f, gh, gw, c = field.shape
    x = blocks(ctx, "decoder", t, field.reshape(b, f, gh * gw, c)).reshape(b, -1, c)
    shift, scale = ctx.w("decoder.final_layer.scale_shift_table")
    y = linear(ctx, "decoder.final_layer.linear", modulate(x, shift, scale))
    pt, ph, pw = t.patch
    y = y.reshape(b, f, gh, gw, pt, ph, pw, t.in_channels).permute(0, 7, 1, 4, 2, 5, 3, 6)
    return y.reshape(b, t.in_channels, f * pt, gh * ph, gw * pw)


@torch.no_grad()
def decode(ctx: Ctx, u_s, u_dx, u_dy):
    """The clip from u_S and the two motion latents: the content field plus
    u_Dx's field broadcast over H and u_Dy's over W."""
    vx = motion_field(ctx, u_dx)[:, :, None]
    vy = motion_field(ctx, u_dy)[:, :, :, None]
    return decoder(ctx, content_field(ctx, u_s) + vx + vy)


@torch.no_grad()
def forward(ctx: Ctx, x):
    """(z, x_rec) of clips x [B, C, T, H, W], ``BATCH_BLOCK`` samples at a
    time (the harness turns TF32 off around it)."""
    zs, recs = [], []
    for s in range(0, x.shape[0], BATCH_BLOCK):
        z, u_s, u_dx, u_dy = encode(ctx, x[s:s + BATCH_BLOCK])
        zs.append(z)
        recs.append(decode(ctx, u_s, u_dx, u_dy))
    return torch.cat(zs), torch.cat(recs)


# -- the contract: the names the harness reads through the configuration ----
# (``harness.CONTRACT``; vtbench/README.md says what each one is);
# ``read_config`` is above

PROGRAM_OPTIONS: dict = {}
# the parameters drawn normal, by the end of their name: (mean, scale); the
# modulation tables' and queries' scale is the module docstring's
NORMAL = {"scale_shift_table": (0.0, 0.3), "query_embeds": (0.0, 1.0),
          "LayerNorm.weight": (1.0, 0.1), "LayerNorm.bias": (0.0, 0.1),
          "layernorm.weight": (1.0, 0.1), "layernorm.bias": (0.0, 0.1)}


# the gain of the uniform weights (not their biases) over weights.state_dict's
# +-1/sqrt(fan_in), so that each layer keeps the scale of what it reads: a
# layer a ReLU follows sqrt(6), variance 2 / fan_in (He's), every other one
# sqrt(3), variance 1 / fan_in (xavier's for a square layer)
RELU_FOLLOWS = ("content_downsample_blocks.", "bottle_up.", "content_upsample_blocks.",
                "cont_emb.", "motion_emb.", "downsample_motion_module.", "up_motion.")
GAIN = {"relu": 2.0, "other": math.sqrt(3.0)}


def weights(spec: Spec, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} from ``seed``, the uniform
    weights scaled by their ``GAIN``."""
    params = W.state_dict(param_shapes(spec), seed, device, NORMAL)
    for k, v in params.items():
        if k.endswith(".weight") and not k.endswith(tuple(NORMAL)):
            v.mul_(GAIN["relu" if k.startswith(RELU_FOLLOWS) else "other"])
    return params


def load(tok, params: dict, traffic: dict) -> None:
    """The engine's model takes the published layout as its state dict."""
    tok.model.load_state_dict(params, strict=True)


def shapes(spec: Spec, traffic: dict, frames: int) -> list:
    """z's shape and the reconstruction's for ``frames`` input frames of
    the traffic's clips."""
    b, c, _, h, w = traffic["clip"]
    t = spec.enc
    z = (b, t.hidden, -(-frames // t.patch[0]), -(-h // t.patch[1]), -(-w // t.patch[2]))
    return [z, (b, c, frames, h, w)]


# the worst relative L2 of z (the encoder's tokens) and of the
# reconstruction, through which the three latents reach the check
NUMBERS = {"z_rel": output_rel_l2(0), "rec_rel": output_rel_l2(1)}


context = Ctx


def _answer_forward(ctx, x, traffic, state):
    return forward(ctx, x), None


ENTRIES = {"forward": _answer_forward}


def kernel_calls(spec: Spec, traffic: dict, shape, first: bool) -> Counter:
    """None: VidTwin runs no kernel of the port."""
    return Counter()


def model_flops(spec: Spec, traffic: dict, shape, first: bool) -> float:
    """The model function's FLOP for one request over input ``shape``:
    ``torch.utils.flop_counter`` over the reference on the meta device
    (every convolution and matrix product, the attention's two included)."""
    from torch.utils.flop_counter import FlopCounterMode

    if traffic["entry"] != "forward":
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    params = {k: torch.empty(s, device="meta") for k, s in param_shapes(spec).items()}
    x = torch.empty(shape, device="meta")
    with FlopCounterMode(display=False) as counter:
        forward(Ctx(params, spec), x)
    return float(counter.get_total_flops())


def _acausal(tok):
    """The encoder's temporal attention without its causal mask."""
    for block in tok.model.encoder.blocks:
        block.temporal_causal = False


def _axes_swapped(tok):
    """u_Dx and u_Dy swapped where the decoder takes them (the same shapes
    on a square grid)."""
    model = tok.model
    decode_ = model.decode

    def swapped(u_s, u_dx, u_dy, only_part=None):
        return decode_(u_s, u_dy, u_dx, only_part=only_part)

    model.decode = swapped


def _answer_altered(tok):
    """The last frame of z negated where the encoder produces it."""
    enc = tok.model.encoder
    forward_ = enc.forward

    def altered(*a, **k):
        z = forward_(*a, **k).clone()
        z[:, :, -1] = -z[:, :, -1]
        return z

    enc.forward = altered


def faults(traffic: dict) -> dict:
    """A temporal attention that sees later frames, the two dynamics
    latents on each other's axis, and an answer altered where it is
    produced. A whole request on one chip carries no state and no
    exchange between chips."""
    return {"causal": _acausal, "axes": _axes_swapped, "answer": _answer_altered}


def tiny(config: dict) -> dict:
    """The configuration at the CPU tests' size: width 64, depth 2, 4 heads,
    32x32 frames of its own clip length in 4x4 patches, so that the motion
    path's grid (4x4 after its strided conv) tells H from W and the
    latents reach x_rec; the Q-Former, pyramid and motion path as
    published."""
    cfg = copy.deepcopy(config)
    p = cfg["model"]["params"]
    for k in ("encoder_config", "decoder_config"):
        d = p[k]["params"]
        d.update(hidden_size=64, depth=2, num_heads=4, patch_size=[1, 4, 4],
                 input_size=[d.get("input_size", [16])[0], 32, 32])
    p["temporal_qformer_config"]["params"]["encoder_hidden_size"] = 64
    return cfg
