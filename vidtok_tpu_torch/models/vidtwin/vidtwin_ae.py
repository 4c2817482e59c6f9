"""VidTwin, the structure/dynamics video VAE
(``vidtok_tpu/models/vidtwin/vidtwin_ae.py``; reference
vidtwin/models/vidtwin_ae.py ``VidAutoEncoderQformerCompactSymVidVAE``,
the class of ``configs/vidtwin/``).

Shapes for the shipped 16 x 224² clip, patch 1 x 16², hidden 768:

* encode: ``z = STTEncoder(x)`` ``[B, 768, 16, 14, 14]``. Structure: per
  spatial position a temporal Q-Former sums the 16 frames' tokens into
  ``num_query`` 64-wide queries, which a conv bottleneck squeezes to a
  diagonal Gaussian: ``u_S`` ``[B, Fq, 7, 7, expect_ch]``. Dynamics: z
  (strided convs first under ``downsample_motion``) averaged over H and
  over W, one conv head, a Gaussian each: ``u_Dx``, ``u_Dy``
  ``[B, d_dim, F, S]``.
* decode: the structure latent up the bottleneck and token-mixed to
  ``[B, F, H', W', 768]``, the motion latents embedded and broadcast, the
  sum (or one part, ``only_part``) through ``STTDecoder``.

Latent layouts are JAX's engine's (``u_S`` channels-last); clips are
``[B, C, T, H, W]``. The glue convs run on NCHW maps. Randomness comes from
explicit ``torch.Generator``s: the posterior sample, ``shuffle_content``'s
per-sample frame permutations. ``kl_loss`` is ``sum(kl) / kl.shape[0]``
for each of the three posteriors (the structure posterior's first axis is
B), as in JAX. The structure pathway (``ContentPyramid``), the embedding
head (``EmbSeq``) and the glue's init (``reset_glue``) are shared with the
ablation ladder (``ablations.py``).

Spans (``utils/profiling.span``): ``vt.model.structure`` around
``content_tokens`` and ``content_field`` (the Q-Former's own
``vt.model.qformer`` inside the first), ``vt.model.dynamics`` around the
motion latents and their embedding, ``vt.model.regularize`` around each
posterior; the encoder's and decoder's are ``st_transformer.py``'s.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...modules.regularizers import DiagonalGaussian
from ...utils.profiling import span
from .qformer import QFormerInterface
from .st_transformer import (Conv1d, Conv2d, Linear, STTDecoder, STTEncoder, STTransformer,
                             reset_linear_)

# the ablation ladder's targets (``ablations.py``)
ABLATIONS = ("VidAutoEncoderQformer", "VidAutoEncoderQformerCompact",
             "VidAutoEncoderQformerCompactSym", "VidAutoEncoderQformerCompactSymDis")


def _down(n: int, blocks: int) -> int:
    """A side after ``blocks`` 3x3 stride-2 convs with padding 1."""
    for _ in range(blocks):
        n = (n + 1) // 2
    return n


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class EmbSeq(nn.Sequential):
    """The reference's embedding head ``nn.Sequential(Linear, ReLU,
    Conv1d(k=1), ReLU)`` over ``[B, tokens, C]``: a Linear on the features,
    then a learned mix of ``tokens_in`` tokens into ``tokens_out`` (JAX's
    ``Dense`` and ``TokenMix``). With ``mid`` it is the six-element
    ``Linear(c_in, hidden), ReLU, Linear(hidden, mid), ReLU, Conv1d,
    ReLU``; the indices (0, 2[, 4]) are the reference's state-dict keys."""

    def __init__(self, c_in: int, hidden: int, tokens_in: int, tokens_out: int,
                 mid: Optional[int] = None):
        layers = [Linear(c_in, hidden), nn.ReLU()]
        if mid is not None:
            layers += [Linear(hidden, mid), nn.ReLU()]
        super().__init__(*layers, Conv1d(tokens_in, tokens_out, 1), nn.ReLU())


def shuffle_frames(x, generator: torch.Generator, dim: int = 1):
    """Each sample's frames (axis ``dim``) in a permutation drawn from
    ``generator`` on x's device (``rand(B, T).argsort``)."""
    b, f = x.shape[0], x.shape[dim]
    perms = torch.rand((b, f), generator=generator, device=x.device).argsort(1)
    return torch.stack([xi.index_select(dim - 1, p) for xi, p in zip(x, perms)])


def reset_glue(model: nn.Module, generator=None) -> None:
    """A VidTwin model's ``reset_params``: its glue as flax inits it,
    kernels lecun normal and biases 0 (the transformers and Q-Formers reset
    themselves)."""
    for m in model.children():
        if isinstance(m, (STTransformer, QFormerInterface)):
            continue
        for sub in m.modules():
            if isinstance(sub, (Linear, Conv1d, Conv2d)):
                reset_linear_(sub, generator, "lecun")


class ContentPyramid:
    """The structure pathway that ``VidTwinVAE`` and the ablation
    ``VidTwinSym`` share (reference :892-900 and :1434-1470): a temporal
    Q-Former per spatial position, a Conv2d pyramid down to the latent
    and back up (nearest 2x after each up conv), a centre crop, and the
    ``cont_emb`` token mix from the ``num_query`` queries to the frames.
    Module names and ``nn.Sequential`` indices are the reference's."""

    def _build_content(self, init_ch: int, blocks: int, out_ch: int, in_ch: int) -> None:
        cq = self.temporal_qformer.query_hidden_size
        self.conv_in = Conv2d(cq, init_ch, 3, padding=1)
        ch, downs = init_ch, []
        for _ in range(blocks):
            downs += [Conv2d(ch, 2 * ch, 3, stride=2, padding=1), nn.ReLU()]
            ch *= 2
        self.content_downsample_blocks = nn.Sequential(*downs)
        self.bottle_down = Conv2d(ch, out_ch, 3, padding=1)
        self.bottle_up = Conv2d(in_ch, ch, 3, padding=1)
        ups = []
        for _ in range(blocks):
            ups += [Conv2d(ch, ch // 2, 3, padding=1), nn.ReLU(),
                    nn.Upsample(scale_factor=2, mode="nearest")]
            ch //= 2
        self.content_upsample_blocks = nn.Sequential(*ups)
        self.conv_out = Conv2d(ch, cq, 3, padding=1)
        self.cont_emb = EmbSeq(cq, self.encoder.hidden_size,
                               self.temporal_qformer.query_embeds.shape[0],
                               self.encoder.grid[0])

    def content_tokens(self, zl):
        """[B, F, H', W', C] -> the bottleneck's output ``[B, Fq, h, w,
        out_ch]`` (channels-last)."""
        with span("vt.model.structure"):
            b, f, hh, ww, c = zl.shape
            zc = self.temporal_qformer(zl.permute(0, 2, 3, 1, 4).reshape(b * hh * ww, f, c))
            fq, cq = zc.shape[1], zc.shape[2]
            zc = zc.reshape(b, hh, ww, fq, cq).permute(0, 3, 4, 1, 2).reshape(b * fq, cq, hh, ww)
            h = self.bottle_down(self.content_downsample_blocks(self.conv_in(zc)))
            return _nhwc(h).reshape((b, fq) + tuple(h.shape[2:]) + (h.shape[1],))

    def content_field(self, u_s):
        """u_S ``[B, Fq, h, w, c]`` -> ``[B, F, H', W', hidden]``."""
        with span("vt.model.structure"):
            f, hh, ww = self.encoder.grid
            b, fq = u_s.shape[0], u_s.shape[1]
            h = F.relu(self.bottle_up(_nchw(u_s.reshape((b * fq,) + tuple(u_s.shape[2:])))))
            zc = self.conv_out(self.content_upsample_blocks(h))  # [(B Fq), Cq, H, W]
            if zc.shape[2] > hh:
                border = (zc.shape[2] - hh) // 2
                zc = zc[:, :, border:border + hh, border:border + ww]
            cq = zc.shape[1]
            zc = zc.reshape(b, fq, cq, hh, ww).permute(0, 3, 4, 1, 2).reshape(b * hh * ww, fq, cq)
            hidden = self.encoder.hidden_size
            return self.cont_emb(zc).reshape(b, hh, ww, f, hidden).permute(0, 3, 1, 2, 4)


class VidTwinVAE(ContentPyramid, nn.Module):
    def __init__(self, encoder: STTEncoder, decoder: STTDecoder,
                 temporal_qformer: QFormerInterface, expect_ch: int = 4, d_dim: int = 16,
                 init_ch: int = 128, cont_num_blocks: int = 2, motion_num_blocks: int = 2,
                 downsample_motion: bool = False, sample: bool = True,
                 shuffle_content: bool = False, vae: bool = True,
                 partial_content_motion: str = "all"):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.temporal_qformer = temporal_qformer
        self.expect_ch = expect_ch
        self.d_dim = d_dim
        self.downsample_motion = downsample_motion
        self.sample = sample
        self.shuffle_content = shuffle_content
        self.vae = vae
        self.partial_content_motion = partial_content_motion
        hidden = encoder.hidden_size
        pn = self.patch_nums
        k = 2 if vae else 1
        # content bottleneck: Sequential indices as the reference's
        # (conv, ReLU) down and (conv, ReLU, 2x nearest) up
        self._build_content(init_ch, cont_num_blocks, k * expect_ch, expect_ch)
        # dynamics
        self.motion_emb = nn.Sequential(Linear(d_dim, hidden), nn.ReLU(),
                                        Linear(hidden, hidden), nn.ReLU())
        self.motion_head = Conv2d(hidden, k * d_dim, 3, padding=1)
        if downsample_motion:
            mods = []
            for _ in range(motion_num_blocks):
                mods += [Conv2d(hidden, hidden, 3, stride=2, padding=1), nn.ReLU()]
            self.downsample_motion_module = nn.Sequential(*mods)
            # one head for both axes: the reference assumes H' == W'
            self.up_motion = nn.Sequential(
                Linear(_down(pn[2], motion_num_blocks), pn[1]), nn.ReLU(),
                Linear(pn[1], pn[1]), nn.ReLU())

    reset_params = reset_glue

    @property
    def hidden_dim(self) -> int:
        return self.encoder.hidden_size

    @property
    def patch_nums(self) -> Tuple[int, int, int]:
        return self.encoder.grid

    # -- helpers ---------------------------------------------------------------

    def _regularize(self, params, sample: Optional[bool], generator):
        """Channels-last posterior parameters -> (latent, sum(kl) / batch)."""
        if not self.vae:
            return params, params.new_zeros((), dtype=torch.float32)
        with span("vt.model.regularize"):
            post = DiagonalGaussian(params)
            do_sample = self.sample if sample is None else sample
            z = post.sample(generator) if do_sample else post.mode()
            kl = post.kl()
            return z, kl.sum() / kl.shape[0]

    # -- encode ----------------------------------------------------------------

    def encode(self, x, sample: Optional[bool] = None, generator: torch.Generator = None):
        """x [B, C, T, H, W] -> (z [B, hidden, F, H', W'], u_S
        [B, Fq, h, w, expect_ch], u_Dx [B, d, F, W'], u_Dy [B, d, F, H'],
        reg_log)."""
        z = self.encoder(x)
        zl = z.permute(0, 2, 3, 4, 1)  # [B, F, H', W', C]
        z_q = shuffle_frames(zl, generator) if self.shuffle_content else zl
        u_s, kl_c = self._regularize(self.content_tokens(z_q), sample, generator)
        u_dx, u_dy, kl_x, kl_y = self._motion_latent(zl, sample, generator)
        return z, u_s, u_dx, u_dy, {"kl_loss": kl_c + kl_x + kl_y}

    def _motion_latent(self, zl, sample, generator):
        """[B, F, H', W', C] -> (u_Dx [B, d, F, W'], u_Dy [B, d, F, H'],
        their kls)."""
        with span("vt.model.dynamics"):
            b, f, hh, ww, c = zl.shape
            if self.downsample_motion:
                h = self.downsample_motion_module(_nchw(zl.reshape(b * f, hh, ww, c)))
                zl = _nhwc(h).reshape((b, f) + tuple(h.shape[2:]) + (c,))
            ux = _nchw(zl.mean(2))  # over H: [B, C, F, W']
            uy = _nchw(zl.mean(3))  # over W: [B, C, F, H']
            sx, kl_x = self._regularize(_nhwc(self.motion_head(ux)), sample, generator)
            sy, kl_y = self._regularize(_nhwc(self.motion_head(uy)), sample, generator)
            return _nchw(sx), _nchw(sy), kl_x, kl_y

    # -- decode ----------------------------------------------------------------

    def _motion_embed(self, u):
        return self.motion_emb(u.permute(0, 2, 3, 1))  # [B, F, S, C]

    def decode(self, u_s, u_dx, u_dy, only_part: Optional[str] = None):
        """u_S [B, Fq, h, w, expect_ch], u_Dx / u_Dy [B, d, F, S] -> clip
        [B, C, T, H, W]. ``only_part``: ``"content"``, ``"motion"`` or None
        (the model's ``partial_content_motion``)."""
        f, hh, ww = self.patch_nums
        b = u_s.shape[0]
        vt = self.content_field(u_s)

        with span("vt.model.dynamics"):
            vx = self._motion_embed(u_dx)  # [B, F, S, C]
            vy = self._motion_embed(u_dy)
            if self.downsample_motion:
                vx = self.up_motion(vx.transpose(2, 3)).transpose(2, 3)
                vy = self.up_motion(vy.transpose(2, 3)).transpose(2, 3)
        vx_b = vx[:, :, None]     # broadcast over H
        vy_b = vy[:, :, :, None]  # broadcast over W

        part = only_part or (None if self.partial_content_motion == "all"
                             else self.partial_content_motion)
        if part == "content":
            cm = vt
        elif part == "motion":
            cm = (vx_b + vy_b).expand(b, f, hh, ww, self.hidden_dim)
        else:
            cm = vt + vx_b + vy_b
        return self.decoder(cm.permute(0, 4, 1, 2, 3))

    def forward(self, x, sample: Optional[bool] = None, generator: torch.Generator = None):
        """(z, x_rec, reg_log, (u_S, u_Dx, u_Dy))."""
        z, u_s, u_dx, u_dy, reg_log = self.encode(x, sample, generator)
        dec = self.decode(u_s, u_dx, u_dy)
        return z, dec, reg_log, (u_s, u_dx, u_dy)


def reset_params_(model: nn.Module, generator: torch.Generator = None) -> None:
    """Initialize as ``vidtok_tpu`` does (its flax initializers: xavier
    uniform in the transformers, lecun normal elsewhere, zero
    ``final_layer.linear`` and ``attn_temp.proj``); drawn on the CPU from
    ``generator``, so every device gets the same weights."""
    for m in model.modules():
        if hasattr(m, "reset_params"):
            m.reset_params(generator)


def build_vidtwin_from_config(model_cfg: dict):
    """A reference VidTwin ``model:`` section (resolved) -> (model, meta):
    the shipped ``...CompactSymVidVAE`` (``VidTwinVAE`` and the reference's
    dotted path), the non-Gaussian ``...CompactSymVid`` (``vae=False``),
    and the ablation ladder (``ablations.py``) by its target class name,
    each with JAX's defaults for every key."""
    p = model_cfg.get("params", model_cfg)
    target = str(model_cfg.get("target", "")).rsplit(".", 1)[-1]
    enc = dict(p["encoder_config"].get("params") or {})
    dec = dict(p["decoder_config"].get("params") or {})

    def stt(cls, d):
        return cls(input_size=tuple(d.get("input_size", (16, 224, 224))),
                   in_channels=d.get("in_channels", 3),
                   patch_size=tuple(d.get("patch_size", (1, 16, 16))),
                   hidden_size=d.get("hidden_size", 768), depth=d.get("depth", 16),
                   num_heads=d.get("num_heads", 12), mlp_ratio=d.get("mlp_ratio", 4.0),
                   temporal_causal=d.get("temporal_casual", True),
                   temporal_group=d.get("temporal_group", False),
                   group_size=d.get("group_size", 1), drop_path=d.get("drop_path", 0.0))

    def qformer(key="temporal_qformer_config"):
        qf = dict((p.get(key) or {}).get("params") or {})
        return QFormerInterface(
            num_query_tokens=qf.get("num_query_tokens", 3),
            query_hidden_size=qf.get("query_hidden_size", 64),
            encoder_hidden_size=qf.get("encoder_hidden_size", 768),
            num_hidden_layers=qf.get("num_hidden_layers", 6),
            intermediate_size=qf.get("intermediate_size", 768),
            num_attention_heads=qf.get("num_attention_heads", 8))

    encoder, decoder = stt(STTEncoder, enc), stt(STTDecoder, dec)
    meta = {"kind": "vidtwin", "monitor": p.get("monitor")}
    if target in ABLATIONS:
        from . import ablations as A

        if target == "VidAutoEncoderQformer":
            return A.VidTwinQformer(encoder, decoder, qformer(),
                                    qformer("height_qformer_config"),
                                    qformer("width_qformer_config")), meta
        common = dict(retain_num_frames=p.get("retain_num_frames", True),
                      partial_content_motion=p.get("partial_content_motion", "all"),
                      shuffle_content=p.get("shuffle_content", False))
        if target == "VidAutoEncoderQformerCompact":
            return A.VidTwinCompact(
                encoder, decoder, qformer(), qformer("space_qformer_config"),
                temporal_down_dim=p.get("temporal_down_dim", 32),
                repeat_for_decoder=p.get("repeat_for_decoder", False), **common), meta
        return A.VidTwinSym(
            encoder, decoder, qformer(), qformer("space_qformer_config"),
            expect_ch=p.get("expect_ch", 4), init_ch=p.get("init_ch", 128),
            cont_num_blocks=p.get("cont_num_blocks", 2), dis=target.endswith("Dis"),
            shuffle_ratio=p.get("shuffle_content_ratio", 0.5), **common), meta
    reg = (p.get("regularizer_config") or {}).get("params") or {}
    model = VidTwinVAE(
        encoder, decoder, qformer(),
        expect_ch=p.get("expect_ch", 4), d_dim=p.get("d_dim", 16),
        init_ch=p.get("init_ch", 128), cont_num_blocks=p.get("cont_num_blocks", 2),
        motion_num_blocks=p.get("motion_num_blocks", 2),
        downsample_motion=p.get("downsample_motion", False),
        shuffle_content=p.get("shuffle_content", False),
        vae=target != "VidAutoEncoderQformerCompactSymVid",
        partial_content_motion=p.get("partial_content_motion", "all"),
        sample=reg.get("sample", True))
    return model, meta
