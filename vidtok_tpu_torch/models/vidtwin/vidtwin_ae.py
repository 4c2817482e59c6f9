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
B), as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...modules.regularizers import DiagonalGaussian
from .qformer import QFormerInterface
from .st_transformer import Conv1d, Conv2d, Linear, STTDecoder, STTEncoder, reset_linear_

# the ablation ladder's targets (vidtok_tpu/models/vidtwin/ablations.py)
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


class VidTwinVAE(nn.Module):
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
        cq = temporal_qformer.query_hidden_size
        pn = self.patch_nums
        k = 2 if vae else 1
        # content bottleneck: Sequential indices as the reference's
        # (conv, ReLU) down and (conv, ReLU, 2x nearest) up
        self.conv_in = Conv2d(cq, init_ch, 3, padding=1)
        ch, downs = init_ch, []
        for _ in range(cont_num_blocks):
            downs += [Conv2d(ch, 2 * ch, 3, stride=2, padding=1), nn.ReLU()]
            ch *= 2
        self.content_downsample_blocks = nn.Sequential(*downs)
        self.bottle_down = Conv2d(ch, k * expect_ch, 3, padding=1)
        self.bottle_up = Conv2d(expect_ch, ch, 3, padding=1)
        ups = []
        for _ in range(cont_num_blocks):
            ups += [Conv2d(ch, ch // 2, 3, padding=1), nn.ReLU(),
                    nn.Upsample(scale_factor=2, mode="nearest")]
            ch //= 2
        self.content_upsample_blocks = nn.Sequential(*ups)
        self.conv_out = Conv2d(ch, cq, 3, padding=1)
        num_query = temporal_qformer.query_embeds.shape[0]
        self.cont_emb = nn.Sequential(Linear(cq, hidden), nn.ReLU(),
                                      Conv1d(num_query, pn[0], 1), nn.ReLU())
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

    @property
    def hidden_dim(self) -> int:
        return self.encoder.hidden_size

    @property
    def patch_nums(self) -> Tuple[int, int, int]:
        return self.encoder.grid

    def reset_params(self, generator=None):
        """The glue as flax inits it: kernels lecun normal, biases 0."""
        for name, m in self.named_children():
            if name in ("encoder", "decoder", "temporal_qformer"):
                continue
            for sub in m.modules():
                if isinstance(sub, (Linear, Conv1d, Conv2d)):
                    reset_linear_(sub, generator, "lecun")

    # -- helpers ---------------------------------------------------------------

    def _regularize(self, params, sample: Optional[bool], generator):
        """Channels-last posterior parameters -> (latent, sum(kl) / batch)."""
        if not self.vae:
            return params, params.new_zeros((), dtype=torch.float32)
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
        b, f, hh, ww, c = zl.shape
        z_q = zl
        if self.shuffle_content:
            perms = torch.rand((b, f), generator=generator, device=z.device).argsort(1)
            z_q = zl[torch.arange(b, device=z.device)[:, None], perms]
        pre_q = z_q.permute(0, 2, 3, 1, 4).reshape(b * hh * ww, f, c)
        zc = self.temporal_qformer(pre_q)  # [(B H W), Fq, Cq]
        fq, cq = zc.shape[1], zc.shape[2]
        zc = zc.reshape(b, hh, ww, fq, cq).permute(0, 3, 4, 1, 2).reshape(b * fq, cq, hh, ww)
        h = self.bottle_down(self.content_downsample_blocks(self.conv_in(zc)))
        h = _nhwc(h).reshape((b, fq) + tuple(h.shape[2:]) + (h.shape[1],))
        u_s, kl_c = self._regularize(h, sample, generator)
        u_dx, u_dy, kl_x, kl_y = self._motion_latent(zl, sample, generator)
        return z, u_s, u_dx, u_dy, {"kl_loss": kl_c + kl_x + kl_y}

    def _motion_latent(self, zl, sample, generator):
        """[B, F, H', W', C] -> (u_Dx [B, d, F, W'], u_Dy [B, d, F, H'],
        their kls)."""
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
        hh, ww = self.patch_nums[1:]
        b, fq = u_s.shape[0], u_s.shape[1]
        h = F.relu(self.bottle_up(_nchw(u_s.reshape((b * fq,) + tuple(u_s.shape[2:])))))
        zc = self.conv_out(self.content_upsample_blocks(h))  # [(B Fq), Cq, H, W]
        if zc.shape[2] > hh:
            border = (zc.shape[2] - hh) // 2
            zc = zc[:, :, border:border + hh, border:border + ww]
        cq = zc.shape[1]
        zc = zc.reshape(b, fq, cq, hh, ww).permute(0, 3, 4, 1, 2).reshape(b * hh * ww, fq, cq)
        f = self.patch_nums[0]
        vt = self.cont_emb(zc).reshape(b, hh, ww, f, self.hidden_dim).permute(0, 3, 1, 2, 4)

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
    """A reference VidTwin ``model:`` section (resolved) -> (VidTwinVAE,
    meta): the shipped ``...CompactSymVidVAE`` (``VidTwinVAE`` and the
    reference's dotted path) and the non-Gaussian ``...CompactSymVid``
    (``vae=False``). The ablation ladder raises."""
    p = model_cfg.get("params", model_cfg)
    target = str(model_cfg.get("target", "")).rsplit(".", 1)[-1]
    if target in ABLATIONS:
        raise NotImplementedError(
            f"VidTwin ablation {target} is not ported yet: it is the next slice "
            "(ROADMAP.md, queue 1, the ablation ladder)")
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

    qf = dict((p.get("temporal_qformer_config") or {}).get("params") or {})
    qformer = QFormerInterface(
        num_query_tokens=qf.get("num_query_tokens", 3),
        query_hidden_size=qf.get("query_hidden_size", 64),
        encoder_hidden_size=qf.get("encoder_hidden_size", 768),
        num_hidden_layers=qf.get("num_hidden_layers", 6),
        intermediate_size=qf.get("intermediate_size", 768),
        num_attention_heads=qf.get("num_attention_heads", 8))
    reg = (p.get("regularizer_config") or {}).get("params") or {}
    model = VidTwinVAE(
        stt(STTEncoder, enc), stt(STTDecoder, dec), qformer,
        expect_ch=p.get("expect_ch", 4), d_dim=p.get("d_dim", 16),
        init_ch=p.get("init_ch", 128), cont_num_blocks=p.get("cont_num_blocks", 2),
        motion_num_blocks=p.get("motion_num_blocks", 2),
        downsample_motion=p.get("downsample_motion", False),
        shuffle_content=p.get("shuffle_content", False),
        vae=target != "VidAutoEncoderQformerCompactSymVid",
        partial_content_motion=p.get("partial_content_motion", "all"),
        sample=reg.get("sample", True))
    return model, {"kind": "vidtwin", "monitor": p.get("monitor")}
