"""VidTwin's ablation ladder (``vidtok_tpu/models/vidtwin/ablations.py``;
reference vidtwin/models/vidtwin_ae.py):

  VidAutoEncoderQformer              (:282-447)  -> VidTwinQformer
  VidAutoEncoderQformerCompact       (:448-676)  -> VidTwinCompact
  VidAutoEncoderQformerCompactSym    (:677-926)  -> VidTwinSym
  VidAutoEncoderQformerCompactSymDis (:928-965)  -> VidTwinSym(dis=True)

All share ``VidTwinVAE``'s ST-transformer backbone and differ in the
bottleneck over the token grid:

* Qformer: three Q-Formers compress the time, height and width axes apart.
* Compact: one temporal Q-Former over channel-reduced per-frame summaries
  (content, ``[B, Fq, Cq]``) and one spatial Q-Former per frame (motion).
* Sym: Compact's motion and ``VidTwinVAE``'s conv pyramid on the content
  (no Gaussian); SymDis trains the content on frame-shuffled clips.

Each has ``encode``, ``decode`` and ``forward(x, sample=None,
generator=None)``, which returns ``(z, x_rec, reg_log, latents)`` with
``kl_loss`` 0; JAX's ``return_features`` (the decoder's final-layer
input, for its adaptive GAN weight) is not carried over, as for
``VidTwinVAE``: the port's trainer differentiates
``decoder.final_layer.linear.weight`` itself. Clips are ``[B, C, T, H,
W]``, z ``[B, hidden, F, H', W']`` (SymDis: ``[2B, ...]``, the clip and
its shuffled copy), the latents JAX's channels-last layouts: the Dense
weights of the reference and of JAX read their inputs' channels in those
orders. ``sample`` is ignored (no
posterior). Randomness (``shuffle_content``'s and SymDis's permutations,
SymDis's per-sample gate) comes from ``generator``, on the model's
device. Module names and ``nn.Sequential`` indices are the reference's,
the height Q-Former's misspelling ``hight_qformer`` included, so a
reference state dict loads strictly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .qformer import QFormerInterface
from .st_transformer import Linear, STTDecoder, STTEncoder, layer_norm_noaffine
from .vidtwin_ae import ContentPyramid, EmbSeq, reset_glue, shuffle_frames


def _ln_noaffine(x):
    """The reference builds a fresh default ``nn.LayerNorm`` in forward
    (:650-656): unit scale, zero bias, eps 1e-5."""
    return layer_norm_noaffine(x, eps=1e-5)


def _queries(qformer: QFormerInterface):
    """(num_query, query_hidden_size)."""
    return qformer.query_embeds.shape[0], qformer.query_hidden_size


def _part(only_part: Optional[str], default: str) -> Optional[str]:
    return only_part or (None if default == "all" else default)


class _Ablation(nn.Module):
    """What the ladder shares: the glue's init, the grid, the zero
    ``kl_loss``, the decoder call on channels-last tokens and the
    forward's tuples."""

    reset_params = reset_glue

    @property
    def patch_nums(self):
        return self.encoder.grid

    @property
    def hidden_dim(self) -> int:
        return self.encoder.hidden_size

    def unused_keys(self):
        """Patterns of state-dict keys the forward never reads, which JAX's
        tree lacks (a strict load keeps their weights when absent)."""
        return ()

    def _zero_log(self, z):
        return {"kl_loss": z.new_zeros((), dtype=torch.float32)}

    def _decode_tokens(self, cm):
        """[B, F, H', W', hidden] -> the decoder's clip."""
        return self.decoder(cm.permute(0, 4, 1, 2, 3))

    def forward(self, x, sample: Optional[bool] = None, generator: torch.Generator = None):
        z, *latents, reg_log = self.encode(x, sample, generator)
        return z, self.decode(*latents), reg_log, tuple(latents)


class VidTwinQformer(_Ablation):
    """Three Q-Formers, one per axis of the token grid (:282-447)."""

    def __init__(self, encoder: STTEncoder, decoder: STTDecoder,
                 temporal_qformer: QFormerInterface, height_qformer: QFormerInterface,
                 width_qformer: QFormerInterface):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.temporal_qformer = temporal_qformer
        self.hight_qformer = height_qformer  # the reference's spelling (:326)
        self.width_qformer = width_qformer
        hidden, pn = encoder.hidden_size, encoder.grid
        self.cont_emb = EmbSeq(temporal_qformer.query_hidden_size, hidden,
                               _queries(temporal_qformer)[0], pn[0])
        self.height_emb = EmbSeq(height_qformer.query_hidden_size, hidden,
                                 _queries(height_qformer)[0], pn[1])
        self.width_emb = EmbSeq(width_qformer.query_hidden_size, hidden,
                                _queries(width_qformer)[0], pn[2])

    def encode(self, x, sample: Optional[bool] = None, generator: torch.Generator = None):
        """x -> (z, u_t [B, Fq, H', W', Cq], u_h [B, F, Hq, W', Cq], u_w
        [B, F, H', Wq, Cq], reg_log)."""
        z = self.encoder(x)
        zl = z.permute(0, 2, 3, 4, 1)
        b, f, hh, ww, c = zl.shape
        u_t = self.temporal_qformer(zl.permute(0, 2, 3, 1, 4).reshape(b * hh * ww, f, c))
        u_t = u_t.reshape((b, hh, ww) + tuple(u_t.shape[1:])).permute(0, 3, 1, 2, 4)
        u_h = self.hight_qformer(zl.permute(0, 1, 3, 2, 4).reshape(b * f * ww, hh, c))
        u_h = u_h.reshape((b, f, ww) + tuple(u_h.shape[1:])).permute(0, 1, 3, 2, 4)
        u_w = self.width_qformer(zl.reshape(b * f * hh, ww, c))
        u_w = u_w.reshape((b, f, hh) + tuple(u_w.shape[1:]))
        return z, u_t, u_h, u_w, self._zero_log(z)

    def decode(self, u_t, u_h, u_w):
        f, hh, ww = self.patch_nums
        b, hidden = u_t.shape[0], self.hidden_dim
        # content: the Fq query tokens mixed up to F frames per site
        ct = u_t.permute(0, 2, 3, 1, 4)
        ct = self.cont_emb(ct.reshape((b * hh * ww,) + tuple(ct.shape[3:])))
        vt = ct.reshape(b, hh, ww, f, hidden).permute(0, 3, 1, 2, 4)
        # height: Hq tokens up to H' rows per (frame, column)
        ch = u_h.permute(0, 1, 3, 2, 4)
        ch = self.height_emb(ch.reshape((b * f * ww,) + tuple(ch.shape[3:])))
        vx = ch.reshape(b, f, ww, hh, hidden).permute(0, 1, 3, 2, 4)
        # width: Wq tokens up to W' columns per (frame, row)
        cw = self.width_emb(u_w.reshape((b * f * hh,) + tuple(u_w.shape[3:])))
        vy = cw.reshape(b, f, hh, ww, hidden)
        return self._decode_tokens(vt + vx + vy)


class _SpatialMotion:
    """The per-frame spatial Q-Former motion of Compact and Sym:
    ``retain_num_frames`` keeps one query set per frame; otherwise the
    frames are folded into the channels first (``pre_spatial_qformer``)
    and the field is unfolded from the queries (``spatial_emb``'s six
    elements)."""

    def _build_motion(self) -> None:
        f, hh, ww = self.encoder.grid
        hidden = self.encoder.hidden_size
        nq, cq = _queries(self.space_qformer)
        if self.retain_num_frames:
            self.spatial_emb = EmbSeq(cq, hidden, nq, hh * ww)
        else:
            self.pre_spatial_qformer = nn.Sequential(
                Linear(f * hidden, 2 * hidden), nn.ReLU(), Linear(2 * hidden, hidden),
                nn.ReLU())
            self.spatial_emb = EmbSeq(cq, hidden, nq, hh * ww, mid=hidden * f)

    def motion_tokens(self, zl):
        """[B, F, H', W', C] -> ``[B, F, Sq, Cq]`` (``retain_num_frames``)
        or ``[B, Sq, Cq]``."""
        b, f, hh, ww, c = zl.shape
        if self.retain_num_frames:
            m = self.space_qformer(zl.reshape(b * f, hh * ww, c))
            return m.reshape((b, f) + tuple(m.shape[1:]))
        h = zl.reshape(b, f, hh * ww, c).transpose(1, 2).reshape(b, hh * ww, f * c)
        return self.space_qformer(self.pre_spatial_qformer(h))

    def motion_field(self, u_m):
        """-> ``[B, F, H', W', hidden]``; with frames folded, the
        reference's ``B (H W) (F C)`` unfold (:629-631)."""
        f, hh, ww = self.encoder.grid
        b, hidden = u_m.shape[0], self.encoder.hidden_size
        if self.retain_num_frames:
            h = self.spatial_emb(u_m.reshape((b * f,) + tuple(u_m.shape[2:])))
            return h.reshape(b, f, hh, ww, hidden)
        h = self.spatial_emb(u_m)  # [B, H' W', F hidden]
        return h.reshape(b, hh, ww, f, hidden).permute(0, 3, 1, 2, 4)


class VidTwinCompact(_SpatialMotion, _Ablation):
    """One temporal Q-Former over channel-reduced frame summaries
    (content) and the spatial Q-Former motion (:448-676)."""

    def __init__(self, encoder: STTEncoder, decoder: STTDecoder,
                 temporal_qformer: QFormerInterface, space_qformer: QFormerInterface,
                 retain_num_frames: bool = True, temporal_down_dim: int = 32,
                 repeat_for_decoder: bool = False, partial_content_motion: str = "all",
                 shuffle_content: bool = False):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.temporal_qformer = temporal_qformer
        self.space_qformer = space_qformer
        self.retain_num_frames = retain_num_frames
        self.temporal_down_dim = tdd = temporal_down_dim
        self.repeat_for_decoder = repeat_for_decoder
        self.partial_content_motion = partial_content_motion
        self.shuffle_content = shuffle_content
        f, hh, ww = encoder.grid
        hidden = encoder.hidden_size
        nq, cq = _queries(temporal_qformer)
        self.down_channel_temp = Linear(hidden, tdd)
        self.pre_temporal_qformer = nn.Sequential(Linear(tdd * hh * ww, hidden), nn.ReLU())
        if repeat_for_decoder:
            self.cont_emb = EmbSeq(cq, hidden, nq, hh * ww)
        else:
            self.cont_emb = EmbSeq(cq, hidden, nq, f, mid=tdd * hh * ww)
        # built whatever repeat_for_decoder says, and unused with it, as the
        # reference builds it (:541): its checkpoints hold the keys
        self.up_channel_temp = Linear(tdd, hidden)
        self._build_motion()

    def unused_keys(self):
        """``up_channel_temp`` under ``repeat_for_decoder``."""
        return (r"up_channel_temp\.",) if self.repeat_for_decoder else ()

    def content_tokens(self, zl):
        """[B, F, H', W', C] -> ``[B, Fq, Cq]`` (:639-655)."""
        b, f = zl.shape[:2]
        h = self.pre_temporal_qformer(self.down_channel_temp(zl).reshape(b, f, -1))
        return _ln_noaffine(self.temporal_qformer(h))

    def encode(self, x, sample: Optional[bool] = None, generator: torch.Generator = None):
        """x -> (z, u_c [B, Fq, Cq], u_m, reg_log)."""
        z = self.encoder(x)
        zl = z.permute(0, 2, 3, 4, 1)
        z_q = shuffle_frames(zl, generator) if self.shuffle_content else zl
        return (z, self.content_tokens(z_q), _ln_noaffine(self.motion_tokens(zl)),
                self._zero_log(z))

    def content_field(self, u_c):
        """-> ``[B, F, H', W', hidden]`` (:609-637)."""
        f, hh, ww = self.patch_nums
        b = u_c.shape[0]
        if self.repeat_for_decoder:
            rep = u_c[:, None].expand((b, f) + tuple(u_c.shape[1:]))
            h = self.cont_emb(rep.reshape((b * f,) + tuple(u_c.shape[1:])))
            return h.reshape(b, f, hh, ww, self.hidden_dim)
        h = self.cont_emb(u_c)  # [B, F, tdd H' W']
        # the reference's 'B F (C H W) -> B C F H W' (:613-616), channels-last
        h = h.reshape(b, f, self.temporal_down_dim, hh, ww).permute(0, 1, 3, 4, 2)
        return self.up_channel_temp(h)

    def decode(self, u_c, u_m, only_part: Optional[str] = None):
        part = _part(only_part, self.partial_content_motion)
        if part == "content":
            cm = self.content_field(u_c)
        elif part == "motion":
            cm = self.motion_field(u_m)
        else:
            cm = self.content_field(u_c) + self.motion_field(u_m)
        return self._decode_tokens(cm)


class VidTwinSym(_SpatialMotion, ContentPyramid, _Ablation):
    """Compact's motion with a conv-pyramid content bottleneck (no
    Gaussian; :677-926). ``dis`` is SymDis (:928-965): each sample's
    frames are shuffled with probability ``shuffle_ratio`` before the
    content pathway; the motion always sees the clip as it is."""

    def __init__(self, encoder: STTEncoder, decoder: STTDecoder,
                 temporal_qformer: QFormerInterface, space_qformer: QFormerInterface,
                 expect_ch: int = 4, init_ch: int = 128, cont_num_blocks: int = 2,
                 retain_num_frames: bool = True, partial_content_motion: str = "all",
                 shuffle_content: bool = False, dis: bool = False,
                 shuffle_ratio: float = 0.5):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.temporal_qformer = temporal_qformer
        self.space_qformer = space_qformer
        self.expect_ch = expect_ch
        self.retain_num_frames = retain_num_frames
        self.partial_content_motion = partial_content_motion
        self.shuffle_content = shuffle_content
        self.dis = dis
        self.shuffle_ratio = shuffle_ratio
        self._build_content(init_ch, cont_num_blocks, expect_ch, expect_ch)
        self._build_motion()

    def _shuffled(self, x, generator):
        """SymDis's content input: each sample's frames (axis 2) permuted
        when its gate, uniform < ``shuffle_ratio``, is set (gates first,
        then the permutations, from ``generator``)."""
        b, t = x.shape[0], x.shape[2]
        gates = torch.rand((b,), generator=generator, device=x.device) < self.shuffle_ratio
        perms = torch.rand((b, t), generator=generator, device=x.device).argsort(1)
        ident = torch.arange(t, device=x.device).expand(b, t)
        perms = torch.where(gates[:, None], perms, ident)
        return torch.stack([xi.index_select(1, p) for xi, p in zip(x, perms)])

    def encode(self, x, sample: Optional[bool] = None, generator: torch.Generator = None):
        """x -> (z, u_c [B, Fq, h, w, expect_ch], u_m, reg_log); SymDis's z
        is the encoder's ``[2B, ...]`` over the clip and its shuffled
        copy."""
        if self.dis:
            b = x.shape[0]
            z2 = self.encoder(torch.cat([x, self._shuffled(x, generator)]))
            zl = z2.permute(0, 2, 3, 4, 1)
            return (z2, self.content_tokens(zl[b:]), self.motion_tokens(zl[:b]),
                    self._zero_log(z2))
        z = self.encoder(x)
        zl = z.permute(0, 2, 3, 4, 1)
        z_q = shuffle_frames(zl, generator) if self.shuffle_content else zl
        return z, self.content_tokens(z_q), self.motion_tokens(zl), self._zero_log(z)

    def decode(self, u_c, u_m, only_part: Optional[str] = None):
        part = _part(only_part, self.partial_content_motion)
        if part == "content":
            cm = self.content_field(u_c)
        elif part == "motion":
            cm = self.motion_field(u_m)
        else:
            cm = self.content_field(u_c) + self.motion_field(u_m)
        return self._decode_tokens(cm)
