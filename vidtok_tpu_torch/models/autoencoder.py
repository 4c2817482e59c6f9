"""The video tokenizer model (``vidtok_tpu/models/autoencoder.py``).

* ``TokenizerCore``: encoder, regularizer and decoder on channels-last
  tensors; ``forward`` encodes, regularizes, decodes and crops the decoded
  clip to the input length. ``encode`` and ``decode`` with ``streaming``
  run one chunk of a stream and return its cache beside the output.
* ``VideoTokenizer``: the serving engine over ``[B, C, T, H, W]`` tensors in
  [-1, 1]; it casts the input to ``compute_dtype`` and returns f32. With
  ``use_tiling`` it encodes and decodes chunk by chunk (v1.1 only), so
  memory does not grow with the clip. ``from_config`` builds any of the
  repo's VidTok configs (causal v1.0 and v1.1, non-causal; KL or FSQ;
  layernorm or groupnorm) with random weights or from a checkpoint, and
  ``save`` writes a reference-layout ``.ckpt``. ``forward_sharded`` runs
  one clip with its height split over the ranks of a mesh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import load_config
from ..modules.decoder import Decoder
from ..modules.encoder import Encoder
from ..modules.regularizers import DiagonalGaussianRegularizer, FSQRegularizer
from ..modules.stream import Stream
from ..ops.kernels import KernelForms
from ..parallel.mesh import HeightShard, Mesh
from ..utils import checkpoint

# reference and alias target names -> variant (vidtok_tpu/registry.py)
_ENC_VARIANTS = {
    "EncoderCausal3D": "causal",
    "vidtok.modules.model_3dcausal.EncoderCausal3DPadding": "causal",
    "EncoderCausal3DV1_1": "causal_v1_1",
    "vidtok.modules.model_3dcausal_v1_1.EncoderCausal3DPadding": "causal_v1_1",
    "Encoder3D": "noncausal",
    "vidtok.modules.model_3dnoncausal.Encoder3D": "noncausal",
}
_DEC_VARIANTS = {
    "DecoderCausal3D": "causal",
    "vidtok.modules.model_3dcausal.DecoderCausal3DPadding": "causal",
    "DecoderCausal3DV1_1": "causal_v1_1",
    "vidtok.modules.model_3dcausal_v1_1.DecoderCausal3DPadding": "causal_v1_1",
    "Decoder3D": "noncausal",
    "vidtok.modules.model_3dnoncausal.Decoder3D": "noncausal",
}
_REGULARIZERS = {
    "DiagonalGaussianRegularizer": "kl",
    "vidtok.modules.regularizers.DiagonalGaussianRegularizer": "kl",
    "FSQRegularizer": "fsq",
    "vidtok.modules.regularizers.FSQRegularizer": "fsq",
}


def _regularizer(reg_cfg: dict):
    """(regularizer, discrete) from a ``regularizer_config``."""
    kind = _REGULARIZERS.get(reg_cfg["target"])
    if kind is None:
        raise NotImplementedError(f"regularizer {reg_cfg['target']!r}")
    rp = dict(reg_cfg.get("params") or {})
    if kind == "kl":
        return DiagonalGaussianRegularizer(sample=rp.get("sample", True)), False
    # inv_temperature is passed on too, where JAX's build_core_from_config
    # drops it
    return FSQRegularizer(
        levels=tuple(rp["levels"]), dim=rp.get("dim"),
        num_codebooks=rp.get("num_codebooks", 1),
        entropy_loss_weight=rp.get("entropy_loss_weight", 0.0),
        entropy_loss_annealing_steps=rp.get("entropy_loss_annealing_steps", 0),
        entropy_loss_annealing_factor=rp.get("entropy_loss_annealing_factor", 1.0),
        commitment_loss_weight=rp.get("commitment_loss_weight", 0.0),
        diversity_gamma=rp.get("diversity_gamma", 1.0),
        inv_temperature=rp.get("inv_temperature", 100.0)), True


def build_core_from_config(model_cfg: dict, use_checkpoint: Optional[bool] = None
                           ) -> Tuple["TokenizerCore", dict]:
    """Reference-style ``model:`` section (already resolved: no ``${...}``)
    -> (TokenizerCore, meta). ``use_checkpoint`` (the config's
    ``training.use_checkpoint``, ``trainer.py:37-46``) overrides the
    encoder's and decoder's own flags when it is not None."""
    p = model_cfg.get("params", model_cfg)
    enc_cfg = p["encoder_config"]
    dec_cfg = p.get("decoder_config", enc_cfg)
    reg_cfg = p["regularizer_config"]
    ep = dict(enc_cfg.get("params") or {})
    dp = dict(dec_cfg.get("params") or {})

    def common(d):
        return dict(ch=d.get("ch", 128), ch_mult=tuple(d.get("ch_mult", (1, 2, 4, 4))),
                    num_res_blocks=d.get("num_res_blocks", 2),
                    z_channels=d["z_channels"],
                    norm_type=d.get("norm_type", "groupnorm"),
                    dropout=d.get("dropout", 0.0))

    def opt(d, key):
        return tuple(d[key]) if d.get(key) is not None else None

    def remat(d):
        return bool(d.get("use_checkpoint", False) if use_checkpoint is None
                    else use_checkpoint)

    tdf = ep.get("time_downsample_factor", 4)
    if enc_cfg["target"] not in _ENC_VARIANTS:
        raise KeyError(f"unknown encoder target {enc_cfg['target']!r}; one of "
                       f"{sorted(_ENC_VARIANTS)}")
    variant = _ENC_VARIANTS[enc_cfg["target"]]
    encoder = Encoder(
        in_channels=ep.get("in_channels", 3), double_z=ep.get("double_z", True),
        spatial_ds=opt(ep, "spatial_ds"), tempo_ds=opt(ep, "tempo_ds"),
        variant=variant, time_downsample_factor=tdf,
        init_pad_mode=ep.get("init_pad_mode", "replicate"),
        use_checkpoint=remat(ep), **common(ep))
    decoder = Decoder(
        out_ch=dp.get("out_ch", 3), spatial_us=opt(dp, "spatial_us"),
        tempo_us=opt(dp, "tempo_us"),
        # any other decoder target takes the encoder's variant
        # (``autoencoder.py:69-72``)
        variant=_DEC_VARIANTS.get(dec_cfg["target"], variant),
        interpolation_mode=dp.get("interpolation_mode", "nearest"),
        tanh_out=dp.get("tanh_out", False),
        time_downsample_factor=dp.get("time_downsample_factor", 4),
        use_checkpoint=remat(dp), **common(dp))
    regularizer, discrete = _regularizer(reg_cfg)
    core = TokenizerCore(encoder, decoder, regularizer)
    meta = dict(variant=variant, is_causal=variant != "noncausal", discrete=discrete,
                time_downsample_factor=tdf, use_tiling=p.get("use_tiling", False),
                t_chunk_enc=p.get("t_chunk_enc", 16),
                fix_encoder=ep.get("fix_encoder", False),
                fix_decoder=dp.get("fix_decoder", False), monitor=p.get("monitor"))
    return core, meta


def reset_params_(module: nn.Module, generator: torch.Generator = None) -> None:
    """Initialize as ``vidtok_tpu`` does: convs uniform in +-1/sqrt(fan_in)
    (temporal conv2 zero), norms 1 and 0, mix factors 2.0. Draws run on
    the CPU from ``generator``, so every device gets the same weights."""
    for m in module.modules():
        if hasattr(m, "reset_params"):
            m.reset_params(generator)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        if isinstance(getattr(m, "mix_factor", None), nn.Parameter):
            nn.init.constant_(m.mix_factor, 2.0)


class TokenizerCore(nn.Module):
    def __init__(self, encoder: Encoder, decoder: Decoder,
                 regularization: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.regularization = regularization

    def encode_raw(self, x, fused: bool = False, streaming: bool = False,
                   first_chunk: bool = True, cache: Optional[dict] = None):
        """The encoder's posterior parameters (or FSQ latent) before the
        regularizer; with ``streaming``, (that, cache) for one chunk."""
        if not streaming:
            return self.encoder(x, fused=fused)
        stream = Stream(self.encoder, cache, first_chunk)
        return self.encoder(x, fused=fused, stream=stream), stream.new

    def regularize(self, zp, n_steps: int = 0, sample: Optional[bool] = None,
                   generator: torch.Generator = None, global_batch: bool = False):
        """(z, reg_log) of ``encode_raw``'s output: the Gaussian's sample
        (from ``generator``) or mode, or FSQ's codes, with the losses
        annealed by ``n_steps``; ``global_batch``: FSQ's codebook entropy
        over the processes' global batch (the training forward)."""
        return self.regularization(zp, sample=sample, generator=generator,
                                   n_steps=n_steps, global_batch=global_batch)

    def encode(self, x, sample: Optional[bool] = None, fused: bool = False,
               generator: torch.Generator = None, streaming: bool = False,
               first_chunk: bool = True, cache: Optional[dict] = None,
               n_steps: int = 0):
        """``regularize(encode_raw(x))``: (z, reg_log); with ``streaming``,
        (z, reg_log, cache) for one chunk, ``cache`` being what the
        previous chunk returned."""
        if not streaming:
            return self.regularize(self.encode_raw(x, fused), n_steps, sample, generator)
        zp, cache = self.encode_raw(x, fused, True, first_chunk, cache)
        return self.regularize(zp, n_steps, sample, generator) + (cache,)

    def decode(self, z, fused: bool = False, streaming: bool = False,
               first_chunk: bool = True, use_cache_offset: bool = False,
               cache: Optional[dict] = None, forms: KernelForms = KernelForms()):
        """Frames; with ``streaming``, (frames, cache) for one chunk.
        ``forms``: the decoder's kernel forms when ``fused``."""
        if not streaming:
            return self.decoder(z, fused=fused, forms=forms)
        stream = Stream(self.decoder, cache, first_chunk, use_cache_offset)
        return self.decoder(z, fused=fused, stream=stream, forms=forms), stream.new

    def decode_indices(self, indices):
        """FSQ indices -> channels-last f32 latent."""
        return self.regularization.decode_indices(indices)

    def forward_train(self, x, n_steps: int = 0, fix_encoder: bool = False,
                      generator: torch.Generator = None):
        """The training forward (``autoencoder.py:180-192``): (z, xrec,
        conv_out's input, reg_log). The resblocks' dropout draws its masks
        and the regularizer samples as its config says, both from
        ``generator``; the regularizer anneals by ``n_steps`` and reduces
        FSQ's codebook entropy over the processes' global batch; under
        ``fix_encoder`` z and reg_log carry no gradient. Plain path (no
        kernel), activation checkpointing where the config sets
        ``use_checkpoint``; xrec is cropped to x's frames."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and not fix_encoder):
            zp = self.encoder(x, train=True, generator=generator)
            z, reg_log = self.regularize(zp, n_steps, generator=generator,
                                         global_batch=True)
        if fix_encoder:
            z = z.detach()
            reg_log = {k: v.detach() for k, v in reg_log.items()}
        dec, pre = self.decoder(z, train=True, return_features=True,
                                generator=generator)
        if dec.shape[1] != x.shape[1]:
            dec = dec[:, -x.shape[1]:]
        return z, dec, pre, reg_log

    def forward(self, x, sample: Optional[bool] = None, fused: bool = False,
                generator: torch.Generator = None,
                forms: KernelForms = KernelForms()):
        z, log = self.encode(x, sample=sample, fused=fused, generator=generator)
        dec = self.decode(z, fused=fused, forms=forms)
        # v1.1 decodes tdf*T' frames: crop to the input length (v1.0 crops
        # in the decoder)
        if dec.shape[1] != x.shape[1]:
            dec = dec[:, -x.shape[1]:]
        return z, dec, log


def _to_nthwc(x):
    return x.permute(0, 2, 3, 4, 1)


def _to_ncthw(x):
    return x.permute(0, 4, 1, 2, 3)


# the compute dtypes the kernels take: bf16, and f32 through the f32 scheme
# of the wgmma loop (ops/kernels/split.py) and D's f32 form
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def fused_default(device: torch.device, compute_dtype: torch.dtype,
                  fused: Optional[bool] = None) -> bool:
    """The engine's ``fused`` for ``device`` and ``compute_dtype``: as
    given, else on for a CUDA device in a dtype the kernels take (JAX's
    ``VideoTokenizer`` turns its kernels on for any accelerator, f32 its
    default). ``fused=True`` on a CUDA device in another dtype raises;
    off the card ``fused`` routes the call sites through the wrappers,
    which run their plain versions on CPU tensors."""
    on_card = device.type == "cuda"
    if fused is None:
        fused = on_card and compute_dtype in KERNEL_DTYPES
    if fused and on_card and compute_dtype not in KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernels take bf16 or f32 activations: fused=True on a "
                         f"CUDA device needs one of them, got {compute_dtype}")
    return bool(fused)


class VideoTokenizer:
    """Serving engine. Public tensors are ``[B, C, T, H, W]`` in [-1, 1];
    computation is channels-last in ``compute_dtype`` with f32 norm
    statistics; outputs are f32. ``fused`` (default: on for a CUDA device
    in bf16 or f32, the dtypes the kernels take: :func:`fused_default`)
    routes the kernels' call sites through their wrappers. ``forms`` (a
    :class:`KernelForms`, settable; default JAX's default forms) picks the
    kernel form of the decoder's upsamples and tail where ``fused`` is on;
    in f32 on the card only the default forms run (G, H, I and D' have no
    f32 form yet: their wrappers raise, naming the kernel).

    Tiled inference (``autoencoder.py:440-699``): ``use_tiling`` (from the
    config, settable) makes ``encode``, ``decode`` and ``forward`` run
    chunk by chunk with the causal caches carried between chunks. The
    encoder's chunks are frame 0 (padded to ``tdf`` frames), then
    ``t_chunk_enc`` frames; the decoder's one latent frame, then
    ``t_chunk_dec`` (``t_chunk_enc // tdf`` at construction). With
    ``use_overlap`` each decoder chunk but the last takes one latent
    look-ahead frame, whose ``tdf`` decoded frames are dropped, and the
    caches are stored at each stage's offset.
    """

    def __init__(self, core: TokenizerCore, meta: dict,
                 compute_dtype: torch.dtype = torch.float32,
                 fused: Optional[bool] = None, seed: int = 0,
                 forms: Optional[KernelForms] = None):
        self.core = core.eval()
        self.meta = meta
        self.compute_dtype = compute_dtype
        self.device = next(core.parameters()).device
        self.fused = fused_default(self.device, compute_dtype, fused)
        if forms is not None and not isinstance(forms, KernelForms):
            raise TypeError(f"forms must be a KernelForms, got {forms!r}")
        self.forms = forms or KernelForms()
        self.is_causal = meta["is_causal"]
        self.discrete = meta["discrete"]
        self.time_downsample_factor = meta["time_downsample_factor"]
        self.use_tiling = meta.get("use_tiling", False)
        self.t_chunk_enc = meta.get("t_chunk_enc", 16)
        self.t_chunk_dec = self.t_chunk_enc // self.time_downsample_factor
        self.use_overlap = meta.get("use_overlap", False)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    @classmethod
    def from_config(cls, config, ckpt: Optional[str] = None, seed: int = 0,
                    device="cuda", compute_dtype: torch.dtype = torch.float32,
                    fused: Optional[bool] = None,
                    forms: Optional[KernelForms] = None,
                    full_pickle: bool = False):
        """``config``: a dict or a YAML path (which needs PyYAML). The
        weights come from ``ckpt``, else from the config's
        ``model.params.ckpt_path``, less the keys its ``ignore_keys``
        patterns match (:func:`~..utils.checkpoint.load_checkpoint`: a
        ``.ckpt`` / ``.pt`` torch file, weights-only unless
        ``full_pickle``, a JAX ``.npz`` or a ``.safetensors`` file;
        loaded strictly, on the CPU); with neither they are random from
        ``seed``. The model is then placed on ``device``, the card unless
        the caller names another: a machine without CUDA raises rather
        than fall back to the CPU. ``forms``: the decoder's kernel forms
        (default ``KernelForms()``)."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to build "
                               "the model on the CPU")
        config = load_config(config)
        model_cfg = config.get("model", config)
        params = model_cfg.get("params", {}) or {}
        ckpt = ckpt or params.get("ckpt_path")
        core, meta = build_core_from_config(model_cfg)
        if ckpt:
            checkpoint.load_checkpoint(core, ckpt, tuple(params.get("ignore_keys") or ()),
                                       full_pickle)
        else:
            reset_params_(core, torch.Generator().manual_seed(seed))
        return cls(core.to(device), meta, compute_dtype, fused, seed, forms)

    def save(self, path: str) -> None:
        """Write the weights as a reference-layout ``{"state_dict": ...}``
        torch file (``ckpt=`` here, and JAX's ``load_params``, read it)."""
        checkpoint.save_checkpoint(self.core, path)

    def _input(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return _to_nthwc(x.to(self.device)).to(self.compute_dtype).contiguous()

    @torch.no_grad()
    def encode(self, x, return_reg_log: bool = False, sample: bool = False):
        """x: [B,C,T,H,W] -> z [B,Cz,T',H',W'] (+ reg_log)."""
        if self.use_tiling:
            z, log = self._tile_encode(x, sample)
        else:
            z, log = self.core.encode(self._input(x), sample=sample,
                                      fused=self.fused, generator=self.generator)
            z = _to_ncthw(z.float())
        return (z, log) if return_reg_log else z

    @torch.no_grad()
    def decode(self, z, decode_from_indices: bool = False):
        """z: [B,Cz,T',H',W'] (or FSQ indices [B,T',H',W'], [B,T',H',W',c]
        for c codebooks, with ``decode_from_indices``) -> [B,C,T,H,W]:
        tdf*T' frames (v1.1) or tdf*T' - (tdf-1) (v1.0)."""
        if decode_from_indices:
            z = self.indices_to_latent(z)
        if self.use_tiling:
            return self._tile_decode(z)
        dec = self.core.decode(self._input(z), fused=self.fused, forms=self.forms)
        return _to_ncthw(dec.float())

    @torch.no_grad()
    def indices_to_latent(self, indices):
        """FSQ indices [B,T',H',W'] ([B,T',H',W',c] for c codebooks) -> f32
        latent [B,Cz,T',H',W'], through ``project_out`` where FSQ has it."""
        if isinstance(indices, np.ndarray):
            indices = torch.from_numpy(indices)
        return _to_ncthw(self.core.decode_indices(indices.to(self.device)))

    @torch.no_grad()
    def forward(self, x, sample: bool = False):
        """(z, x_rec, reg_log) for x: [B,C,T,H,W]."""
        if self.use_tiling:
            z, log = self._tile_encode(x, sample)
            dec = self._tile_decode(z)
            # v1.1 decodes tdf*T' frames: keep the last T (autoencoder.py:390-395)
            return z, dec[:, :, -x.shape[2]:], log
        z, dec, log = self.core(self._input(x), sample=sample, fused=self.fused,
                                generator=self.generator, forms=self.forms)
        return _to_ncthw(z.float()), _to_ncthw(dec.float()), log

    __call__ = forward

    # -- H-sharded inference (``autoencoder.py:404-438``)

    @torch.no_grad()
    def forward_sharded(self, x, mesh: Mesh, sample: bool = False):
        """(z, x_rec, reg_log) of ``forward`` with the frame height split over
        all of ``mesh``'s ranks, rank ``mesh.index`` computing slab
        ``mesh.index`` of every activation. Every rank passes the whole x
        ``[B, C, T, H, W]`` and gets the whole results. JAX lets GSPMD insert
        the exchanges; here each operation that reads across H does its own
        (``parallel/mesh.py``'s ``HeightShard``, set on every module of the
        core for the call). The plain path (``fused=False``), as JAX's, but
        for the nearest temporal upsample, which takes kernel E on each
        slab where the tokenizer's ``fused`` is on: JAX's deterministic
        graph takes its Pallas E there too (``blocks.py:529-533``).
        ``sample`` draws the whole latent's noise on every rank from the
        tokenizer's generator, so equal seeds give one process's draw. H
        must divide into ``mesh.size`` slabs of a multiple of 8 rows (JAX's
        rule; of the encoder's whole spatial factor where that is larger),
        so every level's slab is whole, at least its one-row halo, and
        starts on an even row where it is downsampled."""
        if self.use_tiling:
            raise ValueError("forward_sharded runs the whole clip at once: a tiled "
                             "model has no sharded form (JAX never tiles in it)")
        if mesh.index is None:
            raise ValueError("this rank is not in the mesh")
        xs = self._input(x)
        h = xs.shape[2]
        unit = mesh.size * max(8, 2 ** len(self.core.encoder.spatial_ds))
        if h % unit:
            raise ValueError(f"H={h} does not split into {mesh.size} slabs of a "
                             f"multiple of {unit // mesh.size} rows")
        shard = HeightShard(mesh.group, mesh.index, mesh.size, parity_kernel=self.fused)
        modules = list(self.core.modules())
        for m in modules:
            m.shard = shard
        try:
            z, dec, log = self.core(shard.slab(xs, 2), sample=sample, fused=False,
                                    generator=self.generator)
        finally:
            for m in modules:
                m.__dict__.pop("shard", None)
        if "indices" in log:
            log = dict(log, indices=shard.gather(log["indices"], 2))
        z, dec = shard.gather(z, 2), shard.gather(dec, 2)
        return _to_ncthw(z.float()), _to_ncthw(dec.float()), log

    # -- tiled inference: a Python loop of chunk steps over an explicit cache

    def build_chunk_start_end(self, t: int, decoder_mode: bool = False):
        """[[0, 1], [1, 1 + chunk], ...]: frame 0 alone, then ``t_chunk_enc``
        (``t_chunk_dec`` with ``decoder_mode``) frames at a time."""
        chunk = self.t_chunk_dec if decoder_mode else self.t_chunk_enc
        start_end = [[0, 1]]
        start = 1
        while start < t:
            end = min(t, start + chunk)
            start_end.append([start, end])
            start = end
        return start_end

    def _check_tiling_supported(self):
        if self.meta.get("variant") == "noncausal":
            raise ValueError(
                "tiled/streaming inference needs a causal model: the "
                "non-causal model's convs see the whole clip, so chunks "
                "encoded apart would not equal it")
        if self.meta.get("variant") == "causal":
            raise ValueError(
                "tiled/streaming inference requires a v1.1 model "
                "(causal_v1_1); the v1.0 decoder crops warmup frames per "
                "call, which breaks chunk stitching (reference only "
                "implements tiling in autoencoder_v1_1.py)")

    @torch.no_grad()
    def encode_chunk(self, x, cache: Optional[dict] = None, sample: bool = False):
        """One step of the causal encoder stream (v1.1): ``x`` [B,C,t,H,W]
        is the clip's first chunk when ``cache`` is None (front-padded as
        ``pad_input`` pads it; frame 0 alone in the tiled schedule), else
        the chunk after the one that returned ``cache``. Returns (f32 z
        [B,Cz,t',H',W'], reg_log, cache for the next chunk); the chunk is
        moved to the device and cast on its own. ``_tile_encode`` is a
        loop of this step over ``build_chunk_start_end``."""
        self._check_tiling_supported()
        first = cache is None
        chunk = self._input(x)
        if first:
            chunk = self.core.encoder.pad_input(chunk)
        z, log, cache = self.core.encode(
            chunk, sample=sample, fused=self.fused, generator=self.generator,
            streaming=True, first_chunk=first, cache=cache)
        return _to_ncthw(z.float()), log, cache

    def _tile_encode(self, x, sample: bool = False):
        """x [B,C,T,H,W] -> (f32 z [B,Cz,T',H',W'], reg_log), chunk by
        chunk (``encode_chunk``). KL: the mean of the chunks' kl_loss;
        FSQ: the chunks' indices along time and the mean of their
        aux_loss."""
        zs, logs, cache = [], [], None
        for s, e in self.build_chunk_start_end(x.shape[2]):
            z, log, cache = self.encode_chunk(x[:, :, s:e], cache, sample)
            zs.append(z)
            logs.append(log)
        z = torch.cat(zs, dim=2)
        if self.discrete:
            log = {"aux_loss": torch.stack([l["aux_loss"] for l in logs]).mean(),
                   "indices": torch.cat([l["indices"] for l in logs], dim=1)}
        else:
            log = {"kl_loss": torch.stack([l["kl_loss"] for l in logs]).mean()}
        return z, log

    def _tile_decode(self, z):
        """z [B,Cz,T',H',W'] -> f32 [B,C,tdf*T',H,W], chunk by chunk."""
        t = z.shape[2]
        tdf = self.time_downsample_factor
        outs, cache = [], None
        for idx, (s, e) in enumerate(self.build_chunk_start_end(t, decoder_mode=True)):
            overlap = self.use_overlap and e + 1 <= t
            chunk = self._input(z[:, :, s:e + 1] if overlap else z[:, :, s:e])
            dec, cache = self.core.decode(
                chunk, fused=self.fused, streaming=True, first_chunk=idx == 0,
                use_cache_offset=self.use_overlap, cache=cache, forms=self.forms)
            outs.append(dec[:, :dec.shape[1] - tdf] if overlap else dec)
        return _to_ncthw(torch.cat(outs, dim=1).float())

    @torch.no_grad()
    def encode_streaming_scan(self, x, sample: bool = False):
        """The tiled encode of a clip of ``1 + k * t_chunk_enc`` frames, as
        (z, reg_log). JAX compiles this as one ``lax.scan``; eager PyTorch
        runs the same chunk loop as ``use_tiling``."""
        k, rem = divmod(x.shape[2] - 1, self.t_chunk_enc)
        if rem:
            raise ValueError(f"T={x.shape[2]} not 1 + k*{self.t_chunk_enc}")
        return self._tile_encode(x, sample)

    @torch.no_grad()
    def decode_streaming_scan(self, z):
        """The tiled decode of ``1 + k * t_chunk_dec`` latent frames."""
        k, rem = divmod(z.shape[2] - 1, self.t_chunk_dec)
        if rem:
            raise ValueError(f"T'={z.shape[2]} not 1 + k*{self.t_chunk_dec}")
        return self._tile_decode(z)
