"""VidTokTrainer: the two-optimizer GAN step (``vidtok_tpu/train/trainer.py``;
the reference's Lightning ``training_step``).

One :meth:`VidTokTrainer.fit_step` on a channels-last batch ``[B, T, H, W,
C]`` in [-1, 1], in JAX's order:

1. the generator loss (L1 + LPIPS over a learned log-variance, the
   adaptive-weight GAN term, the regularizer terms) and its gradients,
   with the discriminator's parameters frozen (JAX differentiates
   ``params_g`` only), its BatchNorm advancing on the fake batch;
2. the generator update: frozen parts' gradients dropped (``fix_encoder``,
   ``fix_decoder``, ``learn_logvar`` off), averaged over the processes,
   clipped to global norm 20, Adam;
3. the discriminator loss on the detached real then fake clips (hinge or
   vanilla, LeCAM), its BatchNorm advancing on each;
4. the discriminator update, as 2;
5. the EMA of both (``ema_decay``), at the step before the increment.

``training.precision: bf16-mixed`` keeps f32 master weights and f32 loss
arithmetic: the core takes a bf16 clip and casts each weight to it, as
JAX's ``hcast`` does; the discriminator and LPIPS run under
``torch.autocast`` (their BatchNorm as torch runs it there). ``fp32``
computes in f32. The train step runs the plain path: the kernels have no
backward, as in JAX.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from ..config import load_config
from ..models.autoencoder import VideoTokenizer, build_core_from_config, reset_params_
from ..modules.discriminator import reset_params_ as reset_disc_
from ..modules.lpips import LPIPS, load_lpips_params
from ..parallel.distributed import average_gradients, mean_, world_size
from ..utils import checkpoint
from .losses import LossConfig, discriminator_loss, generator_loss, make_discriminator
from .state import ema_update, make_optimizer


class VidTokTrainer:
    def __init__(self, config, device="cuda", lpips_weights: Optional[str] = None,
                 seed: int = 23, full_pickle: bool = False):
        self.device = device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
        self.cfg = cfg = load_config(config)
        model_cfg = cfg.get("model", cfg)
        tcfg = cfg.get("training", {}) or {}
        # training.use_checkpoint overrides the model sections (trainer.py:37-46)
        self.core, self.meta = build_core_from_config(model_cfg, tcfg.get("use_checkpoint"))
        p = model_cfg.get("params", {}) or {}
        self.model_params = p
        self.loss_cfg = LossConfig.from_dict((p.get("loss_config") or {}).get("params"))
        self.disc = make_discriminator(self.loss_cfg)
        weights = load_lpips_params(lpips_weights) if lpips_weights else load_lpips_params()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.lpips = LPIPS()
        if weights is not None:
            self.lpips.load_state_dict(weights)
        self.lpips_pretrained = weights is not None
        self.lr = float(model_cfg.get("base_learning_rate", 1e-5))
        self.grad_clip = float(tcfg.get("grad_clip", 20.0))
        self.precision = str(tcfg.get("precision", "fp32"))
        self.compute_dtype = torch.bfloat16 if self.precision.startswith("bf16") else None
        self.ema_decay = p.get("ema_decay")
        self.seed = seed
        self.full_pickle = full_pickle
        self.step = 0
        self.opt_g = self.opt_d = None

    def set_lr(self, lr: float) -> None:
        """The learning rate of both optimizers (e.g. ``--scale_lr``), before
        the first step."""
        if self.step:
            raise RuntimeError("set_lr before the first step")
        self.lr = float(lr)
        for opt in (self.opt_g, self.opt_d):
            for group in (opt.param_groups if opt is not None else ()):
                group["lr"] = self.lr

    # ------------------------------------------------------------------

    def init_state(self) -> "VidTokTrainer":
        """Weights from ``seed`` (the core as ``vidtok_tpu`` inits, the
        discriminator as ``weights_init``; ``logvar`` its init), or from the
        config's ``model.params.ckpt_path``: the core (the keys
        ``ignore_keys`` matches keep the seed's weights),
        and from a torch ``.ckpt`` / ``.safetensors`` also the
        discriminator (``loss.discriminator.*``) and ``loss.logvar`` (the
        reference's fine-tune workflow). Then the optimizers, the EMA
        copies, LeCAM's EMAs and the sampling generator, on the device."""
        reset_params_(self.core, torch.Generator().manual_seed(self.seed))
        reset_disc_(self.disc, torch.Generator().manual_seed(self.seed + 1))
        logvar = torch.tensor(float(self.loss_cfg.logvar_init))
        ckpt_path = self.model_params.get("ckpt_path")
        if ckpt_path:
            print(f"[trainer] init from ckpt: {ckpt_path}")
            checkpoint.load_checkpoint(self.core, ckpt_path,
                                       tuple(self.model_params.get("ignore_keys") or ()),
                                       self.full_pickle, keep_ignored=True)
            if not str(ckpt_path).endswith(".npz"):
                sd = checkpoint.read_torch_file(ckpt_path, self.full_pickle)
                pre = "loss.discriminator."
                disc = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
                if disc:
                    self.disc.load_state_dict(disc)
                if "loss.logvar" in sd:
                    logvar = torch.as_tensor(sd["loss.logvar"]).float().reshape(())
        dev = self.device
        self.core.to(dev).train()
        self.disc.to(dev).train()
        self.lpips.to(dev).eval()
        self.logvar = nn.Parameter(logvar.to(dev))
        self.params_g = list(self.core.parameters()) + [self.logvar]
        self.opt_g = make_optimizer(self.params_g, self.lr)
        self.opt_d = make_optimizer(self.disc.parameters(), self.lr)
        self.ema = None
        if self.ema_decay:
            self.ema = {"core": copy.deepcopy(self.core).requires_grad_(False),
                        "logvar": self.logvar.detach().clone(),
                        "disc": copy.deepcopy(self.disc).requires_grad_(False)}
        self.lecam = torch.zeros(2, device=dev)
        self.generator = torch.Generator(dev).manual_seed(self.seed)
        self.step = 0
        return self

    def _ema_pairs(self):
        e = self.ema
        shadow = list(e["core"].parameters()) + [e["logvar"]] + list(e["disc"].parameters())
        return shadow, self.params_g + list(self.disc.parameters())

    def _last_layer(self):
        conv = self.core.decoder.conv_out
        return getattr(conv, "conv", conv).weight

    def _update(self, opt, params, frozen=()) -> None:
        for p in frozen:
            p.grad = None
        params = [p for p in params if p.grad is not None]
        average_gradients(params)
        torch.nn.utils.clip_grad_norm_(params, self.grad_clip)
        opt.step()

    def fit_step(self, x, generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """One GAN step on ``x`` ``[B, T, H, W, C]`` (this process's share of
        the batch); returns the logs as 0-d tensors on the device (averaged
        over the processes). ``generator`` (default the trainer's) draws
        the posterior sample and the resblocks' dropout masks."""
        if self.opt_g is None:
            raise RuntimeError("init_state() before fit_step")
        x = x.to(self.device, torch.float32)
        cd, cfg, step = self.compute_dtype, self.loss_cfg, self.step
        meta = self.meta

        self.disc.requires_grad_(False)
        try:
            z, xrec, _, reg_log = self.core.forward_train(
                x if cd is None else x.to(cd), n_steps=step,
                fix_encoder=meta.get("fix_encoder", False),
                generator=generator or self.generator)
            aeloss, logs_g = generator_loss(
                cfg=cfg, lpips=self.lpips, disc=self.disc, last_layer=self._last_layer(),
                logvar=self.logvar, x=x, xrec=xrec, reg_log=reg_log, global_step=step,
                compute_dtype=cd)
            self.opt_g.zero_grad(set_to_none=True)
            aeloss.backward()
        finally:
            self.disc.requires_grad_(True)
        frozen = []
        if meta.get("fix_encoder"):
            frozen += list(self.core.encoder.parameters())
        if meta.get("fix_decoder"):
            frozen += list(self.core.decoder.parameters())
        if not cfg.learn_logvar:
            frozen.append(self.logvar)
        self._update(self.opt_g, self.params_g, frozen)

        discloss, logs_d, (real, fake) = discriminator_loss(
            cfg=cfg, disc=self.disc, x=x, xrec=xrec, global_step=step,
            lecam_ema_real=self.lecam[0], lecam_ema_fake=self.lecam[1], compute_dtype=cd)
        self.opt_d.zero_grad(set_to_none=True)
        discloss.backward()
        self._update(self.opt_d, self.disc.parameters())
        self.lecam = torch.stack([real, fake]).detach()

        if self.ema is not None:
            ema_update(*self._ema_pairs(), step, self.ema_decay)
        self.step += 1
        logs = {"train/aeloss": aeloss.detach(), "train/discloss": discloss.detach(),
                **logs_g, **logs_d}
        if world_size() > 1:
            vals = torch.stack([v.float() for v in logs.values()])
            mean_((vals,))
            logs = dict(zip(logs, vals.unbind()))
        return logs

    # ------------------------------------------------------------------

    def tokenizer(self, ema: bool = False) -> VideoTokenizer:
        """A serving engine over the trained core (or its EMA copy): on the
        card in bf16 when the run is bf16-mixed, so validation takes the
        kernel path on the weights the optimizer has just changed."""
        core = self.ema["core"] if ema else self.core
        dtype = (torch.bfloat16 if self.device.type == "cuda" and self.compute_dtype
                 else torch.float32)
        return VideoTokenizer(core, self.meta, compute_dtype=dtype)

    def state_dict(self) -> dict:
        """Everything a resumed run needs (``utils/checkpoint.py``)."""
        rng = {"torch": torch.get_rng_state(), "generator": self.generator.get_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        ema = None
        if self.ema is not None:
            ema = {"core": self.ema["core"].state_dict(), "logvar": self.ema["logvar"],
                   "disc": self.ema["disc"].state_dict()}
        return {"step": self.step, "core": self.core.state_dict(),
                "logvar": self.logvar.detach(), "disc": self.disc.state_dict(),
                "opt_g": self.opt_g.state_dict(), "opt_d": self.opt_d.state_dict(),
                "ema": ema, "lecam": self.lecam, "rng": rng}

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict` into an initialised trainer."""
        if self.opt_g is None:
            self.init_state()
        with torch.no_grad():
            self.core.load_state_dict(sd["core"])
            self.logvar.copy_(sd["logvar"])
            self.disc.load_state_dict(sd["disc"])
            if self.ema is not None and sd.get("ema") is not None:
                self.ema["core"].load_state_dict(sd["ema"]["core"])
                self.ema["logvar"].copy_(sd["ema"]["logvar"])
                self.ema["disc"].load_state_dict(sd["ema"]["disc"])
            self.lecam.copy_(sd["lecam"])
        self.opt_g.load_state_dict(sd["opt_g"])
        self.opt_d.load_state_dict(sd["opt_d"])
        torch.set_rng_state(sd["rng"]["torch"])
        self.generator.set_state(sd["rng"]["generator"])
        if "cuda" in sd["rng"] and self.device.type == "cuda":
            torch.cuda.set_rng_state(sd["rng"]["cuda"], self.device)
        self.step = int(sd["step"])
