"""The VidTwin GAN trainer (``vidtok_tpu/models/vidtwin/trainer.py``;
reference ``VidAutoEncoderQformerBase.training_step``,
vidtwin_ae.py:86-137).

One :meth:`VidTwinTrainer.fit_step` on a channels-last batch ``[B, T, H,
W, C]`` in [-1, 1], in JAX's order: the generator loss (L1 + LPIPS over a
learned log-variance, the adaptive-weight GAN term on the decoder's
``final_layer.linear`` weight, ``kl_loss``) and its gradients, the
generator update, then the discriminator loss on the detached clips
(LeCAM's EMAs carried between steps) and its update; no EMA. Each
optimizer is ``torch.optim.AdamW`` with the config's betas and weight
decay on every parameter (``logvar`` too, as ``optax.adamw`` without a
mask decays it), after a global-norm clip at 20,
its learning rate set to its schedule at the step (counted from 0) before
each update. ``training.precision: bf16-mixed`` runs the model on a bf16
clip through f32 master weights and the discriminator and LPIPS under
``torch.autocast``, as ``VidTokTrainer`` does. One process; the model's
plain path (VidTwin has no kernel). The model is the config's target:
``VidTwinVAE`` or a class of the ablation ladder (whose ``kl_loss`` is 0),
as JAX's trainer takes any.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...config import load_config
from ...modules.discriminator import reset_params_ as reset_disc_
from ...modules.lpips import LPIPS, load_lpips_params
from ...train.losses import LossConfig, discriminator_loss, generator_loss, make_discriminator
from . import schedules
from .vidtwin_ae import build_vidtwin_from_config, reset_params_


class VidTwinTrainer:
    def __init__(self, config, device="cuda", lpips_weights: Optional[str] = None,
                 seed: int = 23, total_steps: int = 100000):
        self.device = device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
        cfg = load_config(config)
        model_cfg = cfg.get("model", cfg)
        p = model_cfg.get("params", {}) or {}
        self.model, _ = build_vidtwin_from_config(model_cfg)
        self.loss_cfg = LossConfig.from_dict((p.get("loss_config") or {}).get("params"))
        self.disc = make_discriminator(self.loss_cfg)
        weights = load_lpips_params(lpips_weights) if lpips_weights else load_lpips_params()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.lpips = LPIPS()
        if weights is not None:
            self.lpips.load_state_dict(weights)
        base_lr = float(model_cfg.get("base_learning_rate", 1.6e-4))
        self.sched_g = schedules.from_config(p.get("lr_scheduler_config_g"), base_lr,
                                             total_steps)
        self.sched_d = schedules.from_config(p.get("lr_scheduler_config_d"), base_lr,
                                             total_steps)
        op = (p.get("optimizer_config") or {}).get("params", {}) or {}
        self.betas = tuple(float(b) for b in op.get("betas", (0.0, 0.99)))
        self.weight_decay = float(op.get("weight_decay", p.get("weight_decay", 1e-5)))
        self.grad_clip = 20.0
        precision = str((cfg.get("training", {}) or {}).get("precision", "fp32"))
        self.compute_dtype = torch.bfloat16 if precision.startswith("bf16") else None
        self.seed = seed
        self.step = 0
        self.opt_g = self.opt_d = None

    def init_state(self) -> "VidTwinTrainer":
        """Weights from ``seed`` (the model as ``vidtok_tpu`` inits, the
        discriminator as ``weights_init``, ``logvar`` its init), both
        optimizers and the sampling generator, on the device."""
        reset_params_(self.model, torch.Generator().manual_seed(self.seed))
        reset_disc_(self.disc, torch.Generator().manual_seed(self.seed + 1))
        dev = self.device
        self.model.to(dev).train()
        self.disc.to(dev).train()
        self.lpips.to(dev).eval()
        self.logvar = nn.Parameter(torch.tensor(float(self.loss_cfg.logvar_init), device=dev))
        self.params_g = list(self.model.parameters()) + [self.logvar]

        def adamw(params, sched):
            return torch.optim.AdamW(params, lr=sched(0), betas=self.betas, eps=1e-8,
                                     weight_decay=self.weight_decay)

        self.opt_g = adamw(self.params_g, self.sched_g)
        self.opt_d = adamw(self.disc.parameters(), self.sched_d)
        self.lecam = torch.zeros(2, device=dev)
        self.generator = torch.Generator(dev).manual_seed(self.seed)
        self.step = 0
        return self

    def _update(self, opt, params, lr: float) -> None:
        torch.nn.utils.clip_grad_norm_(params, self.grad_clip)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()

    def fit_step(self, x, generator: torch.Generator = None) -> Dict[str, torch.Tensor]:
        """One GAN step on ``x`` ``[B, T, H, W, C]``; returns the logs as 0-d
        tensors on the device. ``generator`` (default the trainer's) draws
        the posterior samples (and ``shuffle_content``'s permutations)."""
        if self.opt_g is None:
            raise RuntimeError("init_state() before fit_step")
        x = x.to(self.device, torch.float32)
        cd, cfg, step = self.compute_dtype, self.loss_cfg, self.step
        xin = x.permute(0, 4, 1, 2, 3)

        self.disc.requires_grad_(False)
        try:
            _, xrec, reg_log, _ = self.model(xin if cd is None else xin.to(cd),
                                             generator=generator or self.generator)
            xrec = xrec.permute(0, 2, 3, 4, 1)
            aeloss, logs_g = generator_loss(
                cfg=cfg, lpips=self.lpips, disc=self.disc,
                last_layer=self.model.decoder.final_layer.linear.weight,
                logvar=self.logvar, x=x, xrec=xrec, reg_log=reg_log, global_step=step,
                compute_dtype=cd)
            self.opt_g.zero_grad(set_to_none=True)
            aeloss.backward()
        finally:
            self.disc.requires_grad_(True)
        if not cfg.learn_logvar:
            # a zero gradient, not none: AdamW still decays it, as optax does
            self.logvar.grad = torch.zeros_like(self.logvar)
        lr_g, lr_d = self.sched_g(step), self.sched_d(step)
        self._update(self.opt_g, self.params_g, lr_g)

        discloss, logs_d, (real, fake) = discriminator_loss(
            cfg=cfg, disc=self.disc, x=x, xrec=xrec, global_step=step,
            lecam_ema_real=self.lecam[0], lecam_ema_fake=self.lecam[1], compute_dtype=cd)
        self.opt_d.zero_grad(set_to_none=True)
        discloss.backward()
        self._update(self.opt_d, list(self.disc.parameters()), lr_d)
        self.lecam = torch.stack([real, fake]).detach()

        self.step += 1
        return {"train/aeloss": aeloss.detach(), "train/discloss": discloss.detach(),
                "train/lr_g": x.new_tensor(lr_g), "train/lr_d": x.new_tensor(lr_d),
                **logs_g, **logs_d}
