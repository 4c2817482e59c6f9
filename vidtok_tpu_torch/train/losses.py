"""Training losses: L1 + LPIPS with a learned log-variance, the PatchGAN
terms with the adaptive weight, LeCAM and the regularizer terms
(``vidtok_tpu/train/losses.py``; reference vidtok/modules/losses.py,
``GeneralLPIPSWithDiscriminator``).

Video tensors are channels-last ``[B, T, H, W, C]`` in [-1, 1], as the
model's; the discriminator and LPIPS take channels-first tensors (the 2D
discriminator and LPIPS per frame). Loss arithmetic is f32.

The adaptive GAN weight is the reference's: the norms of the gradients of
the NLL and of the generator loss with respect to the decoder's last
weight (``conv_out``, VidTwin's ``final_layer.linear``;
``torch.autograd.grad(..., retain_graph=True)``),
which equals JAX's split through the reconstruction's cotangent
(``losses.py:189-230``). In a multi-process run the two gradients are
averaged over the processes first, and LeCAM's EMAs take the global
logit means, as JAX's global batch gives them.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..modules.discriminator import NLayerDiscriminator, NLayerDiscriminator3D
from ..parallel.distributed import mean_


class LossConfig(NamedTuple):
    disc_start: int = 20001
    logvar_init: float = 0.0
    pixelloss_weight: float = 1.0
    disc_num_layers: int = 3
    disc_in_channels: int = 3
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    disc_type: str = "3d"
    use_actnorm: bool = False
    perceptual_weight: float = 1.0
    lecam_loss_weight: float = 0.0
    disc_loss: str = "hinge"
    learn_logvar: bool = False
    gen_loss_cross_entropy: bool = False
    regularization_weights: Optional[Dict[str, float]] = None
    # the reference's global_step counts both optimizers' steps; ``step``
    # counts batches, so the gates read 2 * step
    step_scale: int = 2
    # recompute LPIPS's VGG trunk in the backward
    lpips_remat: bool = True

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "LossConfig":
        d = dict(d or {})
        return cls(**{k: v for k, v in d.items() if k in cls._fields})


def make_discriminator(cfg: LossConfig):
    cls = NLayerDiscriminator if cfg.disc_type == "2d" else NLayerDiscriminator3D
    return cls(input_nc=cfg.disc_in_channels, n_layers=cfg.disc_num_layers,
               use_actnorm=cfg.use_actnorm)


def fold_frames(x):
    """``[B, T, ...]`` -> ``[B*T, ...]``."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def autocast(device: torch.device, dtype: Optional[torch.dtype]):
    """``torch.autocast`` to ``dtype`` for the plain ``nn`` modules (the
    discriminator, LPIPS); no context for f32."""
    if dtype is None:
        return nullcontext()
    return torch.autocast(device.type, dtype)


def apply_disc(disc, x, cfg: LossConfig, compute_dtype=None):
    """Logits (f32) of channels-last video ``x``: the 2D discriminator per
    frame, the 3D one on the clip. The discriminator stays in train mode
    (batch statistics), as in the reference."""
    if cfg.disc_type == "2d":
        inp = fold_frames(x).permute(0, 3, 1, 2)
    else:
        inp = x.permute(0, 4, 1, 2, 3)
    with autocast(x.device, compute_dtype):
        return disc(inp).float()


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def non_saturate_gen_loss(logits_fake):
    """Each sample's mean logit, BCE toward 'real' (reference :43-51)."""
    lf = logits_fake.reshape(logits_fake.shape[0], -1).mean(-1)
    return F.softplus(-lf).mean()


def adopt_weight(weight: float, global_step: int, threshold: int) -> float:
    return 0.0 if global_step < threshold else weight


def lecam_reg(logits_real, logits_fake, ema_real, ema_fake):
    return (F.relu(logits_real - ema_fake).square().mean()
            + F.relu(ema_real - logits_fake).square().mean())


def perceptual_loss(lpips, x_frames, y_frames, cfg: LossConfig, compute_dtype=None):
    """Per-frame LPIPS ``[N, 1, 1, 1]`` (f32) of channels-last frames,
    recomputed in the backward when ``cfg.lpips_remat``."""
    a, b = (t.permute(0, 3, 1, 2) for t in (x_frames, y_frames))
    if compute_dtype is not None:
        a, b = a.to(compute_dtype), b.to(compute_dtype)

    def fn(u, v):
        with autocast(u.device, compute_dtype):
            return lpips(u, v).float()

    if cfg.lpips_remat and torch.is_grad_enabled():
        return checkpoint(fn, a, b, use_reentrant=False)
    return fn(a, b)


def adaptive_ratio(nll_loss, g_loss, last_layer):
    """The adaptive weight before its clip and ``disc_weight``: the norm of
    the NLL's gradient over that of the generator loss's (+1e-4), both
    with respect to ``last_layer`` and averaged over the processes."""
    nll_grad, = torch.autograd.grad(nll_loss, last_layer, retain_graph=True)
    g_grad, = torch.autograd.grad(g_loss, last_layer, retain_graph=True)
    mean_((nll_grad, g_grad))
    return nll_grad.float().norm() / (g_grad.float().norm() + 1e-4)


def generator_loss(*, cfg: LossConfig, lpips, disc, last_layer, logvar, x, xrec,
                   reg_log: dict, global_step: int, split: str = "train",
                   compute_dtype=None):
    """(loss, logs). ``last_layer`` is the weight the model's adaptive GAN
    weight reads (VidTok's decoder ``conv_out``, VidTwin's decoder
    ``final_layer.linear``), whose gradients give the adaptive weight;
    ``xrec`` must depend on it through the graph."""
    xf, rf = fold_frames(x).float(), fold_frames(xrec)
    rec = (xf - rf.float()).abs()
    if cfg.perceptual_weight > 0:
        p = perceptual_loss(lpips, xf, rf, cfg, compute_dtype)
        rec = rec + cfg.perceptual_weight * p
        p_mean = p.mean()
    else:
        p_mean = rec.new_zeros(())
    nll = rec / torch.exp(logvar) + logvar
    nll_loss = nll.sum() / nll.shape[0]

    logits_fake = apply_disc(disc, xrec, cfg, compute_dtype)
    if cfg.gen_loss_cross_entropy:
        g_loss = non_saturate_gen_loss(logits_fake)
    else:
        g_loss = -logits_fake.mean()
    disc_factor = adopt_weight(cfg.disc_factor, global_step * cfg.step_scale,
                               cfg.disc_start)

    if cfg.disc_factor > 0.0:
        d_weight = adaptive_ratio(nll_loss, g_loss, last_layer)
        d_weight = d_weight.clamp(0.0, 1e4).detach() * cfg.disc_weight
    else:
        d_weight = rec.new_zeros(())

    loss = nll_loss + d_weight * disc_factor * g_loss
    logs = {
        f"{split}/logvar": logvar.detach().clone(),
        f"{split}/nll_loss": nll_loss.detach(),
        f"{split}/rec_loss": rec.detach().mean(),
        f"{split}/p_loss": p_mean.detach(),
        f"{split}/d_weight": d_weight,
        f"{split}/disc_factor": rec.new_tensor(disc_factor),
        f"{split}/g_loss": g_loss.detach(),
    }
    for k, w in (cfg.regularization_weights or {}).items():
        if k in reg_log:
            loss = loss + w * reg_log[k].float()
            logs[f"{split}/{k}"] = reg_log[k].detach().float()
    logs[f"{split}/total_loss"] = loss.detach()
    return loss, logs


def discriminator_loss(*, cfg: LossConfig, disc, x, xrec, global_step: int,
                       lecam_ema_real, lecam_ema_fake, split: str = "train",
                       compute_dtype=None):
    """(d_loss, logs, (new LeCAM EMA of the real logits, of the fake)):
    the discriminator on ``x`` then on ``xrec``, neither carrying a
    gradient to the generator."""
    logits_real = apply_disc(disc, x.detach(), cfg, compute_dtype)
    logits_fake = apply_disc(disc, xrec.detach(), cfg, compute_dtype)
    disc_factor = adopt_weight(cfg.disc_factor, global_step * cfg.step_scale,
                               cfg.disc_start)
    loss_fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    non_sat = loss_fn(logits_real, logits_fake)
    if cfg.lecam_loss_weight > 0:
        decay = 0.999
        means = torch.stack([logits_real.mean(), logits_fake.mean()]).detach()
        mean_((means,))
        new_real = lecam_ema_real * decay + means[0] * (1 - decay)
        new_fake = lecam_ema_fake * decay + means[1] * (1 - decay)
        lecam = lecam_reg(logits_real, logits_fake, new_real, new_fake)
        d_loss = disc_factor * (lecam * cfg.lecam_loss_weight + non_sat)
    else:
        new_real, new_fake = lecam_ema_real, lecam_ema_fake
        lecam = non_sat.new_zeros(())
        d_loss = disc_factor * non_sat
    logs = {
        f"{split}/disc_loss": d_loss.detach(),
        f"{split}/logits_real": logits_real.detach().mean(),
        f"{split}/logits_fake": logits_fake.detach().mean(),
        f"{split}/disc_factor": non_sat.new_tensor(disc_factor),
        f"{split}/non_saturated_d_loss": non_sat.detach(),
        f"{split}/lecam_loss": lecam.detach(),
    }
    return d_loss, logs, (new_real, new_fake)
