"""Diagonal-Gaussian KL regularizer (``vidtok_tpu/modules/regularizers.py:22-81``).

Latents are channels-last ``[B, T', H', W', 2C]`` posterior parameters.
FSQ comes with the FSQ configurations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


class DiagonalGaussian:
    """Posterior over channels-last parameters ``[..., 2C]``."""

    def __init__(self, parameters):
        c = parameters.shape[-1] // 2
        self.mean = parameters[..., :c]
        self.logvar = parameters[..., c:].clamp(-30.0, 20.0)

    @property
    def std(self):
        return torch.exp(0.5 * self.logvar.float())

    def sample(self, generator: torch.Generator = None):
        eps = torch.randn(self.mean.shape, generator=generator,
                          dtype=torch.float32, device=self.mean.device)
        return (self.mean.float() + self.std * eps).to(self.mean.dtype)

    def mode(self):
        return self.mean

    def kl(self):
        """0.5 * sum(mean^2 + var - 1 - logvar) over all non-batch dims."""
        m = self.mean.float()
        lv = self.logvar.float()
        return 0.5 * (m.square() + lv.exp() - 1.0 - lv).flatten(1).sum(1)


class DiagonalGaussianRegularizer(nn.Module):
    """``sample=True`` draws from the posterior; otherwise the mode.
    ``kl_loss = sum(kl) / B``."""

    def __init__(self, sample: bool = True):
        super().__init__()
        self.sample = sample

    def forward(self, z, sample: Optional[bool] = None,
                generator: torch.Generator = None) -> Tuple[torch.Tensor, dict]:
        posterior = DiagonalGaussian(z)
        do_sample = self.sample if sample is None else sample
        out = posterior.sample(generator) if do_sample else posterior.mode()
        kl = posterior.kl()
        return out, {"kl_loss": kl.sum() / kl.shape[0]}
