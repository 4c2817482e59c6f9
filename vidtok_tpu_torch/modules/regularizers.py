"""Latent regularizers (``vidtok_tpu/modules/regularizers.py``): the
diagonal-Gaussian KL regularizer (``:22-81``) and Finite Scalar
Quantization (``:84-236``).

Latents are channels-last: ``[B, T', H', W', 2C]`` posterior parameters,
or ``[B, T', H', W', D]`` for FSQ, whose math runs in f32 throughout. On
an H slab of ``VideoTokenizer.forward_sharded`` (``parallel/mesh.py``) the
KL's per-sample sum and FSQ's means are taken over the slabs, and a
sample draws the whole latent's noise and keeps the slab's rows.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..parallel.distributed import global_mean
from ..parallel.mesh import shard_of


class DiagonalGaussian:
    """Posterior over channels-last parameters ``[..., 2C]``."""

    def __init__(self, parameters):
        c = parameters.shape[-1] // 2
        self.mean = parameters[..., :c]
        self.logvar = parameters[..., c:].clamp(-30.0, 20.0)

    @property
    def std(self):
        return torch.exp(0.5 * self.logvar.float())

    def sample(self, generator: torch.Generator = None, shard=None):
        """With a ``HeightShard``, the whole latent's noise is drawn and the
        slab's rows kept, so that a sharded run draws what one process
        does."""
        shape = list(self.mean.shape)
        if shard is not None:
            shape[-3] *= shard.size
        eps = torch.randn(shape, generator=generator, dtype=torch.float32,
                          device=self.mean.device)
        if shard is not None:
            eps = shard.slab(eps)
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
                generator: torch.Generator = None, n_steps: int = 0,
                global_batch: bool = False) -> Tuple[torch.Tensor, dict]:
        """``n_steps`` and ``global_batch`` are unused (FSQ's losses read
        them)."""
        shard = shard_of(self)
        posterior = DiagonalGaussian(z)
        do_sample = self.sample if sample is None else sample
        out = posterior.sample(generator, shard) if do_sample else posterior.mode()
        kl = posterior.kl()
        if shard is not None:  # H sharded: the per-sample sums over the slabs
            kl = shard.sum(kl)
        return out, {"kl_loss": kl.sum() / kl.shape[0]}


def round_ste(z):
    """``round(z)`` forward, identity backward (the straight-through
    estimator, ``regularizers.py:84-86``)."""
    return z + (torch.round(z) - z).detach()


class FSQ:
    """Finite Scalar Quantization math (``regularizers.py:88-130``) over a
    static level structure; f32 codes, int32 indices."""

    def __init__(self, levels: Sequence[int]):
        self.levels = tuple(int(v) for v in levels)
        self.codebook_dim = len(self.levels)
        basis = [1]
        for v in self.levels[:-1]:
            basis.append(basis[-1] * v)
        self.basis = tuple(basis)
        self.codebook_size = basis[-1] * self.levels[-1]

    def _consts(self, device):
        lv = torch.tensor(self.levels, dtype=torch.int32, device=device)
        basis = torch.tensor(self.basis, dtype=torch.int32, device=device)
        return lv, basis, (lv // 2).float()

    def bound(self, z, eps: float = 1e-3):
        lv, _, _ = self._consts(z.device)
        half_l = (lv.float() - 1) * (1 + eps) / 2
        offset = (lv % 2 == 0).float() * 0.5
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    def quantize(self, z):
        _, _, half_width = self._consts(z.device)
        return round_ste(self.bound(z)) / half_width

    def codes_to_indices(self, codes):
        _, basis, half_width = self._consts(codes.device)
        scaled = codes * half_width + half_width
        return (scaled * basis.float()).sum(-1).to(torch.int32)

    def indices_to_codes(self, indices):
        lv, basis, half_width = self._consts(indices.device)
        non_centered = (indices.long()[..., None] // basis) % lv
        return (non_centered.float() - half_width) / half_width

    def implicit_codebook(self, device=None):
        return self.indices_to_codes(torch.arange(self.codebook_size, device=device))


# the JAX regularizer's defaults, which no config overrides
_DIVERSITY_GAMMA = 1.0
_INV_TEMPERATURE = 100.0


class FSQRegularizer(nn.Module):
    """FSQ bottleneck (``regularizers.py:133-236``) with one codebook and no
    projections, as every FSQ config sets it. z ``[B, T', H', W', D]`` ->
    (codes in z.dtype, {``indices`` int32 ``[B, T', H', W']``,
    ``aux_loss``}). The entropy and commitment losses are computed on every
    call whose weights are > 0, as in JAX (a ``[positions, codebook_size]``
    f32 softmax); the entropy weight anneals from ``annealing_factor`` x
    weight to weight over ``annealing_steps`` steps of ``n_steps``. Codes
    pass gradients straight through the rounding; the commitment loss
    stops the codes' gradient. With ``global_batch`` (the training
    forward) the codebook entropy's average probability is the global
    batch's in a multi-process run (an autograd all-reduce), as JAX's mean
    over the sharded batch is; any other call stays local, so serving runs
    no collective."""

    def __init__(self, levels: Sequence[int], dim: Optional[int] = None,
                 num_codebooks: int = 1, entropy_loss_weight: float = 0.0,
                 entropy_loss_annealing_steps: int = 0,
                 entropy_loss_annealing_factor: float = 1.0,
                 commitment_loss_weight: float = 0.0):
        super().__init__()
        if num_codebooks != 1:
            raise NotImplementedError("FSQ with num_codebooks != 1 is not ported")
        self.fsq = FSQ(levels)
        if dim is not None and dim != self.fsq.codebook_dim:
            raise NotImplementedError("FSQ projections (dim != len(levels)) "
                                      "are not ported")
        self.entropy_loss_weight = entropy_loss_weight
        self.annealing_steps = entropy_loss_annealing_steps
        self.annealing_factor = entropy_loss_annealing_factor
        self.commitment_loss_weight = commitment_loss_weight

    def entropy_weight(self, n_steps) -> float:
        w = self.entropy_loss_weight
        if self.annealing_steps == 0 or n_steps >= self.annealing_steps:
            return w
        start = self.annealing_factor * w
        return start - (n_steps / self.annealing_steps) * (start - w)

    def forward(self, z, sample: Optional[bool] = None,
                generator: torch.Generator = None, n_steps: int = 0,
                global_batch: bool = False):
        """``sample`` and ``generator`` are unused (FSQ is deterministic)."""
        shard = shard_of(self)
        # H sharded: the means over positions are the slabs' (equal sizes)
        over_slabs = shard.mean if shard is not None else (lambda t: t)
        zf = z.float()
        codes = self.fsq.quantize(zf)
        indices = self.fsq.codes_to_indices(codes)
        aux = zf.new_zeros(())
        if self.entropy_loss_weight > 0 or self.commitment_loss_weight > 0:
            codebook = self.fsq.implicit_codebook(z.device)      # [K, d]
            distance = -2.0 * torch.einsum("...d,kd->...k", zf, codebook)
            prob = torch.softmax(-distance * _INV_TEMPERATURE, dim=-1)
            logp = torch.log(prob.clamp_min(1e-5))
            per_sample_entropy = over_slabs((-prob * logp).sum(-1).mean())
            avg_prob = over_slabs(prob.reshape(-1, prob.shape[-1]).mean(0))
            if global_batch:
                avg_prob = global_mean(avg_prob)
            avg_logp = torch.log(avg_prob.clamp_min(1e-5))
            codebook_entropy = (-avg_prob * avg_logp).sum()
            entropy = per_sample_entropy - _DIVERSITY_GAMMA * codebook_entropy
            commit = over_slabs((zf - codes.detach()).square().mean())
            aux = (entropy * self.entropy_weight(n_steps)
                   + commit * self.commitment_loss_weight)
        return codes.to(z.dtype), {"indices": indices, "aux_loss": aux}

    def decode_indices(self, indices):
        """indices ``[B, T', H', W']`` -> f32 latent ``[B, T', H', W', D]``."""
        return self.fsq.indices_to_codes(indices)
