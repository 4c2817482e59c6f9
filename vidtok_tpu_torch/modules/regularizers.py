"""Latent regularizers (``vidtok_tpu/modules/regularizers.py``): the
diagonal-Gaussian KL regularizer (``:22-81``) and Finite Scalar
Quantization (``:84-236``), with several codebooks and projections.

Latents are channels-last: ``[B, T', H', W', 2C]`` posterior parameters,
or ``[B, T', H', W', D]`` for FSQ, whose math runs in f32 throughout. On
an H slab of ``VideoTokenizer.forward_sharded`` (``parallel/mesh.py``) the
KL's per-sample sum and FSQ's means are taken over the slabs, and a
sample draws the whole latent's noise and keeps the slab's rows.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
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

    @property
    def var(self):
        return torch.exp(self.logvar.float())

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

    def nll(self, sample):
        """0.5 * sum(log(2 pi) + logvar + (sample - mean)^2 / var) over all
        non-batch dims, in f32."""
        m = self.mean.float()
        lv = self.logvar.float()
        return 0.5 * (math.log(2.0 * math.pi) + lv
                      + (sample.float() - m).square() / lv.exp()).flatten(1).sum(1)


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
    static level structure; f32 codes, int32 indices. The math is per
    codebook on the last axis (``codebook_dim`` values); ``num_codebooks``
    is the structure's count of them, which the regularizer lays out as
    ``[..., num_codebooks, codebook_dim]``."""

    def __init__(self, levels: Sequence[int], num_codebooks: int = 1):
        self.levels = tuple(int(v) for v in levels)
        self.num_codebooks = int(num_codebooks)
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


def _lecun_(linear: nn.Linear, generator: torch.Generator = None) -> None:
    """flax's ``nn.Dense`` init: a lecun-normal kernel (a normal truncated
    at 2 sigma, rescaled to unit variance, over fan-in) and a zero bias,
    drawn in f32 on the CPU."""
    w = torch.empty(linear.weight.shape, dtype=torch.float32)
    w.normal_(0.0, 1.0, generator=generator).clamp_(-2.0, 2.0)
    with torch.no_grad():
        linear.weight.copy_(w.mul_(math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978))
        linear.bias.zero_()


class FSQRegularizer(nn.Module):
    """FSQ bottleneck (``regularizers.py:133-236``). z ``[B, T', H', W',
    dim]`` -> (codes in z.dtype, {``indices`` int32, ``aux_loss``}).

    With ``num_codebooks`` c > 1 the ``c * d`` channels (d = len(levels))
    are c codebooks of d values each: codes ``[..., c, d]`` internally and
    indices ``[B, T', H', W', c]`` (``[B, T', H', W']`` for one codebook).
    ``dim`` defaults to ``c * d``; any other value puts ``project_in =
    Linear(dim, c * d)`` before the quantizer and ``project_out =
    Linear(c * d, dim)`` after it (the reference's names, so a reference
    checkpoint loads). Everything runs in f32: the projections take f32
    weights on the f32 latent and on the f32 codes, and the result is cast
    to z.dtype at the end. JAX rounds the codes to z.dtype before
    ``project_out`` and returns its f32 result; the two agree in f32, and
    in bf16 wherever the codes are exact in bf16 (every level whose half
    width is a power of two, as 8, 5 and 16).

    The entropy and commitment losses are computed on every call whose
    weights are > 0, as in JAX (a ``[positions, c, codebook_size]`` f32
    softmax at ``inv_temperature``): the per-sample entropy is a mean over
    positions and codebooks, the codebook entropy a mean over codebooks of
    the entropy of each one's average probability (``[c, K]``), weighted by
    ``diversity_gamma``; the entropy weight anneals from
    ``annealing_factor`` x weight to weight over ``annealing_steps`` steps
    of ``n_steps``. Codes pass gradients straight through the rounding;
    the commitment loss stops the codes' gradient. With ``global_batch``
    (the training forward) the average probability is the global batch's
    in a multi-process run (an autograd all-reduce), as JAX's mean over the
    sharded batch is; any other call stays local, so serving runs no
    collective."""

    def __init__(self, levels: Sequence[int], dim: Optional[int] = None,
                 num_codebooks: int = 1, entropy_loss_weight: float = 0.0,
                 entropy_loss_annealing_steps: int = 0,
                 entropy_loss_annealing_factor: float = 1.0,
                 commitment_loss_weight: float = 0.0, diversity_gamma: float = 1.0,
                 inv_temperature: float = 100.0):
        super().__init__()
        self.fsq = FSQ(levels, num_codebooks)
        self.num_codebooks = self.fsq.num_codebooks
        self.dim = self.effective_dim if dim is None else int(dim)
        if self.has_projections:
            self.project_in = nn.Linear(self.dim, self.effective_dim)
            self.project_out = nn.Linear(self.effective_dim, self.dim)
        self.entropy_loss_weight = entropy_loss_weight
        self.annealing_steps = entropy_loss_annealing_steps
        self.annealing_factor = entropy_loss_annealing_factor
        self.commitment_loss_weight = commitment_loss_weight
        self.diversity_gamma = diversity_gamma
        self.inv_temperature = inv_temperature

    @property
    def effective_dim(self) -> int:
        """The quantized channels, ``num_codebooks * len(levels)``."""
        return self.num_codebooks * self.fsq.codebook_dim

    @property
    def has_projections(self) -> bool:
        return self.dim != self.effective_dim

    def reset_params(self, generator: torch.Generator = None) -> None:
        """The projections as JAX initializes them (``_lecun_``)."""
        if self.has_projections:
            _lecun_(self.project_in, generator)
            _lecun_(self.project_out, generator)

    @staticmethod
    def _linear(m: nn.Linear, x):
        return F.linear(x, m.weight.float(), m.bias.float())

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
        if self.has_projections:
            zf = self._linear(self.project_in, zf)
        lead = zf.shape[:-1]
        c, d = self.num_codebooks, self.fsq.codebook_dim
        zf = zf.reshape(lead + (c, d))
        codes = self.fsq.quantize(zf)                            # [..., c, d]
        indices = self.fsq.codes_to_indices(codes)               # [..., c]
        aux = zf.new_zeros(())
        if self.entropy_loss_weight > 0 or self.commitment_loss_weight > 0:
            codebook = self.fsq.implicit_codebook(z.device)      # [K, d]
            distance = -2.0 * torch.einsum("...cd,kd->...ck", zf, codebook)
            prob = torch.softmax(-distance * self.inv_temperature, dim=-1)
            logp = torch.log(prob.clamp_min(1e-5))
            per_sample_entropy = over_slabs((-prob * logp).sum(-1).mean())
            avg_prob = over_slabs(prob.reshape(-1, c, prob.shape[-1]).mean(0))
            if global_batch:
                avg_prob = global_mean(avg_prob)
            avg_logp = torch.log(avg_prob.clamp_min(1e-5))
            codebook_entropy = (-avg_prob * avg_logp).sum(-1).mean()
            entropy = per_sample_entropy - self.diversity_gamma * codebook_entropy
            commit = over_slabs((zf - codes.detach()).square().mean())
            aux = (entropy * self.entropy_weight(n_steps)
                   + commit * self.commitment_loss_weight)
        out = codes.reshape(lead + (self.effective_dim,))
        if self.has_projections:
            out = self._linear(self.project_out, out)
        if c == 1:
            indices = indices.reshape(lead)
        return out.to(z.dtype), {"indices": indices, "aux_loss": aux}

    def decode_indices(self, indices):
        """indices ``[B, T', H', W']`` (``[..., c]`` for c codebooks) -> f32
        latent ``[B, T', H', W', dim]``, ``project_out`` included."""
        codes = self.fsq.indices_to_codes(indices)
        if self.num_codebooks > 1:
            codes = codes.flatten(-2)
        if self.has_projections:
            codes = self._linear(self.project_out, codes)
        return codes
