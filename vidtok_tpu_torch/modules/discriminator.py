"""PatchGAN discriminators (``vidtok_tpu/modules/discriminator.py``;
reference vidtok/modules/discriminator.py), channels-first as the
reference torch modules, under the reference's names (``main.<i>``), so a
released ``.ckpt``'s ``loss.discriminator.*`` keys load by name.

* :class:`NLayerDiscriminator`: the pix2pix 2D PatchGAN on ``[N, C, H, W]``
  frames: 4x4 convs (stride 2, then 1), BatchNorm, LeakyReLU(0.2).
* :class:`NLayerDiscriminator3D`: 3x3x3 convs on ``[B, C, T, H, W]``,
  time stride 2 only in the first two layers.
* :class:`ActNorm`: per-channel affine initialised from the first batch
  it sees in training mode (``loc = -mean``, ``scale = 1 / (std + 1e-6)``,
  unbiased std), on 4-D or 5-D input; with ``logdet`` it also returns
  each sample's log-determinant (the reference's ``reverse``, which the
  discriminators never use, is left out).

With ``use_actnorm`` the middle convs keep their bias and ActNorm replaces
BatchNorm. BatchNorm is torch's (momentum 0.1, eps 1e-5): in training it
normalises with the batch statistics, and its running variance takes the
unbiased batch variance, where flax's takes the biased one (a factor
``n / (n - 1)`` on that buffer only; nothing in the train step reads it).
In a multi-process run its statistics are the global batch's, as JAX's
are over the sharded batch (:class:`GlobalBatchNorm`).

:func:`reset_params_` initialises as ``weights_init`` does (convs
N(0, 0.02), norm scales N(1, 0.02), norm biases 0) with conv biases 0, as
JAX initialises them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.distributed import world_size


class ActNorm(nn.Module):
    def __init__(self, num_features: int, ndim: int = 4, logdet: bool = False):
        super().__init__()
        self.logdet = logdet
        shape = (1, num_features) + (1,) * (ndim - 2)
        self.loc = nn.Parameter(torch.zeros(shape))
        self.scale = nn.Parameter(torch.ones(shape))
        self.register_buffer("initialized", torch.tensor(0, dtype=torch.uint8))

    @torch.no_grad()
    def initialize(self, x):
        flat = x.transpose(0, 1).reshape(x.shape[1], -1).float()
        self.loc.copy_(-flat.mean(1).view(self.loc.shape))
        self.scale.copy_((1.0 / (flat.std(1) + 1e-6)).view(self.scale.shape))

    def forward(self, x):
        if self.training and self.initialized.item() == 0:
            self.initialize(x)
            self.initialized.fill_(1)
        h = self.scale * (x + self.loc)
        if not self.logdet:
            return h
        # positions x sum(log|scale|), one per sample (``discriminator.py:
        # 64-71``)
        logdet = x[0, 0].numel() * self.scale.abs().log().sum()
        return h, logdet * x.new_ones(x.shape[0])


class GlobalBatchNorm(nn.Module):
    """``nn.BatchNorm{2,3}d`` (same parameters and buffers) whose training
    statistics, in a multi-process run, are those of the global batch: an
    autograd all-reduce of each channel's count, sum and sum of squares
    (torch's ``SyncBatchNorm`` refuses CPU tensors). In one process it is
    ``F.batch_norm``."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if not self.training or world_size() == 1:
            if self.training:
                self.num_batches_tracked.add_(1)
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, self.training, self.momentum, self.eps)
        from torch.distributed.nn.functional import all_reduce

        dims = [0] + list(range(2, x.ndim))
        xf = x.float()
        n = torch.full((1,), x.numel() / x.shape[1], device=x.device)
        stats = all_reduce(torch.cat([n, xf.sum(dims), xf.square().sum(dims)]))
        c = x.shape[1]
        count = stats[0]
        mean = stats[1:1 + c] / count
        var = stats[1 + c:] / count - mean.square()
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * count / (count - 1), self.momentum)
        shape = (1, c) + (1,) * (x.ndim - 2)
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


def _stack(conv, kernel: int, input_nc: int, ndf: int, n_layers: int,
           use_actnorm: bool, strides, ndim: int) -> nn.Sequential:
    """The reference's ``main``: conv, LeakyReLU, then per layer conv, norm,
    LeakyReLU, then the 1-channel conv (``main.{0, 2, 3, 5, 6, ...}``)."""
    def norm(c):
        return ActNorm(c, ndim) if use_actnorm else GlobalBatchNorm(c)

    layers = [conv(input_nc, ndf, kernel, strides[0], 1), nn.LeakyReLU(0.2)]
    nf = 1
    for n in range(1, n_layers + 1):
        prev, nf = nf, min(2 ** n, 8)
        layers += [conv(ndf * prev, ndf * nf, kernel, strides[n], 1, bias=use_actnorm),
                   norm(ndf * nf), nn.LeakyReLU(0.2)]
    layers.append(conv(ndf * nf, 1, kernel, 1, 1))
    return nn.Sequential(*layers)


class NLayerDiscriminator(nn.Module):
    """2D PatchGAN: ``[N, C, H, W]`` -> logits ``[N, 1, H', W']``."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()
        strides = [2] * n_layers + [1]
        self.main = _stack(nn.Conv2d, 4, input_nc, ndf, n_layers, use_actnorm,
                           strides, 4)

    def forward(self, x):
        return self.main(x)


class NLayerDiscriminator3D(nn.Module):
    """3D PatchGAN: ``[B, C, T, H, W]`` -> logits ``[B, 1, T', H', W']``."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()
        strides = [2] + [(2 if n == 1 else 1, 2, 2) for n in range(1, n_layers)] + [1]
        self.main = _stack(nn.Conv3d, 3, input_nc, ndf, n_layers, use_actnorm,
                           strides, 5)

    def forward(self, x):
        return self.main(x)


def reset_params_(disc: nn.Module, generator: torch.Generator = None) -> None:
    """``weights_init``: conv weights N(0, 0.02) and biases 0, norm scales
    N(1, 0.02) and biases 0; drawn on the CPU from ``generator``."""
    def normal(p, mean):
        p.copy_(torch.empty(p.shape).normal_(mean, 0.02, generator=generator))

    with torch.no_grad():
        for m in disc.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                normal(m.weight, 0.0)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, GlobalBatchNorm):
                normal(m.weight, 1.0)
                m.bias.zero_()
