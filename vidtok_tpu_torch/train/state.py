"""Optimizers and the EMA of the train state (``vidtok_tpu/train/state.py``).

Two ``torch.optim.Adam`` (betas 0.9, 0.999, eps 1e-8), each preceded by a
global-norm gradient clip at 20 (``clip_grad_norm_``, which scales by
``max_norm / (norm + 1e-6)`` where optax scales by ``max_norm / norm``),
and LitEma's decay over the generator (core and ``logvar``) and the
discriminator's parameters.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def ema_decay(step: int, decay: float) -> float:
    """LitEma's warm-up: ``min(decay, (1 + n) / (10 + n))`` at step ``n``."""
    return min(decay, (1.0 + step) / (10.0 + step))


@torch.no_grad()
def ema_update(shadow: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               step: int, decay: float) -> None:
    """``shadow -= (1 - d) * (shadow - param)`` in place, ``d`` =
    :func:`ema_decay` (``state.py:36-42``)."""
    shadow, params = list(shadow), [p.detach() for p in params]
    diff = torch._foreach_sub(shadow, params)
    torch._foreach_mul_(diff, 1.0 - ema_decay(step, decay))
    torch._foreach_sub_(shadow, diff)
