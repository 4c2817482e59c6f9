"""Data parallelism over ``torch.distributed`` (``vidtok_tpu/parallel/``:
JAX shards the batch over a mesh and XLA inserts the collectives).

One process per card (``torchrun``), or a single process when the
environment names no world; ``mesh.py`` arranges the ranks in JAX's
``(data, spatial)`` mesh for the H-sharded forward. The trainer averages
each optimizer's gradients over the processes after its backward (what
DDP's reducer does, without overlapping the reduction with the
backward), and the few batch-coupled statistics that JAX computes over
the global batch are reduced explicitly, in the train step only: FSQ's
codebook probabilities (autograd-aware, the codebook entropy is not
linear in the batch), the adaptive GAN weight's two ``conv_out``
gradients, LeCAM's logit means and the discriminator's BatchNorm
statistics (``modules/discriminator.py``).
"""

from __future__ import annotations

import os
from typing import Iterable

import torch
import torch.distributed as dist


def init_distributed(backend: str = None, init_method: str = None,
                     world_size: int = None, rank: int = None,
                     device_index: int = None) -> bool:
    """Join the process group named by the arguments, else by ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``).
    Returns False, and does nothing, for a single process. The backend is
    NCCL when CUDA is available, else gloo; with CUDA each process takes the
    card ``device_index`` names, by default ``LOCAL_RANK``'s (several gloo
    ranks on one card pass 0: NCCL refuses two ranks on one device)."""
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if dist.is_initialized():
        return True
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              if device_index is None else device_index)
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if world_size() > 1 else 0


def is_main_process() -> bool:
    return rank() == 0


def local_batch_slice(global_batch: int) -> int:
    """Each process's share of a batch split over the processes; an uneven
    split raises."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} does not split over {n} processes")
    return global_batch // n


def global_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``t`` over the processes (of ``group``, default all),
    differentiable (the backward all-reduces the gradient); ``t`` itself
    for one process."""
    n = world_size() if group is None else dist.get_world_size(group)
    if n == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=dist.group.WORLD if group is None else group) / n


def mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Average tensors over the processes in place, in one flat all-reduce
    (no autograd)."""
    n = world_size()
    tensors = [t for t in tensors if t is not None]
    if n == 1 or not tensors:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat)
    flat /= n
    for t, v in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(v)


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Average the ``.grad`` of ``params`` over the processes."""
    with torch.no_grad():
        mean_(p.grad for p in params)
