"""A device mesh over ``torch.distributed`` (``vidtok_tpu/parallel/mesh.py``).

JAX arranges its devices in a ``(data, spatial)`` mesh and lets GSPMD
insert the collectives. Here a :class:`Mesh` arranges the world's ranks
(one process each, on its own card or sharing one, as
:func:`~.distributed.init_distributed` sets them up) in the same grid,
with a process group for every row (``spatial``), every column (``data``)
and all its ranks. ``make_mesh`` creates groups, a collective call: every
process of the world makes the same calls in the same order.

:class:`HeightShard` is what the H-sharded forward
(``VideoTokenizer.forward_sharded``) hands each module for one call: this
rank's slab of the frame height, the halo rows its convs read from the
neighbouring slabs, and the sums its norms, attention and regularizer
take over the slabs. Every exchange gathers each rank's part: NCCL's
``all_gather`` where the group is NCCL's (one process per card); on
gloo, which refuses CUDA tensors in ``send``/``recv`` and ``all_gather``,
an ``all_reduce`` of a zero buffer holding each rank's part in its own
slot (``x + 0`` is exact, at ``size`` times the bytes), so one path serves
gloo on the CPU and gloo on CUDA (several ranks on one card).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .distributed import global_mean


class Mesh:
    """``ranks``: the ``(n_data, n_spatial)`` grid of global ranks;
    ``group`` all of them, ``data_group`` this rank's column (its data
    replicas), ``spatial_group`` its row; a group of one rank is None
    (nothing to reduce). ``index``: this rank's place in ``ranks``
    flattened (row-major, as JAX orders a mesh's devices), None when
    it is not in the mesh."""

    def __init__(self, ranks: np.ndarray, group, data_group, spatial_group,
                 index: Optional[int]):
        self.ranks = ranks
        self.group = group
        self.data_group = data_group
        self.spatial_group = spatial_group
        self.index = index

    @property
    def size(self) -> int:
        return self.ranks.size

    @property
    def shape(self):
        return self.ranks.shape


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The first ``n_data * n_spatial`` of ``ranks`` (default: the world's)
    as an ``(n_data, n_spatial)`` grid; ``n_data`` defaults to as many rows
    as fill it. A single process is a mesh of one rank."""
    ranks = list(range(_world()) if ranks is None else ranks)
    if n_data is None:
        n_data = len(ranks) // n_spatial
    if n_data * n_spatial > len(ranks) or n_data < 1:
        raise ValueError(f"a {n_data} x {n_spatial} mesh needs that many of {len(ranks)} ranks")
    grid = np.array(ranks[:n_data * n_spatial]).reshape(n_data, n_spatial)
    me = _rank()

    def group(members) -> Optional[object]:
        # new_group is collective: every process creates every group
        members = [int(r) for r in members]
        g = dist.new_group(members) if _world() > 1 and len(members) > 1 else None
        return g if me in members else None

    everyone = group(grid.ravel())
    rows = [group(row) for row in grid]
    cols = [group(col) for col in grid.T]
    where = np.argwhere(grid == me)
    if not len(where):
        return Mesh(grid, None, None, None, None)
    d, s = where[0]
    return Mesh(grid, everyone, cols[s], rows[d], int(d * n_spatial + s))


def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from the mesh's first
    rank to all of its ranks (in place); returns ``module``."""
    if mesh.group is not None:
        src = int(mesh.ranks.flat[0])
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=src, group=mesh.group)
    return module


def shard_batch(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's slice of ``x`` along ``axis`` over the data axis: the
    ``n_data`` equal parts in row order."""
    n_data = mesh.shape[0]
    if x.shape[axis] % n_data:
        raise ValueError(f"{x.shape[axis]} along axis {axis} does not split over "
                         f"{n_data} data rows")
    part = x.shape[axis] // n_data
    return x.narrow(axis, (mesh.index // mesh.shape[1]) * part, part)


def shard_of(module: nn.Module) -> Optional["HeightShard"]:
    """The :class:`HeightShard` that ``forward_sharded`` set on ``module``
    for its call, else None (every other forward)."""
    return module.__dict__.get("shard")


class HeightShard:
    """Rank ``index`` of ``size`` holds rows ``[index * h, (index + 1) *
    h)`` of every channels-last activation (H the third axis from the
    end: ``[B, T, H, W, C]`` or ``[N, H, W, C]``), ``h`` its height over
    ``size``. ``parity_kernel``: the nearest temporal upsample runs its
    kernel form on the slab (``modules/blocks.py``); every other block runs
    its plain form."""

    def __init__(self, group, index: int, size: int, parity_kernel: bool = False):
        self.group = group
        self.index = index
        self.size = size
        self.parity_kernel = parity_kernel
        self.nccl = size > 1 and dist.get_backend(group) == "nccl"

    def slab(self, x: torch.Tensor, axis: int = -3) -> torch.Tensor:
        """This rank's rows of a whole tensor."""
        h = x.shape[axis] // self.size
        return x.narrow(axis, self.index * h, h)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the slabs."""
        if self.size == 1:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of equal-sized slabs' means: the data-parallel
        reduction of ``distributed.global_mean`` over this group."""
        return t if self.size == 1 else global_mean(t, self.group)

    def _parts(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every rank's ``x`` (same shape on all)."""
        if self.nccl:
            buf = x.new_empty((self.size,) + tuple(x.shape))
            dist.all_gather(list(buf.unbind(0)), x.contiguous(), group=self.group)
            return buf
        buf = x.new_zeros((self.size,) + tuple(x.shape))
        buf[self.index] = x
        dist.all_reduce(buf, group=self.group)
        return buf

    def gather(self, x: torch.Tensor, axis: int = -3) -> torch.Tensor:
        """The whole tensor from every rank's slab along ``axis``."""
        if self.size == 1:
            return x
        return torch.cat(self._parts(x).unbind(0), dim=axis % x.ndim)

    def halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """``x`` with the ``top`` rows above its slab and the ``bottom``
        rows below it (H axis -3), zeros beyond the frame's top and bottom
        edges, as a conv's zero padding puts there. One exchange: each rank
        gives its first ``bottom`` and last ``top`` rows."""
        if top == 0 and bottom == 0:
            return x
        h = x.shape[-3]
        if h < max(top, bottom):
            raise ValueError(f"a slab of {h} rows is thinner than its halo {top}, {bottom}")
        edges = torch.cat([x.narrow(-3, 0, bottom), x.narrow(-3, h - top, top)], dim=-3)
        parts = self._parts(edges) if self.size > 1 else None
        zero = torch.zeros_like(edges)
        above = (parts[self.index - 1] if self.index > 0 else zero).narrow(-3, bottom, top)
        below = (parts[self.index + 1] if self.index < self.size - 1
                 else zero).narrow(-3, 0, bottom)
        return torch.cat([above, x, below], dim=-3)
