"""A rank's groups along the axes of a train mesh, and the collectives
that the model code writes out.

In the JAX package one program sees the whole mesh and XLA's GSPMD
inserts the collectives (``rafiki_tpu/parallel/sharding.py``). Here every
rank is a process on its own device running the same step on its own
shards (``parallel/ranks.py``), so each collective is written where the
model needs it. :class:`MeshGroups` is one rank's view of a mesh: its
coordinates and, for each axis of more than one device, the group of the
ranks that differ from it on that axis alone (a line of the mesh). A
line's group is made by its members alone, every rank making its groups
in the same axis order.

The operators are autograd functions, each with its conjugate as its
backward. Two conventions are kept, one for each kind of axis:

- over ``model``, ``expert`` and ``pipe`` a computation outside a split
  region is replicated, and its gradient on every rank is the whole one
  (Megatron's): :func:`copy_to` enters a split region (identity forward,
  sum backward), :func:`reduce_from` leaves it (sum forward, identity
  backward), :func:`gather_whole` gathers a sharded leaf for a
  replicated use (its backward keeps this rank's part);
- over ``data`` and ``seq`` (the batch axes, ``sharding.GRAD_AXES``)
  every rank holds its share: the loss of its rows and tokens, a
  gradient whose sum over the ranks is the whole one. :func:`psum` sums
  a share into a replicated value and its backward sums again;
  :func:`all_gather` (its backward a reduce-scatter) gathers the keys
  and values of a sharded sequence.

:func:`ppermute` sends along a permutation and its backward along the
inverse. Each collective on a group of one device is the identity. Every
collective runs in one form on NCCL and on gloo: a reduce-scatter is a
sum and a slice, a permutation one all-to-all (``DataGroup.exchange``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from rafiki_tpu_torch.parallel.mesh import Mesh
from rafiki_tpu_torch.parallel.ranks import DataGroup


class MeshGroups:
    """One rank's view of a train mesh: ``rank`` (its place in the
    mesh's row-major order), its ``coords``, its ``device`` and its
    group along each axis of more than one device (``groups``)."""

    def __init__(self, mesh: Mesh, rank: int, device: torch.device,
                 groups: Dict[str, DataGroup]):
        self.mesh = mesh
        self.rank = rank
        self.device = device
        self.coords = mesh.coords(rank)
        self.groups = groups

    @classmethod
    def create(cls, mesh: Mesh, world: Optional[DataGroup]) -> "MeshGroups":
        """This rank's view of ``mesh`` over the ranks of ``world`` (rank
        r of the mesh is rank r of the world; None on a mesh of one
        device, which then runs on its first device)."""
        if world is None:
            if mesh.size != 1:
                raise ValueError(f"a mesh of {mesh.size} devices needs a "
                                 "group of as many ranks")
            return cls(mesh, 0, mesh.devices[0], {})
        if world.size != mesh.size:
            raise ValueError(f"a mesh of {mesh.size} devices over a group "
                             f"of {world.size} ranks")
        groups = {}
        for axis, n in mesh.shape.items():
            if n > 1:
                groups[axis] = world.subgroup(mesh.line(axis, world.rank))
        return cls(mesh, world.rank, world.device, groups)

    def size(self, axis: str) -> int:
        return self.mesh.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str) -> Optional[DataGroup]:
        """The group along ``axis``; None where it has one device."""
        return self.groups.get(axis)

    def close(self) -> None:
        for g in self.groups.values():
            g.close()
        self.groups = {}


def _sum(t: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """A contiguous copy of ``t`` summed over ``group``."""
    out = t.clone(memory_format=torch.contiguous_format)
    return group.all_reduce_(out)


def _gather(t: torch.Tensor, group: DataGroup, dim: int) -> torch.Tensor:
    return torch.cat(group.all_gather(t).unbind(0), dim)


def _part(t: torch.Tensor, group: DataGroup, dim: int) -> torch.Tensor:
    return t.chunk(group.size, dim)[group.rank].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _part(_sum(grad, ctx.group), ctx.group, ctx.dim), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _part(grad, ctx.group, ctx.dim), None, None


def _route(group: DataGroup, perm: Sequence[Tuple[int, int]]
           ) -> Tuple[Optional[int], Optional[int]]:
    """(where this rank sends, whence it receives) under ``perm``."""
    dst = next((d for s, d in perm if s == group.rank), None)
    src = next((s for s, d in perm if d == group.rank), None)
    return dst, src


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        dst, src = _route(group, perm)
        out = group.exchange(x if dst is not None else None, dst, src,
                             x.shape, x.dtype)
        return out if out is not None else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.perm]
        dst, src = _route(ctx.group, inverse)
        out = ctx.group.exchange(grad if dst is not None else None, dst,
                                 src, grad.shape, grad.dtype)
        return (out if out is not None else torch.zeros_like(grad)), None, \
            None


class _Fetch(torch.autograd.Function):
    """One layer's leaves from the rank that holds them: a broadcast of
    their flat concatenation, and back the owner's own gradient (every
    rank of the line computed the same one)."""

    @staticmethod
    def forward(ctx, group, owner, *leaves):
        ctx.group, ctx.owner = group, owner
        ctx.shapes = [t.shape for t in leaves]
        flat = torch.cat([t.detach().reshape(-1) for t in leaves])
        group.broadcast_(flat, src=owner)
        return tuple(part.view(shape) for part, shape in zip(
            flat.split([s.numel() for s in ctx.shapes]), ctx.shapes))

    @staticmethod
    def backward(ctx, *grads):
        if ctx.group.rank != ctx.owner:
            return (None, None) + (None,) * len(grads)
        return (None, None) + grads


def copy_to(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """Enter a split region over ``group``: identity forward, the sum of
    the ranks' gradients backward."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Optional[DataGroup]
                ) -> torch.Tensor:
    """Leave a split region over ``group``: the ranks' partial values
    summed forward, the (replicated) gradient as it is backward."""
    return x if group is None else _ReduceFrom.apply(x, group)


def psum(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """The sum of the ranks' shares over ``group``, forward and
    backward (JAX's ``psum`` and its transpose)."""
    return x if group is None else _Psum.apply(x, group)


def all_gather(x: torch.Tensor, group: Optional[DataGroup],
               dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` in rank order; backward,
    the gradient summed over the ranks and this rank's part of it."""
    return x if group is None else _AllGather.apply(x, group, dim)


def gather_whole(x: torch.Tensor, group: Optional[DataGroup],
                 dim: int) -> torch.Tensor:
    """A leaf sharded on ``dim`` over ``group``, whole, for a use that
    every rank computes alike; backward, this rank's part of the
    gradient."""
    return x if group is None else _GatherWhole.apply(x, group, dim)


def ppermute(x: torch.Tensor, group: Optional[DataGroup],
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``x`` sent from rank s to rank d for each (s, d) of ``perm``
    (group ranks); a rank that receives nothing gets zeros. Backward,
    the gradient along the inverse permutation."""
    if group is None:
        return x
    return _PPermute.apply(x, group, tuple(tuple(p) for p in perm))


def fetch(leaves: List[torch.Tensor], group: Optional[DataGroup],
          owner: int) -> List[torch.Tensor]:
    """``owner``'s ``leaves`` on every rank of ``group`` (each rank
    passes tensors of the same shapes; the others' values are not
    read); backward, the owner keeps its gradient."""
    if group is None:
        return list(leaves)
    return list(_Fetch.apply(group, owner, *leaves))


def sum_over(x: torch.Tensor, groups: MeshGroups,
             axes: Sequence[str]) -> torch.Tensor:
    """``x`` (no gradient) summed over the ranks of ``axes``."""
    for axis in axes:
        g = groups.group(axis)
        if g is not None:
            x = _sum(x, g)
    return x


def gather_over(x: torch.Tensor, groups: MeshGroups, axis: str,
                dim: int = 0) -> torch.Tensor:
    """``x`` (no gradient) gathered over ``axis``, stacked on a new
    ``dim``."""
    g = groups.group(axis)
    if g is None:
        return x.unsqueeze(dim)
    return g.all_gather(x).movedim(0, dim)
