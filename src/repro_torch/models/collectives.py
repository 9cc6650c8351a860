"""The mesh path's collectives over ``torch.distributed`` process groups.

The reference leaves its collectives to XLA's SPMD partitioner (and one
explicit ``psum`` in the MoE's ``shard_map``). The port computes on
rank-local blocks instead, and makes each collective itself, over the
process group of one mesh axis (``DeviceMesh.get_group(axis)``):

  gather_param   a leaf's full value from this rank's shard (all-gathers
                 along the sharded mesh dims); its backward sums the full
                 gradient over the batch axes (all-reduce) and keeps this
                 rank's shard of it
  reduce_sum     all-reduce SUM forward, identity backward
  copy_to        identity forward, all-reduce SUM backward
  scale_grad     identity forward, the gradient scaled backward

Gradient convention: every rank computes the GLOBAL objective's value, and
its backward gives the contribution of the rows it holds. Gradients are
then summed over the batch axes (``gather_param``'s backward); ranks that
differ only along a replicated axis ("model" under the tensor-parallel
rules) hold the same rows and compute the same gradient, so nothing is
summed over it. ``reduce_sum`` is the forward of a quantity summed over
ranks (each rank then holds the global value, and the gradient reaching
it is the one its own term takes); ``copy_to`` marks where partial
gradients of a replicated input must be summed (the expert-parallel MoE,
where each rank reaches only its own experts).

Every collective is counted (``collective_counts``), as the distributed
executor counts its own, with its wire bytes per rank beside the count
(``collective_bytes``; the reference's ring formulas, ``hloparse.py``):
an all-gather of a result of R bytes over g ranks moves (g - 1) / g · R,
an all-reduce of S bytes 2 (g - 1) / g · S.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.models import base

Tensor = torch.Tensor

_COUNTS = {"all_gather": 0, "all_reduce": 0}
_BYTES = {"all_gather": 0.0, "all_reduce": 0.0}


def collective_counts() -> dict[str, int]:
    """Collectives issued by the mesh path since ``reset_collective_counts``."""
    return dict(_COUNTS)


def collective_bytes() -> dict[str, float]:
    """Wire bytes per rank of those collectives, by kind (ring formulas)."""
    return dict(_BYTES)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0
        _BYTES[k] = 0.0


def _all_reduce(x: Tensor, group, op=dist.ReduceOp.SUM) -> None:
    g = dist.get_world_size(group)
    _COUNTS["all_reduce"] += 1
    _BYTES["all_reduce"] += 2 * (g - 1) / g * x.numel() * x.element_size()
    dist.all_reduce(x, op=op, group=group)


def axis_groups(mesh, axes) -> list:
    """The process groups of the axes of ``axes`` that ``mesh`` has, in
    mesh order (each rank's group along that axis)."""
    return [mesh.get_group(a) for a in base.axis_sizes(mesh) if a in axes]


def coordinate(mesh, axis: str) -> int:
    """This rank's index along ``axis``."""
    return int(mesh.get_coordinate()[list(base.axis_sizes(mesh)).index(axis)])


# ---------------------------------------------------------------------------
# Autograd-aware collectives
# ---------------------------------------------------------------------------


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        y = x.contiguous().clone()
        for g in groups:
            _all_reduce(y, g)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        for grp in ctx.groups:
            _all_reduce(g, grp)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.s, None


def reduce_sum(x: Tensor, groups: list) -> Tensor:
    """``x`` summed over ``groups`` (each group in turn); the gradient
    passes through unchanged."""
    return _ReduceSum.apply(x, list(groups))


def copy_to(x: Tensor, groups: list) -> Tensor:
    """``x`` itself; its gradient is summed over ``groups``."""
    return _CopyTo.apply(x, list(groups))


def scale_grad(x: Tensor, s: float) -> Tensor:
    """``x`` itself; its gradient times ``s``."""
    return _ScaleGrad.apply(x, s)


def batch_mean(x: Tensor, mesh, batch_axes) -> Tensor:
    """The mean over the batch axes' ranks of a per-rank value (the
    reference's ``pmean``): each rank's term takes 1 / n of the gradient."""
    groups = axis_groups(mesh, batch_axes)
    n = math.prod(dist.get_world_size(g) for g in groups)
    return reduce_sum(x, groups) / n


# ---------------------------------------------------------------------------
# Shards of a leaf
# ---------------------------------------------------------------------------


def shard_local(t: Tensor, placements: tuple, mesh) -> Tensor:
    """This rank's block of the full tensor ``t`` (a view): along each
    mesh dim in mesh order, ``Shard(d)`` keeps this rank's chunk of dim
    ``d`` (so axes sharing a dim split it major to minor)."""
    coord = mesh.get_coordinate()
    for i, (pl, n) in enumerate(zip(placements, mesh.shape)):
        if pl.is_shard():
            t = t.chunk(int(n), dim=pl.dim)[coord[i]]
    return t


def gather_full(local: Tensor, placements: tuple, mesh) -> Tensor:
    """The full tensor from every rank's ``shard_local`` block: all-gathers
    along the sharded mesh dims, minor to major."""
    t = local.contiguous()
    for i in reversed(range(len(placements))):
        pl = placements[i]
        if pl.is_shard():
            group = mesh.get_group(i)
            g = dist.get_world_size(group)
            parts = [torch.empty_like(t) for _ in range(g)]
            _COUNTS["all_gather"] += 1
            _BYTES["all_gather"] += (g - 1) * t.numel() * t.element_size()  # (g - 1) / g of the result
            dist.all_gather(parts, t, group=group)
            t = torch.cat(parts, dim=pl.dim)
    return t


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, placements, mesh, batch_groups):
        ctx.placements, ctx.mesh, ctx.batch_groups = placements, mesh, batch_groups
        return gather_full(local, placements, mesh)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        for grp in ctx.batch_groups:
            _all_reduce(g, grp)
        return shard_local(g, ctx.placements, ctx.mesh).contiguous(), None, None, None


def gather_param(local: Tensor, placements: tuple, mesh, batch_groups: list) -> Tensor:
    """A leaf's full value from this rank's shard; the gradient of the full
    value is summed over ``batch_groups`` and this rank's shard of it
    reaches ``local``."""
    return _GatherParam.apply(local, placements, mesh, list(batch_groups))


class LeafShards:
    """Where each leaf of a tree (in ``base.tree_leaves`` order) is sharded
    on ``mesh``: the per-leaf reductions of the optimizer."""

    def __init__(self, mesh, placements: list):
        self.mesh = mesh
        self.placements = placements
        self.coord = list(mesh.get_coordinate())

    def sum_over_shards(self, values: list[Tensor]) -> list[Tensor]:
        """Each leaf's per-rank partial sum (a 0-d tensor) summed over the
        ranks that hold its other shards: along every mesh dim the leaf is
        sharded on the ranks add their terms; along a replicated one only
        index 0's term counts (the others hold the same block)."""
        vals = list(values)
        for i in range(len(self.coord)):
            keep = [p[i].is_shard() or self.coord[i] == 0 for p in self.placements]
            v = torch.stack([x if k else torch.zeros_like(x) for x, k in zip(vals, keep)])
            _all_reduce(v, self.mesh.get_group(i))
            vals = list(v.unbind())
        return vals

    def max_over_shards(self, values: list[Tensor]) -> list[Tensor]:
        """Each leaf's per-rank maximum (a 0-d tensor) over all its shards."""
        v = torch.stack(values)
        for i in range(len(self.coord)):
            _all_reduce(v, self.mesh.get_group(i), op=dist.ReduceOp.MAX)
        return list(v.unbind())
