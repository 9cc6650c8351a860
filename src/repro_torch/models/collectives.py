"""The mesh path's collectives over ``torch.distributed`` process groups.

The reference leaves its collectives to XLA's SPMD partitioner (and one
explicit ``psum`` in the MoE's ``shard_map``). The port computes on
rank-local blocks instead, and makes each collective itself, over the
process group of one mesh axis (``DeviceMesh.get_group(axis)``):

  LayerGather    one layer's leaves whole from this rank's blocks: per
                 mesh dim, one all-gather of every leaf sharded along it,
                 flattened into one buffer. Its backward takes each
                 gradient straight to this rank's block, one mesh dim at a
                 time, major to minor: along a batch axis that shards a
                 leaf a reduce-scatter (one for the layer's leaves), along
                 a dim that shards it but carries no batch this rank's
                 block with no sum, and along a batch axis on which it is
                 replicated an all-reduce of the block (one for those
                 leaves). No whole leaf's gradient is ever all-reduced.
  reduce_sum     all-reduce SUM forward, identity backward
  copy_to        identity forward, all-reduce SUM backward
  scale_grad     identity forward, the gradient scaled backward

Gradient convention: every rank computes the GLOBAL objective's value, and
its backward gives the contribution of the rows it holds. Gradients are
then summed over the batch axes (``LayerGather``'s backward); ranks that
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
an all-reduce of S bytes 2 (g - 1) / g · S, a reduce-scatter of an input
of S bytes (g - 1) / g · S.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.models import base

Tensor = torch.Tensor

_COUNTS = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0}
_BYTES = {"all_gather": 0.0, "all_reduce": 0.0, "reduce_scatter": 0.0}


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


def _all_gather_rows(x: Tensor, group) -> Tensor:
    """(g, n): every rank's ``x`` (n elements, contiguous) as a row, in
    the group's rank order."""
    g = dist.get_world_size(group)
    out = torch.empty(g * x.numel(), dtype=x.dtype, device=x.device)
    _COUNTS["all_gather"] += 1
    _BYTES["all_gather"] += (g - 1) * x.numel() * x.element_size()  # (g - 1) / g of the result
    dist.all_gather_into_tensor(out, x.view(-1), group=group)
    return out.view(g, -1)


def _reduce_scatter(x: Tensor, group) -> Tensor:
    """This rank's row of ``x`` (g, n) summed over the group's ranks."""
    g = dist.get_world_size(group)
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    _COUNTS["reduce_scatter"] += 1
    _BYTES["reduce_scatter"] += (g - 1) / g * x.numel() * x.element_size()
    dist.reduce_scatter_tensor(out, x.view(-1), group=group)
    return out


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


def _flat(ts: list[Tensor]) -> Tensor:
    return torch.cat([t.reshape(-1) for t in ts])


class _LayerPlan:
    """Where each leaf of one gather lies on the mesh: per mesh dim, its
    group and size, whether it is a batch axis, this rank's coordinate on
    it, the leaves gathered along it (with the tensor dim each shards) and
    the leaves a batch axis replicates."""

    def __init__(self, placements: list, mesh, batch_axes, keep_local: list):
        names = list(base.axis_sizes(mesh))
        self.groups = [mesh.get_group(i) for i in range(len(names))]
        self.sizes = [dist.get_world_size(g) for g in self.groups]
        self.coord = list(mesh.get_coordinate())
        self.batch = [a in batch_axes for a in names]
        self.sharded: list[list[tuple[int, int]]] = [[] for _ in names]
        self.replicated: list[list[int]] = [[] for _ in names]
        for j, (pls, keep) in enumerate(zip(placements, keep_local)):
            for i, pl in enumerate(pls):
                if names[i] in keep:
                    if self.batch[i]:
                        raise ValueError(f"a leaf kept local along batch axis {names[i]!r}")
                elif pl.is_shard():
                    self.sharded[i].append((j, pl.dim))
                elif self.batch[i]:
                    self.replicated[i].append(j)

    def gather(self, ts: list[Tensor]) -> list[Tensor]:
        """Each leaf whole from its block: minor to major, one all-gather
        per mesh dim over the leaves sharded along it."""
        ts = list(ts)
        for i in reversed(range(len(self.sharded))):
            if not self.sharded[i]:
                continue
            rows = _all_gather_rows(_flat([ts[j] for j, _ in self.sharded[i]]), self.groups[i])
            g = self.sizes[i]
            parts = rows.split([ts[j].numel() for j, _ in self.sharded[i]], dim=1)
            for (j, d), part in zip(self.sharded[i], parts):
                shape = ts[j].shape  # rank r's block is at r along dim d
                whole = (*shape[:d], g * shape[d], *shape[d + 1 :])
                ts[j] = part.reshape(whole) if d == 0 else part.reshape(g, *shape).movedim(0, d).reshape(whole)
        return ts

    def reduce(self, grads: list[Tensor]) -> list[Tensor]:
        """Each whole gradient to this rank's block, major to minor (the
        gather's reverse): along a dim that shards a leaf, a reduce-scatter
        of the leaves' blocks where it is a batch axis, else this rank's
        block; along a batch axis that replicates a leaf, one all-reduce
        of those leaves."""
        gs = list(grads)
        for i in range(len(self.sharded)):
            g = self.sizes[i]
            if self.sharded[i] and not self.batch[i]:  # rank r's block is chunk r of dim d
                for j, d in self.sharded[i]:
                    gs[j] = gs[j].chunk(g, dim=d)[self.coord[i]].contiguous()
            elif self.sharded[i]:
                blocks, rows = [], []
                for j, d in self.sharded[i]:
                    shape = gs[j].shape
                    block = (*shape[:d], shape[d] // g, *shape[d + 1 :])
                    blocks.append(block)
                    rows.append(gs[j].reshape(g, -1) if d == 0 else
                                gs[j].reshape(*shape[:d], g, *block[d:]).movedim(d, 0).reshape(g, -1))
                mine = _reduce_scatter(torch.cat(rows, dim=1), self.groups[i])
                del rows
                for (j, _), block, part in zip(self.sharded[i], blocks,
                                               mine.split([math.prod(b) for b in blocks])):
                    gs[j] = part.view(block)
            if self.replicated[i]:
                idx = self.replicated[i]
                flat = _flat([gs[j] for j in idx])
                _all_reduce(flat, self.groups[i])
                for j, part in zip(idx, flat.split([gs[j].numel() for j in idx])):
                    gs[j] = part.view(gs[j].shape)
        return gs


class _GatherLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *local):
        ctx.plan = plan
        return tuple(plan.gather(local))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.plan.reduce(grads))


class LayerGather:
    """The gather of one structure of leaves (one layer of a stack, or the
    leaves outside the layer stacks), planned once from their
    ``placements`` (nested dicts of per-leaf placements): called on this
    rank's blocks (the same structure), it returns the leaves whole, with
    one all-gather per mesh dim that shards any of them. The backward
    gives each block its gradient (module docstring): summed over
    ``batch_axes``, never whole on the wire. ``keep_local``: {leaf path (a
    tuple of keys): mesh axis names} along which a leaf stays this rank's
    block, neither gathered nor summed (the routed experts along "model"
    under expert parallelism)."""

    def __init__(self, placements: dict, mesh, batch_axes, keep_local: dict | None = None):
        paths: list = []  # (key path, placements) in base.tree_leaves' order; a tuple is a leaf here
        base.tree_map_with_path(lambda p, pl: paths.append((p, pl)), placements)
        keep = [tuple((keep_local or {}).get(p, ())) for p, _ in paths]
        self.plan = _LayerPlan([pl for _, pl in paths], mesh, tuple(batch_axes), keep)

    def __call__(self, local: dict) -> dict:
        return base.tree_unflatten(local, _GatherLayer.apply(self.plan, *base.tree_leaves(local)))


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
