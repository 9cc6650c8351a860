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
                 Along a dim the caller keeps (``keep_local``: under
                 "tp" every dim the rules shard over "model") a leaf
                 stays this rank's block, neither gathered nor summed.
  reduce_sum     all-reduce SUM forward, identity backward
  copy_to        identity forward, all-reduce SUM backward
  scale_grad     identity forward, the gradient scaled backward
  gather_last    all-gather along the last dim forward; backward a
                 reduce-scatter (the ranks' uses are partial) or this
                 rank's block (they are the same)
  scatter_last   reduce-scatter along the last dim forward (this rank's
                 block of a sum of partials); backward an all-gather
  all_max        all-reduce MAX, a constant
  vocab_nll      the vocabulary-parallel cross entropy (one all-reduce
                 MAX and one SUM forward, none backward)

The tensor-parallel split (``model_split``, ``Split``): under "tp" the
mesh step hands each block this rank's blocks along "model", and the block
computes its share between a ``copy_to`` of its input and a
``reduce_sum`` of its output (column then row: Megatron's split).

Gradient convention: every rank computes the GLOBAL objective's value, and
its backward gives the contribution of the rows and blocks it holds.
Gradients are then summed over the batch axes (``LayerGather``'s
backward); ranks that differ only along "model" hold the same rows, and
each block's share of the objective reaches its own block, so nothing is
summed over "model" but where a split block's input (``copy_to``) or a
leaf used whole inside it (the router, a replicated projection) takes
partial gradients from every rank. ``reduce_sum`` is the forward of a
quantity summed over ranks (each rank then holds the global value, and
the gradient reaching it is the one its own term takes).

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


def reduce_sum(x: Tensor, groups: list, partial: bool = False) -> Tensor:
    """``x`` summed over ``groups`` (each group in turn); the gradient
    passes through unchanged. ``partial``: each rank uses the sum in its
    own way (its columns of a norm, its head of a projection), so each
    term's gradient is the sum of the ranks' gradients of the sum (a
    ``copy_to`` after the sum: one all-reduce backward)."""
    y = _ReduceSum.apply(x, list(groups))
    return copy_to(y, groups) if partial else y


def copy_to(x: Tensor, groups: list) -> Tensor:
    """``x`` itself; its gradient is summed over ``groups``."""
    return _CopyTo.apply(x, list(groups))


def scale_grad(x: Tensor, s: float) -> Tensor:
    """``x`` itself; its gradient times ``s``."""
    return _ScaleGrad.apply(x, s)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, partial):
        ctx.group, ctx.partial = group, partial
        g = dist.get_world_size(group)
        rows = _all_gather_rows(x.contiguous(), group)  # (g, numel): rank r's block in row r
        return rows.view(g, *x.shape).movedim(0, -2).reshape(*x.shape[:-1], g * x.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        g = dist.get_world_size(ctx.group)
        blocks = grad.reshape(*grad.shape[:-1], g, grad.shape[-1] // g).movedim(-2, 0)
        if not ctx.partial:
            return blocks[dist.get_rank(ctx.group)].contiguous(), None, None
        mine = _reduce_scatter(blocks.reshape(g, -1).contiguous(), ctx.group)
        return mine.view(blocks.shape[1:]), None, None


def gather_last(x: Tensor, group, partial: bool = True) -> Tensor:
    """Every rank's ``x`` of ``group`` side by side along the last dim, in
    rank order (one all-gather). ``partial``: each rank's use of the
    result reaches only part of the objective, so the gradient of this
    rank's block is the sum of the ranks' gradients of it (one
    reduce-scatter); otherwise every rank computes the same objective from
    the result, and the block takes its own rank's gradient."""
    return _GatherLast.apply(x, group, partial)


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        g = dist.get_world_size(group)
        blocks = x.reshape(*x.shape[:-1], g, x.shape[-1] // g).movedim(-2, 0)
        return _reduce_scatter(blocks.reshape(g, -1).contiguous(), group).view(blocks.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        g = dist.get_world_size(ctx.group)
        rows = _all_gather_rows(grad.contiguous(), ctx.group)  # (g, numel): rank r's block in row r
        return rows.view(g, *grad.shape).movedim(0, -2).reshape(*grad.shape[:-1], g * grad.shape[-1]), None


def scatter_last(x: Tensor, group) -> Tensor:
    """This rank's block along the last dim of the sum over ``group`` of
    every rank's ``x`` (a partial sum; one reduce-scatter). Backward the
    block's gradient gathered whole (one all-gather): each rank's term
    takes the gradient of the whole sum."""
    return _ScatterLast.apply(x, group)


def all_max(x: Tensor, groups: list) -> Tensor:
    """The elementwise maximum of ``x`` over ``groups``, as a constant (no
    gradient)."""
    y = x.detach().contiguous().clone()
    for g in groups:
        _all_reduce(y, g, op=dist.ReduceOp.MAX)
    return y


class Split:
    """The tensor-parallel split in force (``model_split``): this rank is
    ``rank`` of ``size`` along "model", and ``groups`` is that axis' group
    (a list, as ``reduce_sum`` and ``copy_to`` take it; empty for a rank
    computed alone, whose share is summed by its caller). A dim the rules
    shard over "model" is one that ``size`` divides (``base.spec_for``'s
    divisibility rule); rank r holds its r-th chunk."""

    def __init__(self, size: int, rank: int, groups: list):
        self.size, self.rank, self.groups = size, rank, list(groups)
        self.group = self.groups[0] if self.groups else None

    @classmethod
    def of(cls, mesh) -> "Split":
        """This rank's split along the "model" axis of ``mesh``."""
        return cls(base.axis_sizes(mesh)["model"], coordinate(mesh, "model"), axis_groups(mesh, ("model",)))

    def splits(self, n: int) -> bool:
        """Whether a dim of ``n`` is sharded over "model"."""
        return n % self.size == 0

    def span(self, n: int) -> tuple[int, int]:
        """This rank's [lo, hi) of a dim of ``n`` that ``splits``."""
        c = n // self.size
        return self.rank * c, (self.rank + 1) * c

    def block(self, w: Tensor, dim: int, full: int) -> Tensor:
        """This rank's block of ``w`` along ``dim`` (``full`` long whole):
        ``w`` itself when the dim is not split or ``w`` is held as the
        block already, else its chunk (a view)."""
        if not self.splits(full) or w.shape[dim] != full:
            return w
        lo, hi = self.span(full)
        return w.narrow(dim, lo, hi - lo)

    def whole(self, w: Tensor, full: int) -> Tensor:
        """A leaf whole along its last dim (``full`` long) for a use in this
        rank's share: its block gathered along "model" where it is held so
        (``gather_last``, partial), else the leaf itself with its gradient
        summed over "model" (``copy_to``)."""
        if w.shape[-1] == full:
            return copy_to(w, self.groups)
        return gather_last(w, self.group, partial=True)


def model_split() -> Split | None:
    """The split in force: under ``base.use_mesh(..., split=True)`` on a
    mesh with a "model" axis, each block computes this rank's share (its
    heads, FFN columns, experts' columns, vocabulary rows) and sums it over
    "model"; else None, and the blocks compute whole."""
    mesh = base.current_mesh()
    if mesh is None or not base.current_split() or "model" not in base.axis_sizes(mesh):
        return None
    return Split.of(mesh)


def vocab_terms(logits: Tensor, labels: Tensor, lo: int, m: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One rank's terms of the vocabulary-parallel CE from its columns
    [lo, lo + n) of the logits and the max over all columns ``m``:
    (Σ exp(logits - m), the label's logit or 0 where the label is not in
    its columns, the label's local column clamped into them, whether it is
    in them)."""
    n = logits.shape[-1]
    s = (logits - m[..., None]).exp().sum(-1)
    local = labels.long() - lo
    inside = (local >= 0) & (local < n)
    local = local.clamp(0, n - 1)
    ll = logits.gather(-1, local[..., None])[..., 0].masked_fill(~inside, 0)
    return s, ll, local, inside


def vocab_lse(s: Tensor, m: Tensor) -> Tensor:
    """The log-sum-exp from the ranks' Σ exp summed (``s``) and the max
    ``m``, in ``torch.logsumexp``'s own order: log(s) + m, an infinite max
    added as 0."""
    return s.log() + m.masked_fill(m.abs() == math.inf, 0)


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, lo, groups):
        m = all_max(logits.amax(-1), groups)
        s, ll, local, inside = vocab_terms(logits, labels, lo, m)
        both = torch.stack([s, ll])
        for g in groups:
            _all_reduce(both, g)
        lse = vocab_lse(both[0], m)
        ctx.save_for_backward(logits, lse, local, inside)
        return lse - both[1]

    @staticmethod
    def backward(ctx, grad):
        logits, lse, local, inside = ctx.saved_tensors
        out = grad[..., None] * (logits - lse[..., None]).exp()  # logsumexp's backward
        out.scatter_add_(-1, local[..., None], -(grad * inside)[..., None])  # the label's gather
        return out, None, None, None


def vocab_nll(logits: Tensor, labels: Tensor, split: Split) -> Tensor:
    """Per-position ``logsumexp(logits) - logits[label]`` over the whole
    vocabulary from this rank's columns ``logits`` (..., V / m) of it
    (``split.span``), without forming whole logits: the max over the ranks
    all-reduced with MAX (a constant), Σ exp and the label's logit (0 on
    the ranks that do not own the label) summed in one all-reduce. Each
    rank holds the whole value; its backward gives the gradient of its own
    columns (softmax less the label's one-hot), with no collective. On one
    rank it is ``torch.logsumexp`` and ``gather``, forward and backward,
    bit for bit."""
    return _VocabNLL.apply(logits, labels, split.span(logits.shape[-1] * split.size)[0], split.groups)


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
