"""Parameter system of the model zoo.

Models are pure functions over nested dicts of tensors. Each model builds a
tree of ``ParamDef`` (shape + logical axes + initializer), the same tree as
the JAX package's ``repro.models.base``; two interpreters consume it:

  init_params        — materialize real tensors from a ``torch.Generator``
  abstract_params    — ``meta``-device tensors (shapes and dtypes, zero
                       allocation)

The logical axes are kept on every ``ParamDef`` for the multi-card slice;
the mesh rules that read them (``LOGICAL_RULES`` … ``shard_act``) have no
single-card meaning and are not ported yet (ROADMAP §1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim
    init: str = "normal"  # normal | zeros | ones | scaled
    scale: float = 0.02
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def pdef(shape, axes, init="normal", scale=0.02, dtype=torch.float32) -> ParamDef:
    return ParamDef(tuple(shape), tuple(axes), init, scale, dtype)


def tree_map(fn, tree: PyTree) -> PyTree:
    """``fn`` over the leaves of a nested dict, in sorted key order (the
    order ``jax.tree.flatten`` visits a dict in)."""
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def tree_map_with_path(fn, tree: PyTree, path: tuple[str, ...] = ()) -> PyTree:
    """``fn(path, leaf)`` over the leaves of a nested dict in sorted key
    order, ``path`` the keys from the root to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], (*path, k)) for k in sorted(tree)}
    return fn(path, tree)


def tree_leaves(tree: PyTree) -> list:
    """The leaves of nested dicts and tuples in ``jax.tree.leaves``' order:
    a dict's keys sorted, a tuple's (a NamedTuple's) items in order; None
    holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: PyTree, leaves) -> PyTree:
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple):
            vals = [build(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def fan_in_of(d: ParamDef) -> int:
    """A weight's input width: the dimension ``x @ w`` contracts, its
    second-to-last (a matrix (d_in, d_out), each of a batch of them: the
    experts' (E, d_in, d_out), sLSTM's per-head (H, dh, 4 dh)), after the
    stacked "layers" axes (one per stacking: hybrid and ssm stack theirs as
    (groups, per group, ...)); 1 for a vector."""
    n = 0
    while n < len(d.axes) and d.axes[n] == "layers":
        n += 1
    shape = d.shape[n:]
    return shape[-2] if len(shape) >= 2 else 1


def init_params(
    generator: torch.Generator,
    defs: PyTree,
    dtype: torch.dtype | Callable[[tuple[str, ...]], torch.dtype] | None = None,
) -> PyTree:
    """Real tensors for ``defs`` on the generator's device, drawn from
    ``generator`` leaf by leaf in sorted key order: one fp32 normal per
    random leaf. ``scaled`` is a normal over √fan_in, fan_in the weight's
    own input width (``fan_in_of``). The reference takes shape[0], which
    for a stacked layer weight is the layer count: its layer weights come
    out √(d_in / n_layers) times larger, and at full width its bf16 and
    fp32 forwards disagree on about half the argmaxes (ROADMAP §3).

    ``dtype``: each leaf's dtype (default: its ``ParamDef``'s), one for
    every leaf or a function of the leaf's key path
    (``transformer.serving_dtype``). A leaf is cast as soon as it is drawn,
    so the largest fp32 tensor alive is one leaf, never the whole tree."""
    device = generator.device

    def make(path: tuple[str, ...], d: ParamDef) -> torch.Tensor:
        dt = (dtype(path) if callable(dtype) else dtype) or d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        z = torch.randn(d.shape, generator=generator, dtype=torch.float32, device=device)
        if d.init == "scaled":  # fan-in scaled normal
            z.div_(math.sqrt(max(fan_in_of(d), 1)))
        else:
            z.mul_(d.scale)
        return z.to(dt)

    return tree_map_with_path(make, defs)


def abstract_params(defs: PyTree, dtype: torch.dtype | None = None) -> PyTree:
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype or d.dtype, device="meta"), defs)
