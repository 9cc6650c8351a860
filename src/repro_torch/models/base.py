"""Parameter system of the model zoo.

Models are pure functions over nested dicts of tensors. Each model builds a
tree of ``ParamDef`` (shape + logical axes + initializer), the same tree as
the JAX package's ``repro.models.base``; three interpreters consume it:

  init_params        — materialize real tensors from a ``torch.Generator``
  abstract_params    — ``meta``-device tensors (shapes and dtypes, zero
                       allocation)
  make_shardings     — DTensor placements per leaf: logical axis names ->
                       mesh axes via LOGICAL_RULES (or a profile's rules),
                       with the reference's divisibility fallback (a dim that
                       does not divide its mesh axes is replicated, never
                       mis-sharded — e.g. hubert's 504-way vocab head).

Logical axis vocabulary (MaxText-style):
  "embed"    d_model dims           -> FSDP axis ("data")   [weights]
  "mlp"      FFN hidden dims        -> TP axis ("model")
  "heads"    attention-head dims    -> TP axis ("model")
  "kv"       KV-head dims           -> TP axis ("model") when divisible
  "vocab"    vocabulary dims        -> TP axis ("model")
  "experts"  MoE expert dim         -> TP/EP axis ("model")
  "layers"   stacked layer dim      -> replicated
  None       replicated

A spec is the reference's ``PartitionSpec`` as a plain tuple: per tensor
dim None, one mesh axis name, or a tuple of them (major to minor). A mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` or any object with the
reference's duck-typed ``.axis_names`` and ``.shape`` mapping; the spec
functions read only axis names and sizes.

Activations use ``shard_act`` with its own vocabulary ("act_batch" ->
("pod", "data"), "act_model" -> "model", "act_seq" -> "data").
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


# ---------------------------------------------------------------------------
# Logical sharding rules (the reference's base.py:40-175)
# ---------------------------------------------------------------------------

LOGICAL_RULES: dict[str, str | tuple[str, ...] | None] = {
    "embed": "data",
    "mlp": "model",
    "heads": "model",
    "kv": "model",
    "vocab": "model",
    "experts": "model",
    "layers": None,
    "conv": None,
}

# FSDP profile: the "model" axis carries batch instead of tensor
# parallelism; weights shard one dim over both axes (ZeRO-3).
FSDP_RULES: dict[str, str | tuple[str, ...] | None] = {
    "embed": ("data", "model"),
    "mlp": None,
    "heads": None,
    "kv": None,
    "vocab": ("data", "model"),
    "experts": ("data", "model"),
    "layers": None,
    "conv": None,
}

ACT_RULES: dict[str, str | tuple[str, ...] | None] = {
    "act_batch": ("pod", "data"),
    "act_model": "model",
    "act_seq": "data",  # sequence sharding (long-context decode)
}

FSDP_ACT_RULES: dict[str, str | tuple[str, ...] | None] = {
    "act_batch": ("pod", "data", "model"),
    "act_model": None,
    "act_seq": None,
}

# Sequence-parallel FSDP: the model axis shards the SEQUENCE, weights stay
# ZeRO-3 over (data, model).
FSDP_SP_ACT_RULES: dict[str, str | tuple[str, ...] | None] = {
    "act_batch": ("pod", "data"),
    "act_model": None,
    "act_seq": "model",
}


def rules_for_profile(profile: str):
    """(param_rules, act_rules, batch_axes) per sharding profile."""
    if profile == "fsdp":
        return FSDP_RULES, FSDP_ACT_RULES, ("pod", "data", "model")
    if profile == "fsdp_sp":
        return FSDP_RULES, FSDP_SP_ACT_RULES, ("pod", "data")
    return LOGICAL_RULES, ACT_RULES, ("pod", "data")


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size}, in mesh order, of a ``DeviceMesh`` or a
    duck-typed mesh (``.axis_names`` and a ``.shape`` mapping)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(n) for n in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _assign(shape, names, rules, sizes: dict[str, int], positive: bool) -> tuple:
    """Logical names -> mesh axes per dim: each mesh axis used at most once
    (the first logical dim wins), a dim that does not divide its axes'
    size (or, with ``positive``, is 0) replicated."""
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, names):
        phys = rules.get(name) if name else None
        if phys is None:
            out.append(None)
            continue
        axes = (phys,) if isinstance(phys, str) else tuple(phys)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        size = math.prod(sizes[a] for a in axes)
        if axes and dim % size == 0 and (dim > 0 or not positive):
            out.append(axes[0] if len(axes) == 1 else axes)
            used.update(axes)
        else:
            out.append(None)
    return tuple(out)


def spec_for(d: ParamDef, mesh, rules=None) -> tuple:
    """Logical axes -> spec with divisibility fallback. At most one mesh
    axis is assigned once (first logical dim wins on conflict)."""
    return _assign(d.shape, d.axes, rules or LOGICAL_RULES, axis_sizes(mesh), positive=False)


def make_pspecs(defs: PyTree, mesh, rules=None) -> PyTree:
    return tree_map(lambda d: spec_for(d, mesh, rules), defs)


def placements_for(spec: tuple, mesh) -> tuple:
    """A spec as DTensor placements, one per mesh dim: ``Shard(dim)`` where
    the spec puts that mesh axis on tensor dim ``dim``, else
    ``Replicate()``. Several axes on one dim must be in mesh order (the
    reference's major-to-minor order is DTensor's for ``Shard`` on
    successive mesh dims)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in ((entry,) if isinstance(entry, str) else entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def make_shardings(defs: PyTree, mesh, rules=None) -> PyTree:
    """Each leaf's DTensor placements on ``mesh`` (``placements_for`` of
    its ``spec_for``)."""
    return tree_map(lambda d: placements_for(spec_for(d, mesh, rules), mesh), defs)


# ---------------------------------------------------------------------------
# Activation sharding constraints (the reference's base.py:178-226)
# ---------------------------------------------------------------------------

_CURRENT_MESH: list[tuple[Any, dict, bool]] = [(None, ACT_RULES, False)]


class use_mesh:
    """Context manager: makes ``shard_act`` (and the MoE's expert-parallel
    branch) bind to this mesh and, optionally, a profile's activation
    rules. ``split``: the weights handed to the blocks are this rank's
    blocks along "model" (``transformer.ShardedTransformer`` under "tp"),
    so each block computes its share and sums it over "model"
    (``collectives.model_split``); without it every rank computes the
    blocks whole."""

    def __init__(self, mesh, act_rules: dict | None = None, split: bool = False):
        self.entry = (mesh, act_rules or ACT_RULES, split)

    def __enter__(self):
        _CURRENT_MESH.append(self.entry)
        return self.entry[0]

    def __exit__(self, *exc):
        _CURRENT_MESH.pop()


def current_mesh():
    return _CURRENT_MESH[-1][0]


def current_mesh_entry() -> tuple[Any, dict, bool]:
    """(mesh, activation rules, split) in force: ``use_mesh(*entry)`` re-enters
    them (a checkpointed body's recompute, which runs in the backward
    pass after the forward's ``use_mesh`` has exited)."""
    return _CURRENT_MESH[-1]


def current_act_rules() -> dict:
    return _CURRENT_MESH[-1][1]


def current_split() -> bool:
    """Whether the blocks compute this rank's share along "model" (``use_mesh``)."""
    return _CURRENT_MESH[-1][2]


def act_spec(shape, axes: tuple[str | None, ...], mesh=None, act_rules: dict | None = None) -> tuple:
    """The spec ``shard_act`` constrains a tensor of ``shape`` to (the
    current mesh and rules by default); 0-sized dims stay replicated."""
    mesh = current_mesh() if mesh is None else mesh
    return _assign(shape, axes, act_rules or current_act_rules(), axis_sizes(mesh), positive=True)


def shard_act(x: torch.Tensor, axes: tuple[str | None, ...]) -> torch.Tensor:
    """Constrain an activation's layout by logical axes. Without a mesh,
    ``x`` itself. Under a mesh a DTensor is redistributed to the activation
    rules' placements; a plain tensor is a rank's own block (the mesh
    training path computes on rank-local rows of the batch, every other
    dim whole) and passes unchanged."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, placements_for(act_spec(x.shape, axes, mesh), mesh))
    return x
