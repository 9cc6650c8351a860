"""Explicit sharding of every entry-point operand (the port of
``repro.launch.shardings``).

Params take the logical rules of ``models/base.py``; batches shard their
leading (global-batch) dim over ("pod", "data"); decode states get the
per-family treatment here. Each function comes as a spec (the reference's
``PartitionSpec`` as a tuple, ``*_spec``/``state_specs``) and as DTensor
placements on the mesh (``*_shardings``, via ``base.placements_for``). A
mesh is a ``DeviceMesh`` or a duck-typed one (``base.axis_sizes``).
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.models import base
from repro_torch.models.config import ArchConfig

PyTree = Any


def _axes(mesh, names: tuple[str, ...]) -> tuple[str, ...]:
    sizes = base.axis_sizes(mesh)
    return tuple(a for a in names if a in sizes)


def _div(dim: int, mesh, names: tuple[str, ...]) -> bool:
    sizes = base.axis_sizes(mesh)
    size = math.prod(sizes[a] for a in names)
    return size > 1 and dim % size == 0


def batch_spec(mesh, shape: tuple[int, ...], batch_axes: tuple[str, ...] = ("pod", "data")) -> tuple:
    """Shard dim 0 over the profile's batch axes when divisible, else
    replicate. FSDP-profile archs put "model" in batch_axes too."""
    bd = _axes(mesh, batch_axes)
    if shape and _div(shape[0], mesh, bd):
        return (bd if len(bd) > 1 else bd[0],)
    return ()


def batch_shardings(batch: PyTree, mesh, batch_axes: tuple[str, ...] = ("pod", "data")) -> PyTree:
    return base.tree_map(
        lambda x: base.placements_for(batch_spec(mesh, tuple(x.shape), batch_axes), mesh), batch)


def _model_dim_spec(shape, batch_idx, model_candidates, mesh) -> tuple:
    """Batch on batch_idx and 'model' on the first candidate dim that
    divides; remaining dims replicated."""
    bd = _axes(mesh, ("pod", "data"))
    sizes = base.axis_sizes(mesh)
    spec: list = [None] * len(shape)
    if batch_idx is not None and _div(shape[batch_idx], mesh, bd):
        spec[batch_idx] = bd if len(bd) > 1 else bd[0]
    if "model" in sizes:
        for c in model_candidates:
            if c != batch_idx and c < len(shape) and shape[c] % sizes["model"] == 0 and shape[c] > 1:
                spec[c] = "model"
                break
    return tuple(spec)


def _leaf_spec(keys: list[str], shape: tuple[int, ...], mesh) -> tuple:
    nd = len(shape)
    n_model = base.axis_sizes(mesh).get("model", 1)
    if "kv" in keys or "kv0" in keys or ("k" in keys or "v" in keys):
        # (L?, B, S, KV, hd) or (B, S, KV, hd) [or (groups, B, S, KV, hd)]
        b_idx = nd - 4
        kv_idx, s_idx = nd - 2, nd - 3
        if shape[kv_idx] % n_model == 0 and shape[kv_idx] > 1:
            return _model_dim_spec(shape, b_idx, (kv_idx,), mesh)
        # MQA: the SEQUENCE dim (per-rank partial softmax)
        return _model_dim_spec(shape, b_idx, (s_idx,), mesh)
    if "ssd" in keys:  # (g, per, B, H, N, P) or (B, H, N, P)
        return _model_dim_spec(shape, nd - 4, (nd - 3,), mesh)
    if "conv" in keys:  # (g, per, B, W-1, C)
        return _model_dim_spec(shape, nd - 3, (nd - 1,), mesh)
    if "mlstm" in keys:  # (g, per, B, H, dk, dv+1)
        return _model_dim_spec(shape, nd - 4, (nd - 3, nd - 2), mesh)
    if "slstm" in keys:  # (g, B, H, dh)
        return _model_dim_spec(shape, nd - 3, (nd - 2, nd - 1), mesh)
    return ()  # fallback: replicate


def _map_state(fn, tree: PyTree, keys: tuple[str, ...] = ()) -> PyTree:
    """``fn(keys, leaf)`` over a decode state (dicts, tuples), ``keys`` the
    dict keys from the root (a tuple item adds none, as the reference's
    path keys give it none)."""
    if isinstance(tree, dict):
        return {k: _map_state(fn, tree[k], (*keys, k)) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(_map_state(fn, v, keys) for v in tree)
    return fn(keys, tree)


def state_specs(cfg: ArchConfig, state_shapes: PyTree, mesh) -> PyTree:
    """Decode-state specs keyed by the ``init_state`` tree structure.

    KV caches (…, B, S, KV, hd): batch over ("pod","data"); KV heads over
    "model" when they divide (GQA), else the SEQUENCE dim (MQA). SSD, conv
    and mLSTM states shard their head or feature dim over "model", sLSTM's
    its heads (or, failing that, its head width)."""
    return _map_state(lambda keys, leaf: _leaf_spec(list(keys), tuple(leaf.shape), mesh), state_shapes)


def state_shardings(cfg: ArchConfig, state_shapes: PyTree, mesh) -> PyTree:
    """``state_specs`` as DTensor placements."""
    return _map_state(lambda keys, leaf: base.placements_for(_leaf_spec(list(keys), tuple(leaf.shape), mesh), mesh),
                      state_shapes)
