"""Sharded, atomic, resumable checkpoints in the reference's format.

The port of ``repro.train.checkpoint``: each package reads the other's
files. Layout (one directory per step):

    <dir>/step_000000123.tmp/...   -> written fully, then atomically renamed to
    <dir>/step_000000123/
        meta.json               step, data_cursor, rng_seed, n_leaves, n_hosts
        shard_<host>.npz        this host's leaves, as ``leaf_<i>``

Leaf ``i`` is the i-th leaf of ``{"params": …, "opt_state": …}`` in
``jax.tree.leaves`` order: a dict's keys sorted (so ``opt_state`` comes
before ``params``), a tuple's (``AdamState``'s) fields in order, ``None``
no leaf. Host h owns the leaves with ``i % n_hosts == h``; host 0 writes
the meta and publishes the directory.

Fault-tolerance contract:
  * atomic: a crash mid-write leaves only a *.tmp dir, never a corrupt
    checkpoint; ``latest_step`` ignores tmp dirs.
  * resumable: params, opt state (with its step counter), data cursor and
    seed restore exactly.
  * keep_k garbage collection never deletes the newest checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.models import base

PyTree = Any


@dataclasses.dataclass
class TrainState:
    params: PyTree
    opt_state: PyTree
    step: int
    data_cursor: int  # global examples consumed (pipeline resume point)
    rng_seed: int


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(
    ckpt_dir: str,
    state: TrainState,
    *,
    host_id: int = 0,
    n_hosts: int = 1,
    keep_k: int = 3,
) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{state.step:09d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    os.makedirs(tmp, exist_ok=True)

    leaves = base.tree_leaves({"params": state.params, "opt_state": state.opt_state})
    own = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves) if i % n_hosts == host_id}
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"), **own)

    if host_id == 0:
        meta = {
            "step": state.step,
            "data_cursor": state.data_cursor,
            "rng_seed": state.rng_seed,
            "n_leaves": len(leaves),
            "n_hosts": n_hosts,
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        os.replace(tmp, final)  # atomic publish
        _gc(ckpt_dir, keep_k)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like: TrainState, step: int | None = None) -> TrainState:
    """Restore into the structure of ``like`` (shapes must match): each
    leaf a new tensor of the ``like`` leaf's dtype on its device."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    tree = {"params": like.params, "opt_state": like.opt_state}
    flat = base.tree_leaves(tree)
    leaves: dict[int, np.ndarray] = {}
    for fn in os.listdir(path):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(path, fn)) as z:
                for k in z.files:
                    leaves[int(k.split("_")[1])] = z[k]
    if not len(leaves) == meta["n_leaves"] == len(flat):
        raise ValueError(f"{path}: {len(leaves)} leaves on disk, meta says {meta['n_leaves']}, "
                         f"the state has {len(flat)}")
    new_flat = []
    for i, want in enumerate(flat):
        if tuple(leaves[i].shape) != tuple(want.shape):
            raise ValueError(f"{path}: leaf_{i} has shape {leaves[i].shape}, want {tuple(want.shape)}")
        new_flat.append(torch.as_tensor(leaves[i]).to(dtype=want.dtype, device=want.device))
    new_tree = base.tree_unflatten(tree, new_flat)
    return TrainState(
        params=new_tree["params"],
        opt_state=new_tree["opt_state"],
        step=meta["step"],
        data_cursor=meta["data_cursor"],
        rng_seed=meta["rng_seed"],
    )


def _gc(ckpt_dir: str, keep_k: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep_k]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    # Stale tmp dirs from crashes are garbage too.
    for d in os.listdir(ckpt_dir):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
