"""The port side of ``tests/test_torch_dryrun.py``, run as a script in a
process of its own (every fake world forms there, never in the pytest
process). It imports neither ``jax`` nor ``repro`` and writes one JSON
object to the path it is given:

    python tests/_torch_dryrun_port.py OUT.json

  import_env   the ``os.environ`` keys that importing the dry-run modules
               added, removed or changed (none expected)
  bytes        per (arch, mesh, profile): the rank's parameter and
               optimizer bytes of a train_4k cell built and placed on the
               production mesh (``--no-step``)
  flops        per profile: the dry run's FLOPs of reduced qwen1.5-0.5b at
               train_4k, 2 microbatches, on a (2, 2) mesh
  cells        every runnable (arch, shape) of the reduced configs on a
               fake (2, 2) mesh through ``dryrun.main``, global batch 4,
               with the train and prefill shapes cut to COVER_SEQ tokens:
               xlstm's sLSTM steps token by token, and at 32,768 tokens
               its cells alone take minutes on ``meta``
  opt          ``dryrun_opt.main`` on one cell
  hygiene      ``fake_world``'s refusals and clean-up
  coll         ``gather_full``'s, ``_all_reduce``'s and
               ``_reduce_scatter``'s wire bytes and counts over fake
               worlds of 1, 2 and 4 ranks
  split        deepseek-moe-16b at full width under "tp" on a fake (2, 2)
               mesh (global batch 2, one microbatch, SPLIT_SEQ tokens):
               the peak's split and one stack of routed experts' bytes
"""
import dataclasses
import json
import math
import os
import sys

COVER_SEQ = 1024
SPLIT_SEQ = 1024

ENV_BEFORE = dict(os.environ)
from repro_torch.launch import dryrun, dryrun_opt, mesh, stepcount  # noqa: E402,F401

IMPORT_ENV = sorted(k for k in set(ENV_BEFORE) | set(os.environ) if ENV_BEFORE.get(k) != os.environ.get(k))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Shard  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import collectives  # noqa: E402

MESHES = {"single_pod": False, "multi_pod": True}


def param_bytes() -> dict:
    out = {}
    for arch in configs.ARCH_NAMES:
        for name, mp in MESHES.items():
            for profile in ("tp", "fsdp"):
                rec = dryrun.run_cell(arch, "train_4k", mp, do_step=False, profile=profile)
                out[f"{arch}|{name}|{profile}"] = [rec["params_bytes"], rec["optimizer_bytes"]]
    return out


def flops() -> dict:
    return {p: dryrun.run_cell("qwen1.5-0.5b", "train_4k", profile=p, n_micro=2, mesh_shape=(2, 2),
                               reduced=True)["flops_per_device"] for p in ("fsdp", "tp")}


def cells(tmp: str) -> list:
    for name, shape in list(dryrun.SHAPES.items()):
        if not shape.is_decode:
            dryrun.SHAPES[name] = dataclasses.replace(shape, seq_len=COVER_SEQ)
    path = os.path.join(tmp, "cells.jsonl")
    dryrun.main(["--all", "--reduced", "--mesh-shape", "2,2", "--global-batch", "4", "--out", path])
    with open(path) as f:
        return [json.loads(line) for line in f]


def opt(tmp: str) -> list:
    path = os.path.join(tmp, "opt.jsonl")
    dryrun_opt.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--single-pod", "--out", path])
    dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k", "--out", path])
    with open(path) as f:
        return [json.loads(line) for line in f]


def hygiene() -> dict:
    out = {"before": dist.is_initialized()}
    with mesh.fake_world(4):
        try:
            with mesh.fake_world(2):
                out["nested"] = "entered"
        except RuntimeError as e:
            out["nested"] = str(e)
        out["inside"] = [dist.is_initialized(), dist.get_world_size()]
    out["after"] = dist.is_initialized()
    try:
        with mesh.fake_world(4):
            raise KeyError("inside")
    except KeyError:
        pass
    out["after_error"] = dist.is_initialized()
    try:
        dryrun.run_cell("qwen1.5-0.5b", "long_500k")
    except ValueError as e:
        out["skip"] = str(e)
    out["after_skip"] = dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(TMP, 'rdzv')}", world_size=1, rank=0)
    try:
        try:
            with mesh.fake_world(4):
                out["over_gloo"] = "entered"
        except RuntimeError as e:
            out["over_gloo"] = str(e)
        out["gloo_kept"] = [dist.get_backend(), dist.get_world_size()]
        try:
            mesh.make_mesh((1,), ("data",), "fake")
        except RuntimeError as e:
            out["fake_mesh_over_gloo"] = str(e)
    finally:
        dist.destroy_process_group()
    out["env"] = sorted(k for k in set(ENV_BEFORE) | set(os.environ) if ENV_BEFORE.get(k) != os.environ.get(k))
    return out


def coll() -> dict:
    out = {}
    for g in (1, 2, 4):
        with mesh.fake_world(g):
            m = mesh.make_mesh((g,), ("data",), "fake")
            x = torch.empty((3, 5), dtype=torch.float32, device="meta")
            collectives.reset_collective_counts()
            full = collectives.gather_full(x, (Shard(0),), m)
            gathered = collectives.collective_bytes()["all_gather"]
            collectives._all_reduce(torch.empty((7, 2), dtype=torch.bfloat16, device="meta"), m.get_group("data"))
            mine = collectives._reduce_scatter(torch.empty((g, 6), dtype=torch.bfloat16, device="meta"),
                                               m.get_group("data"))
            out[g] = {"shape": list(full.shape), "bytes": collectives.collective_bytes(),
                      "gathered": gathered, "counts": collectives.collective_counts(),
                      "scattered": list(mine.shape)}
    return out


def split() -> dict:
    """The peak's split of one deepseek-moe-16b train step under "tp" on a
    fake (2, 2) mesh, beside the bytes of one stack of its routed experts
    (gate, up and down of every MoE layer, every expert, fp32)."""
    from repro_torch.models import transformer

    shape = dryrun.SHAPES["train_4k"]
    dryrun.SHAPES["train_4k"] = dataclasses.replace(shape, seq_len=SPLIT_SEQ)
    try:
        rec = dryrun.run_cell("deepseek-moe-16b", "train_4k", profile="tp", n_micro=1, mesh_shape=(2, 2),
                              global_batch=2)
    finally:
        dryrun.SHAPES["train_4k"] = shape
    defs = transformer.model_defs(configs.get("deepseek-moe-16b"))["layers"]["moe"]
    stack = sum(4 * math.prod(defs[k].shape) for k in ("gate", "up", "down"))
    return {"split": rec["memory"]["split"], "peak": rec["memory"]["peak_bytes"], "routed_stack": stack}


if __name__ == "__main__":
    torch.set_num_threads(1)
    TMP = os.path.dirname(os.path.abspath(sys.argv[1]))
    result = {"import_env": IMPORT_ENV, "hygiene": hygiene(), "coll": coll(), "split": split(), "bytes": param_bytes(),
              "flops": flops(), "opt": opt(TMP), "cells": cells(TMP)}
    with open(sys.argv[1], "w") as f:
        json.dump(result, f)
