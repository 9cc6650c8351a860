"""Multi-pod dry run: every (architecture x shape x mesh) cell built for
the production mesh and one step of it accounted for, without a card (the
port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k [--multi-pod] [--profile tp|fsdp|fsdp_sp] [--out runs/dryrun.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--only-missing]

A cell runs in this one process, as rank 0 of a fake world of the mesh's
size (``mesh.fake_world``: 256 ranks single-pod, 512 multi-pod; its
collectives move nothing), on the ``meta`` device: the model is
``ShardedTransformer`` over ``base.abstract_params`` on
``make_production_mesh(device="fake")``, placed by the profile's rules,
and the step is the port's own (``make_mesh_train_step``,
``make_prefill_step`` or ``make_serve_step``) run once under
``stepcount.count_step``. Nothing is allocated, and the process needs no
card. Importing this module touches no environment variable and no
process group.

The rank's inputs are the rows the port's mesh path gives it: dim 0 of the
batch over the profile's batch axes (``shardings.batch_spec``: replicated
where they do not divide it). Under "tp" each rank computes its share of
every block along "model" (``ShardedTransformer``: heads, FFN columns,
experts, vocabulary rows), so a decode state holds the rank's batch rows
and, where its attention is split by heads, its kv heads
(``"state_layout": "heads"``, the reference's ``state_shardings`` placement
of a GQA cache); where it is not (an MQA model's one kv head split inside
the head, heads that do not divide "model") every kv head
(``"state_layout": "rows"``), as under "fsdp". ``"gathered_projections"``
names the attention leaves whose projections this rank computes on its
columns and gathers whole along "model" (their attention then runs on
whole heads, and the heads its rows of ``wo`` straddle are computed on two
ranks).

The record keeps the reference's keys where they mean the same thing, per
rank and per step: ``memory.{argument_bytes, output_bytes, temp_bytes,
peak_bytes}`` (arguments: the rank's parameter and optimizer shards and
its inputs; outputs: what the step returns in storages it allocated, the
train step updating parameters and optimizer state in place; temp: the
peak less the arguments), ``flops_per_device``, ``coll_bytes_per_device``,
``coll_breakdown`` (wire bytes by the port's collective kinds),
``dot_traffic_per_device``, ``roofline`` against ``H100_SXM`` (compute at
the dense bf16 peak, memory the dot traffic at the HBM rate, collectives at
the NVLink rate), ``model_flops``, ``useful_flops_ratio``, ``mfu_bound``,
``params_total``/``params_active``. It adds ``build_s``/``step_s`` (for the
reference's ``lower_s``/``compile_s``), ``fits`` (peak within the card's
HBM), ``memory.split`` (``stepcount``'s kinds at the peak),
``coll_counts``, ``rows_per_rank``, ``params_bytes``/``optimizer_bytes``
(the rank's shards, also written under ``--no-step``) and ``hardware``. It drops the
reference's ``xla_*``, ``hlo_bytes``, ``fusion_traffic_per_device`` and
``top_flop_computations``: they describe XLA's compiled module, and the
port compiles none. A cell that does not fit is reported, not refused or
shrunk; a cell that fails is written with ``error`` and ``traceback`` and
the sweep goes on.

``--mesh-shape``, ``--global-batch`` and ``--reduced`` build a cell off
the production mesh (a test's (2, 2) mesh on the reduced configs, a
card's (1, 1) mesh at a batch that fits it). ``--reduced`` keeps the full
config's attention chunks: the reduced configs' 32-token chunks are sized
for tests at 32 tokens, and at the shapes' lengths they would only add
blocks.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any

import torch

from repro_torch import configs
from repro_torch.launch import shardings as shlib
from repro_torch.launch import stepcount
from repro_torch.launch.mesh import H100_SXM, fake_world, make_mesh, make_production_mesh
from repro_torch.models import base, transformer
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _arch_config(arch: str, reduced: bool = False, remat: str | None = None):
    """``arch``'s config (reduced: at the full config's attention chunks)."""
    cfg = configs.get(arch)
    if reduced:
        cfg = dataclasses.replace(configs.get_reduced(arch), attn_q_chunk=cfg.attn_q_chunk,
                                  attn_kv_chunk=cfg.attn_kv_chunk)
    return cfg if remat is None else dataclasses.replace(cfg, remat=remat)


def _mesh(multi_pod: bool, mesh_shape: tuple[int, ...] | None):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device="fake")
    return make_mesh(tuple(mesh_shape), AXES[len(mesh_shape)], "fake")


def _mesh_name(multi_pod: bool, mesh_shape: tuple[int, ...] | None) -> str:
    if mesh_shape:
        return "x".join(map(str, mesh_shape))
    return "multi_pod" if multi_pod else "single_pod"


def _rows(mesh, global_batch: int, batch_axes: tuple[str, ...]) -> int:
    """The batch rows this rank holds (``shardings.batch_spec``)."""
    spec = shlib.batch_spec(mesh, (global_batch,), batch_axes)
    if not spec:
        return global_batch
    axes = (spec[0],) if isinstance(spec[0], str) else spec[0]
    return global_batch // math.prod(base.axis_sizes(mesh)[a] for a in axes)


def build_cell(arch: str, shape_name: str, multi_pod: bool, profile: str = "tp",
               param_dtype: torch.dtype | None = None, remat: str | None = None,
               n_micro: int | None = None, *, mesh_shape: tuple[int, ...] | None = None,
               global_batch: int | None = None, reduced: bool = False):
    """The parts of one cell in the current (fake) world: (step thunk, the
    tensors it holds before it runs by kind, meta, cfg, shape). Call it
    inside ``fake_world``."""
    cfg = _arch_config(arch, reduced, remat)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"skip: {why}")
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    mesh = _mesh(multi_pod, mesh_shape)
    model = transformer.ShardedTransformer(
        cfg, base.abstract_params(transformer.model_defs(cfg)), mesh, profile=profile)
    if param_dtype is not None:
        model.to(param_dtype)
    rows = _rows(mesh, shape.global_batch, model.batch_axes)
    local = configs.input_specs(cfg, dataclasses.replace(shape, global_batch=rows), abstract=True)
    held = {"parameters": list(model.parameters())}

    if shape.kind == "train":
        if n_micro is None:
            n_batch = math.prod(base.axis_sizes(mesh)[a] for a in model.batch_axes)
            n_micro = max(1, shape.global_batch // n_batch)
        ocfg = opt_lib.OptConfig()
        opt_state = opt_lib.init_opt_state(model.param_tree(), ocfg)
        step = ts.make_mesh_train_step(cfg, ocfg, ts.StepConfig(n_micro=n_micro))
        batch = local["batch"]
        held.update(optimizer=base.tree_leaves(opt_state), inputs=list(batch.values()))
        meta = {"entry": "train_step", "n_micro": n_micro}

        def run():
            return step(model, opt_state, batch)
    elif shape.kind == "prefill":
        step = ts.make_prefill_step(cfg)
        batch = local["batch"]
        held["inputs"] = list(batch.values())
        meta = {"entry": "prefill_step"}

        def run():
            return step(model, batch)
    else:  # decode: one token against a state holding seq_len - 1 tokens
        step = ts.make_serve_step(cfg)
        token, state, length = local["token"], model.init_state(rows, shape.seq_len), shape.seq_len - 1
        held["inputs"] = [token, *base.tree_leaves(state)]
        hs = model.kv_split if cfg.family != "ssm" else None
        meta = {"entry": "serve_step", "state_layout": "heads" if hs is not None and hs.kv == "heads" else "rows"}

        def run():
            return step(model, token, state, length)

    sizes = base.axis_sizes(mesh)
    hs = model.kv_split if cfg.family != "ssm" else None
    meta.update(mesh_shape=str(sizes), chips=math.prod(sizes.values()), profile=profile,
                rows_per_rank=rows,
                gathered_projections=[f"attn/{k}" for k in hs.gathered] if hs is not None else [])
    return run, held, meta, cfg, shape


def _storages(tree) -> dict[int, int]:
    """{storage: bytes} of the tensors in a result (dicts, tuples, lists)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        out: dict[int, int] = {}
        for v in tree:
            out.update(_storages(v))
        return out
    if isinstance(tree, torch.Tensor):
        st = tree.untyped_storage()
        return {st._cdata: st.nbytes()}
    return {}


def run_cell(
    arch: str, shape_name: str, multi_pod: bool = False, do_step: bool = True,
    profile: str = "tp", param_dtype: torch.dtype | None = None, remat: str | None = None,
    n_micro: int | None = None, *, mesh_shape: tuple[int, ...] | None = None,
    global_batch: int | None = None, reduced: bool = False,
) -> dict[str, Any]:
    t0 = time.time()
    chips = math.prod(mesh_shape) if mesh_shape else (512 if multi_pod else 256)
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod, mesh_shape)}
    with fake_world(chips):
        run, held, meta, cfg, shape = build_cell(
            arch, shape_name, multi_pod, profile, param_dtype, remat, n_micro,
            mesh_shape=mesh_shape, global_batch=global_batch, reduced=reduced)
        rec.update(meta)
        arg_stores = _storages([t for ts_ in held.values() for t in ts_])
        rec["build_s"] = round(time.time() - t0, 1)
        rec["hardware"] = "H100 SXM (data sheet constants)"
        rec["params_bytes"] = sum(_storages(held["parameters"]).values())
        rec["optimizer_bytes"] = sum(_storages(held.get("optimizer", [])).values())
        if not do_step:
            return rec
        t1 = time.time()
        with torch.no_grad():  # the train step records its own forward
            result, acct = stepcount.count_step(run, held)
        rec["step_s"] = round(time.time() - t1, 1)
    argument = sum(arg_stores.values())
    output = sum(n for k, n in _storages(result).items() if k not in arg_stores)
    rec["memory"] = {
        "argument_bytes": argument,
        "output_bytes": output,
        "temp_bytes": acct["peak_bytes"] - argument,
        "peak_bytes": acct["peak_bytes"],
        "split": acct["memory_split"],
    }
    rec["fits"] = acct["peak_bytes"] <= H100_SXM.hbm_bytes
    rec["flops_per_device"] = acct["flops"]
    rec["coll_bytes_per_device"] = sum(acct["coll_bytes"].values())
    rec["coll_breakdown"] = acct["coll_bytes"]
    rec["coll_counts"] = acct["coll_counts"]
    rec["dot_traffic_per_device"] = acct["dot_traffic"]

    terms = {
        "compute_s": rec["flops_per_device"] / H100_SXM.peak_flops,
        "memory_s": rec["dot_traffic_per_device"] / H100_SXM.hbm_bw,
        "collective_s": rec["coll_bytes_per_device"] / H100_SXM.link_bw,
    }
    rec["roofline"] = {k: float(v) for k, v in terms.items()}
    rec["roofline"]["bottleneck"] = max(terms, key=lambda k: terms[k])
    step_s = max(terms.values())
    total, active = cfg.n_params_active
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    rec["model_flops"] = float((6 if shape.kind == "train" else 2) * active * tokens)
    all_flops = rec["flops_per_device"] * rec["chips"]
    rec["useful_flops_ratio"] = rec["model_flops"] / all_flops if all_flops else None
    rec["mfu_bound"] = (rec["model_flops"] / (step_s * rec["chips"] * H100_SXM.peak_flops)
                        if step_s > 0 else None)
    rec["params_total"] = total
    rec["params_active"] = active
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def _mesh_shape(text: str) -> tuple[int, ...]:
    shape = tuple(int(n) for n in text.split(","))
    if len(shape) not in AXES:
        raise argparse.ArgumentTypeError("a mesh shape is D,M or P,D,M")
    return shape


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--no-step", action="store_true", help="build and place only")
    ap.add_argument("--profile", default="tp", choices=["tp", "fsdp", "fsdp_sp"])
    ap.add_argument("--param-dtype", default=None, choices=[None, "bfloat16"])
    ap.add_argument("--remat", default=None, choices=[None, "full", "dots", "none"])
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--mesh-shape", type=_mesh_shape, default=None,
                    help="D,M or P,D,M in place of the production mesh")
    ap.add_argument("--global-batch", type=int, default=None, help="in place of the shape's")
    ap.add_argument("--reduced", action="store_true", help="the reduced configs")
    ap.add_argument("--out", default="runs/dryrun.jsonl")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done: set[tuple[str, str, str]] = set()
    if args.only_missing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if "error" not in r:
                    done.add((r["arch"], r["shape"], r["mesh"]))

    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for a, s, ok, why in configs.all_cells():
            for mp in ((False,) if args.mesh_shape else (False, True)):
                if ok:
                    cells.append((a, s, mp))
                else:
                    print(f"SKIP {a} x {s}: {why}")
    else:
        cells.append((args.arch, args.shape, args.multi_pod))

    with open(args.out, "a") as f:
        for a, s, mp in cells:
            mesh_name = _mesh_name(mp, args.mesh_shape)
            if (a, s, mesh_name) in done:
                continue
            print(f"=== {a} x {s} [{mesh_name}] ===", flush=True)
            try:
                rec = run_cell(a, s, mp, do_step=not args.no_step, profile=args.profile,
                               param_dtype=torch.bfloat16 if args.param_dtype else None,
                               remat=args.remat, n_micro=args.n_micro, mesh_shape=args.mesh_shape,
                               global_batch=args.global_batch, reduced=args.reduced)
                print(
                    f"    flops/dev={rec.get('flops_per_device', 0):.3e} "
                    f"coll/dev={rec.get('coll_bytes_per_device', 0):.3e} "
                    f"bottleneck={rec.get('roofline', {}).get('bottleneck')} "
                    f"mfu_bound={rec.get('mfu_bound')} fits={rec.get('fits')} [{rec.get('total_s')}s]",
                    flush=True,
                )
                if rec.get("memory"):
                    print(f"    memory={rec['memory']}", flush=True)
            except Exception as e:  # a failed cell is recorded; the sweep goes on
                rec = {
                    "arch": a, "shape": s, "mesh": mesh_name,
                    "error": str(e), "traceback": traceback.format_exc()[-2000:],
                }
                print(f"    ERROR: {e}", flush=True)
            f.write(json.dumps(rec) + "\n")
            f.flush()


if __name__ == "__main__":
    main()
