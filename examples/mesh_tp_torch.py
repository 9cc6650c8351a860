"""The "tp" mesh step on four ranks against the single-process step.

    PYTHONPATH=src python examples/mesh_tp_torch.py               # 4 cards, NCCL
    PYTHONPATH=src python examples/mesh_tp_torch.py --device cpu  # 4 gloo ranks on the CPU

Four spawned ranks meet at a file rendezvous in a temporary directory and
form a (2, 2) ("data", "model") mesh. Each holds its shards of the arch at
full width on ``--layers`` layers (act fp32, seeded weights, placed by the
tensor-parallel rules) and takes ``--steps`` steps of
``make_mesh_train_step`` on its rows of the pipeline's batches: every rank
computes its share of each block along "model" (its heads, FFN columns and
vocabulary rows) and the all-reduces over "model" complete them. Rank 0
then takes the same steps from the same weights through
``make_train_step`` on the whole batches. Printed: both paths' losses and
grad norms, the mesh step's collectives and seconds per step; the exit
code is 1 when a rank's metrics differ from rank 0's or the two paths'
losses or grad norms differ by more than LOSS_REL / GNORM_REL.
"""
import argparse
import dataclasses
import datetime
import json
import multiprocessing as mp
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_lib
from repro_torch.models import collectives, transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

WORLD = 4
TIMEOUT_S = 600  # per rank
LOSS_REL = 1e-5  # |loss mesh - loss single| / loss single at each step, act fp32: the row splits
#   and the ranks' gradient sums add in another order than one product, a few ulps a step
GNORM_REL = 1e-4  # the same for grad_norm, a norm over every gradient element


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_main(rank: int, args: argparse.Namespace, tmp: str) -> None:
    torch.set_num_threads(1)
    dev = torch.device("cuda", rank) if args.device == "cuda" else torch.device("cpu")
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"file://{tmp}/rdzv",
                            world_size=WORLD, rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    try:
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), dev.type)
        cfg = dataclasses.replace(configs.get(args.arch), n_layers=args.layers, act_dtype="float32")
        single = train_lib.build_model(cfg, seed=0, device=dev)
        model = transformer.ShardedTransformer(cfg, single.param_tree(), mesh)
        ocfg = opt.OptConfig(total_steps=20, warmup_steps=2)
        pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=args.seq, global_batch=args.batch))
        state = opt.init_opt_state(model.param_tree(), ocfg)
        step = ts.make_mesh_train_step(cfg, ocfg, ts.StepConfig())
        out = {"mesh": [], "collectives": [], "seconds": [], "coord": list(mesh.get_coordinate()),
               "kv_split": dataclasses.asdict(model.kv_split)}
        for i in range(args.steps):
            batch = pipe.device_batch(i, mesh)
            collectives.reset_collective_counts()
            _sync(dev)
            t0 = time.perf_counter()
            model, state, m = step(model, state, batch)
            _sync(dev)
            out["seconds"].append(time.perf_counter() - t0)
            out["collectives"].append(collectives.collective_counts())
            out["mesh"].append({k: float(v) for k, v in m.items()})
        del model, state
    finally:
        dist.destroy_process_group()
    if rank == 0:
        state = opt.init_opt_state(single.param_tree(), ocfg)
        step = ts.make_train_step(cfg, ocfg, ts.StepConfig())
        out["single"] = []
        for i in range(args.steps):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in pipe.global_batch(i).items()}
            single, state, m = step(single, state, batch)
            out["single"].append({k: float(v) for k, v in m.items()})
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help='"cuda" (default, NCCL, 4 cards) or "cpu" (gloo)')
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4, help="global batch (2 rows a data rank)")
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() < WORLD:
        raise SystemExit(f"--device cuda needs {WORLD} CUDA devices; pass --device cpu for gloo ranks")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, args, tmp)) for r in range(WORLD)]
        for pr in procs:
            pr.start()
        try:
            for pr in procs:
                pr.join(TIMEOUT_S)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                    pr.join(10)
        codes = [pr.exitcode for pr in procs]
        if any(c != 0 for c in codes):
            raise SystemExit(f"a rank failed: exit codes {codes}")
        res = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))

    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(f"{args.arch} on {args.layers} layers at full width, act fp32, batch {args.batch} x {args.seq}: "
          f"{WORLD} {'NCCL' if args.device == 'cuda' else 'gloo'} ranks on {name}, (2, 2) (data, model) mesh")
    same = all(r["mesh"] == res[0]["mesh"] for r in res)
    ok = same
    for r in res:
        print(f"  rank at {tuple(r['coord'])}: heads {r['kv_split']['heads']}, kv heads {r['kv_split']['kv_heads']}")
    for i, (m, s) in enumerate(zip(res[0]["mesh"], res[0]["single"])):
        rel_l = abs(m["loss"] - s["loss"]) / abs(s["loss"])
        rel_g = abs(m["grad_norm"] - s["grad_norm"]) / abs(s["grad_norm"])
        ok = ok and rel_l <= LOSS_REL and rel_g <= GNORM_REL
        print(f"  step {i + 1}: mesh loss {m['loss']!r} grad_norm {m['grad_norm']!r} in "
              f"{max(r['seconds'][i] for r in res):.4f}s; single loss {s['loss']!r} grad_norm {s['grad_norm']!r}; "
              f"rel {rel_l:.3e} (bar {LOSS_REL}), {rel_g:.3e} (bar {GNORM_REL}); collectives "
              f"{json.dumps(res[0]['collectives'][i])}")
    print(f"every rank's metrics equal rank 0's: {same}")
    print("tp mesh step vs single step: " + ("OK" if ok else "FAILED"))
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
