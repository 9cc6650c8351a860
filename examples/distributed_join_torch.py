"""Distributed SP-Join on torch.distributed: per-rank stats, the parameter
all-gather, the replicated Gibbs chain, the cell exchange and the verify
stage, checked against brute force.

    PYTHONPATH=src python examples/distributed_join_torch.py              # NCCL, one rank per card
    PYTHONPATH=src python examples/distributed_join_torch.py --device cpu # 4 gloo ranks on the CPU

Ranks are spawned processes that meet at a file rendezvous in a temporary
directory; every rank calls ``distributed_join`` with the same arguments.
"""
import argparse
import datetime
import multiprocessing as mp
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed, spjoin
from repro_torch.data import synthetic

TIMEOUT_S = 600  # per rank


def _sets():
    data = synthetic.mixture(n=4000, m=12, n_clusters=6, skew=0.4, seed=0)
    r, s = synthetic.rs_mixture(n_r=400, n_s=3000, m=12, n_clusters=6,
                                skew=0.4, shift=3.0, seed=1)
    return data, r, s


def _rank_main(rank: int, world: int, device: str, tmp: str) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo", init_method=f"file://{tmp}/rdzv",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    try:
        data, r, s = _sets()
        kw = dict(delta=6.0, metric="l1", k=384, p=16, n_dims=6, sampler="generative",
                  emit_pairs=True, seed=0, device=device)
        res = distributed.distributed_join(data, **kw)
        res_rs = distributed.distributed_join(r, s=s, **kw)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "result.pkl"), "wb") as f:
            pickle.dump((res, res_rs), f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help='"cuda" (default, NCCL) or "cpu" (gloo)')
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device; pass --device cpu for gloo ranks")
    world = torch.cuda.device_count() if args.device == "cuda" else 4
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, world, args.device, tmp))
                 for r in range(world)]
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
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            res, res_rs = pickle.load(f)

    print(f"world: {world} {'NCCL' if args.device == 'cuda' else 'gloo'} ranks on {args.device}")
    print(f"pairs found:        {res.pairs.shape[0]}")
    print(f"verifications:      {res.n_verifications}")
    print(f"dispatch overflow:  {res.overflow} (exact-fit capacity planning)")
    print(f"capacity padding:   {res.capacity_padding:.2f}x")
    print(f"node confidences:   {res.node_confidences.round(3)}")
    print(f"gibbs accept rate:  {res.accept_rate:.2f}")
    data, r, s = _sets()
    truth = spjoin.brute_force_pairs(data, 6.0, "l1", device=args.device)
    assert np.array_equal(res.pairs, truth)
    print("exactness check vs brute force: OK")

    print(f"\nR×S join |R|={r.shape[0]} x |S|={s.shape[0]}")
    print(f"cross pairs found:  {res_rs.pairs.shape[0]} (i ∈ R, j ∈ S)")
    print(f"verifications:      {res_rs.n_verifications}")
    print(f"S-side duplication: {res_rs.duplication:.2f}x (Σ|W_h| / |S|)")
    truth_rs = spjoin.brute_force_pairs(r, 6.0, "l1", s=s, device=args.device)
    assert np.array_equal(res_rs.pairs, truth_rs)
    print("R×S exactness check vs brute force: OK")


if __name__ == "__main__":
    main()
