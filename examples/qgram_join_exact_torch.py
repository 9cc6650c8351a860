"""Exactness of the join on q-gram profiles, held against brute force.

Hashed 2-gram count vectors of mutated strings (the aol-like set of the
paper's comparison) under l1 at δ = 4: the distances are small integers, so
many pairs sit at exactly δ, and along an anchor the triangle inequality is
often tight. The join runs under dedup's config, the comparison's SP-Join
config and KPM's, and each pair set is compared with a float64 brute force.
For every pair a join missed, the script prints its distance, the L∞ gap of
its mapped coordinates and how far the partner lies outside the whole box
of the cell that had to verify it.

The bins come from ``hash()``: fix ``PYTHONHASHSEED`` to get the same rows
in two runs. ``--src`` puts another checkout's ``src`` first on the path,
so two trees can be compared on the same rows.

    PYTHONHASHSEED=1 PYTHONPATH=src python examples/qgram_join_exact_torch.py
    PYTHONHASHSEED=1 PYTHONPATH=src python examples/qgram_join_exact_torch.py --rows 20000 --device cpu
"""
import argparse
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=250_000)
    ap.add_argument("--seed", type=int, default=2, help="string generator seed")
    ap.add_argument("--delta", type=float, default=4.0)
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    ap.add_argument("--src", default=None, help="a checkout's src directory to import from")
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, args.src)

    import numpy as np
    import torch

    from repro_torch.core import baselines, partition, spjoin
    from repro_torch.core import verify as verify_lib
    from repro_torch.data import synthetic, vectorize

    n, delta = args.rows, args.delta
    strs = synthetic.strings(n, mutate=0.12, n_templates=max(n // 47, 1), seed=args.seed)
    x = torch.as_tensor(vectorize.qgram_profile(strs, q=2, dim=64)).to(args.device)
    out = []
    for i0 in range(0, n, 4096):
        hit = torch.cdist(x[i0 : i0 + 4096].double(), x.double(), p=1) <= delta
        hit &= torch.arange(n, device=x.device)[None, :] > torch.arange(i0, i0 + hit.shape[0], device=x.device)[:, None]
        i, j = torch.nonzero(hit, as_tuple=True)
        out.append(torch.stack([i + i0, j], 1))
    truth = torch.cat(out).cpu().numpy()
    truth = truth[np.lexsort((truth[:, 1], truth[:, 0]))]
    print(f"{args.src or 'src'}: {n} rows, seed {args.seed}, delta {delta}: {len(truth)} pairs by brute force")

    # Keep the plan, coordinates and membership the join verifies with.
    seen = {}
    tighten, verify_pairs = partition.tighten, verify_lib.verify_pairs

    def keep_plan(*a, **k):
        seen["plan"] = tighten(*a, **k)
        return seen["plan"]

    def keep_inputs(data, cells, member, *a, **k):
        seen.update(cells=np.asarray(cells), member=np.asarray(member), coords=k["coords"])
        return verify_pairs(data, cells, member, *a, **k)

    spjoin.partition.tighten, spjoin.verify_lib.verify_pairs = keep_plan, keep_inputs
    configs = {
        "dedup": spjoin.JoinConfig(delta=delta, metric="l1", k=min(512, max(n // 4, 16)), p=8, n_dims=8),
        "spjoin": spjoin.JoinConfig(delta=delta, metric="l1", k=1024, p=16, n_dims=8),
        "kpm": baselines.kpm_config(delta, "l1", k=1024, p=16, n_dims=8),
    }
    xn = x.double().cpu().numpy()
    for name, cfg in configs.items():
        if x.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = spjoin.join(x, cfg, device=args.device)
        wall = time.perf_counter() - t0
        got = {tuple(p) for p in res.pairs.tolist()}
        want = {tuple(p) for p in truth.tolist()}
        missed, extra = sorted(want - got), sorted(got - want)
        print(f"  {name}: pairs == brute force {res.pairs.tobytes() == truth.tobytes()}; missed {len(missed)}, "
              f"extra {len(extra)}; n_verifications {res.n_verifications}, n_exact "
              f"{res.verify_stats.n_exact}; wall {wall:.3f} s (verify {res.verify_time_s:.3f} s)")
        if not missed or "plan" not in seen:
            continue
        cells, c = seen["cells"], seen["coords"].double().cpu().numpy()
        lo, hi = (b.double().cpu().numpy() for b in (seen["plan"].whole_lo, seen["plan"].whole_hi))
        for i, j in missed[:8]:
            g, h = int(cells[i]), int(cells[j])
            cell, other = (g, j) if g <= h else (h, i)
            outside = max(float((lo[cell] - c[other]).max()), float((c[other] - hi[cell]).max()))
            print(f"    missed ({i}, {j}): distance {np.abs(xn[i] - xn[j]).sum()}, coordinate gap "
                  f"{np.abs(c[i] - c[j]).max():.6f}, cells {g}/{h}, partner {other} outside cell "
                  f"{cell}'s whole box by {outside:.3e}")


if __name__ == "__main__":
    main()
