"""The dry-run sweep with each architecture's execution choices (the port
of ``repro.launch.dryrun_opt``): the reference's choices, carried over as
choices.

  train_4k        the FSDP profile (batch over every rank, weights ZeRO-3)
                  for the dense, ssm, hybrid, audio and vlm archs on the
                  single pod; the MoE archs keep the tensor-parallel
                  profile with expert parallelism and 4 microbatches; on
                  the multi-pod mesh the global batch of 256 does not
                  split over 512 ranks, so the TP profile.
  prefill, decode the TP profile.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_opt \\
        [--arch A ...] [--shape S ...] [--single-pod] [--out runs/dryrun_opt.jsonl]

Writes one record a cell (``dryrun.run_cell``'s, with the choice under
``"opt"``); a failed cell is written with ``error`` and the sweep goes on.
Baseline table: ``python -m repro_torch.launch.dryrun --all``.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch import configs
from repro_torch.launch import dryrun

MOE_TP = {"deepseek-moe-16b", "llama4-scout-17b-a16e"}


def config_for(arch: str, shape: str, multi_pod: bool = False) -> dict:
    if shape == "train_4k":
        if arch in MOE_TP:
            return dict(profile="tp", n_micro=4)
        if multi_pod:
            return dict(profile="tp")
        return dict(profile="fsdp")
    return dict(profile="tp")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=None, help="these archs only")
    ap.add_argument("--shape", nargs="+", default=None, help="these shapes only")
    ap.add_argument("--single-pod", action="store_true", help="the single-pod mesh only")
    ap.add_argument("--out", default="runs/dryrun_opt.jsonl")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if "error" not in r:
                    done.add((r["arch"], r["shape"], r["mesh"]))
    with open(args.out, "a") as f:
        for a, s, ok, why in configs.all_cells():
            if (args.arch and a not in args.arch) or (args.shape and s not in args.shape):
                continue
            for mp in ((False,) if args.single_pod else (False, True)):
                mesh_name = "multi_pod" if mp else "single_pod"
                if not ok or (a, s, mesh_name) in done:
                    continue
                kw = config_for(a, s, mp)
                print(f"=== {a} x {s} [{mesh_name}] {kw} ===", flush=True)
                try:
                    rec = dryrun.run_cell(a, s, mp, **kw)
                    rec["opt"] = kw
                    print(
                        f"    mfu_bound={rec.get('mfu_bound')} "
                        f"bottleneck={rec.get('roofline', {}).get('bottleneck')} "
                        f"fits={rec.get('fits')} [{rec.get('total_s')}s]", flush=True)
                except Exception as e:  # a failed cell is recorded; the sweep goes on
                    rec = {"arch": a, "shape": s, "mesh": mesh_name,
                           "error": str(e),
                           "traceback": traceback.format_exc()[-1500:]}
                    print(f"    ERROR: {e}", flush=True)
                f.write(json.dumps(rec) + "\n")
                f.flush()


if __name__ == "__main__":
    main()
