"""Drive the PyTorch/CUDA port of SP-Join on one NVIDIA GPU and check it.

    python3 chip_smoke.py    # one card; takes no arguments

Phases, in order; any failure raises and exits non-zero (nothing is caught):
  1. environment — card name and power limit, torch/CUDA versions, TF32 off;
  2. build       — every CUDA kernel compiled from the sources in the
                   checkout with nvcc for sm_90a, in parallel (timed), with
                   each kernel's registers and spill bytes from ptxas;
  3. kernels     — each kernel against its plain PyTorch version on the card
                   at ragged shapes and at the main path's shapes, with times
                   (kernel wrapper, ops call, plain, library yardstick) and
                   the roofline bound; verify-compact self and R x S, with
                   and without pivot coordinates, and with a forced
                   overflow; the verify tile's paths (bp 1/3/8/17, m
                   33/100/128, rows one row or one float into a buffer,
                   tiles smaller than a CTA, mixed live and dead sub-tiles),
                   where the compact kernel's pairs must equal the filtered
                   mask after validity and the min-cell rule exactly; live
                   shares per skip granularity, both CTA tiles' times, and
                   the cost of a 16-feature chunk (l1 against dot);
                   map-assign at n_dims and p past 64 and 32 (n_dims
                   8/16/64/72/130 x p 16/100/1024 x every metric and want,
                   ragged rows; every launch plan bit-identical to the
                   default one); the histogram at ragged shapes, edge
                   values, zero weights, rows one float into a buffer and
                   t in 1/8/383/384/1024/5000/20000 (registers, shared and
                   global counting), and at the stats stage's 1,000,000 x
                   128, t = 8 (exact, torch.equal), timed through its C
                   entry point against its 0.25 ms target;
  lm_serve       — the LM stack's serving path (no kernel of the repo; the
                   launch counts must read 0 after it), weights from a
                   seeded generator on the card, 8 requests x 128 prompt
                   tokens prefilled by decode and greedy tokens through
                   launch.serve's functions (seconds, tok/s, parameter and
                   decode-state bytes, build and run peak GiB, a profiled
                   window); every run holds (c) every id in [0, vocab) and
                   the same ids from the same steps run again.
                   qwen1.5-0.5b at full width and depth (64 generated):
                   check (a) forward's and prefill_step's logits against
                   the decode path's at every prompt position (rtol = atol
                   = 0.15, argmax agreement > 0.95 at bf16 resolution), (b)
                   the same model at act fp32 on the card and on the CPU
                   (ids equal, logits within 1e-2 of the largest); the same
                   draw under the reference's init logged beside it;
                   granite-34b at full width on 4 of its 88 layers (a
                   printed "reduced" line: MQA, GELU) with (a). Then the
                   moe, hybrid and ssm families: deepseek-moe-16b at full
                   width and depth (64 generated), llama4-scout on 2 of 48
                   layers, zamba2-2.7b and xlstm-1.3b at full width and
                   depth (16 generated); their bf16 whole-model (a) gaps
                   are logged against the family's bar (not asserted: at
                   full width they amplify a rounding past it), and their
                   check (a) is the whole model at act fp32 (deepseek and
                   zamba2 at full depth, llama4 on its 2 layers, KV caches
                   in fp32 for moe; xlstm on one group of 8 layers), forward
                   against decode at every prompt position (0.15 bar and
                   agreement > 0.95; xlstm agreement > 0.9), with each
                   routed or recurrent block's full-sequence form against
                   its decode form on the served weights (0.15 bar); check
                   (b) on a cut depth with one of each block kind. Its
                   seconds come out of the main path's share;
  lm_train       — the LM stack's training path through launch.train's
                   functions, outside inference mode (no kernel of the repo;
                   the launch counts must read 0 after it): (a) qwen1.5-0.5b
                   at full width and depth, bf16 activations over fp32
                   leaves, remat "full", 4 x 4,096 tokens (train_4k's
                   length) in 2 microbatches, 6 steps on one fixed pipeline
                   batch: loss finite and falling, grad_norm finite, lr equal
                   to lr_at; seconds per step, tokens/s, model FLOP/s and its
                   share of the bf16 peak, parameter and optimizer bytes,
                   peak GiB, one profiled step (busy share, launches, time by
                   kernel). On its cut to 2 layers (a printed "reduced"
                   line), batch 2 x 256: (b) act fp32, 2 steps on the card
                   and on the CPU from the same weights (loss, grad_norm,
                   every leaf); (c) act fp32, the n_micro = 2 gradient
                   against n_micro = 1; (d) bf16, 2 steps, a checkpoint
                   under build/, restored into fresh objects, 2 more steps,
                   the loss against a straight 4-step run (rel 1e-5; bit
                   equality logged; bytes, save and restore seconds); (e)
                   4 steps with int8 error-feedback compression falling. Its
                   seconds come out of the main path's share too;
  lm_mesh        — the mesh layer (launch.mesh, ShardedTransformer, the
                   expert-parallel MoE) in an NCCL world of 1 rank (file
                   rendezvous in a temporary directory, destroyed in a
                   finally; no kernel of the repo, the launch counts must
                   read 0): (a) qwen1.5-0.5b at full width and depth on a
                   (1, 1) ("data", "model") mesh, parameters placed by
                   LOGICAL_RULES, 2 steps of lm_train's batch through the
                   mesh step and the same 2 from a copy of the weights
                   through the single-process step: loss and grad_norm
                   within the stated tolerances (bit equality logged),
                   s/step of each and the collectives per step, equal to
                   the contract checker's budget for the cell
                   (tools/spjoin_lint_torch/port_budgets.json: the step
                   gathers one layer at a time along "data", reduce-scatters
                   its gradients, and runs the "tp" split with one rank
                   along "model", each block's share completed by an
                   all-reduce); (b)
                   deepseek-moe-16b's MoE block at full width (64 experts,
                   top-6, 2 shared, expert d_ff 1408) at fp32: the
                   expert-parallel dispatch of 4 virtual ranks (16 experts
                   each) summed against the local dispatch, and in bf16
                   moe_block under the (1, 1) mesh equal to the local path
                   bit for bit; (c) the "tp" split of qwen1.5-0.5b at full
                   width as 2 and as 4 virtual "model" ranks (each its
                   vocabulary rows of the embedding, its heads and rows of
                   wo, its FFN columns and rows, its vocabulary columns of
                   the loss; the partials summed in rank order) against
                   the whole layer and the whole loss, fp32 within the
                   stated tolerance, bf16 logged; and one full-width
                   Mamba2 layer of zamba2-2.7b and one mLSTM and one sLSTM
                   layer of xlstm-1.3b as 2, 4 and 16 virtual ranks
                   (threads running each rank's share function, their
                   collectives exchanged through a barrier) against the
                   whole layer, fp32 within the stated bar, bf16 logged.
                   Its seconds come out of the main path's share too;
  lm_dryrun      — the dry run (launch.dryrun, launch.dryrun_opt; meta
                   tensors in a fake world, in two subprocesses run beside
                   the card step; no kernel of the repo, the launch counts
                   must read 0): (a) the dry run of lm_train's cell on a
                   (1, 1) mesh against one mesh step of it on the card in an
                   NCCL world of 1 after a warm-up step: the FLOPs equal
                   FlopCounterMode's, the collective counts the card's and
                   the budget's (98 all-gathers, 304 all-reduces, 50
                   reduce-scatters), the predicted peak within the stated
                   tolerance of max_memory_allocated (the gap printed); (b)
                   dryrun_opt's train_4k cells of qwen1.5-0.5b and
                   deepseek-moe-16b on the single-pod (16, 16) mesh:
                   per-rank FLOPs, peak bytes and split (beside those of
                   whole-leaf gathering), fit, bottleneck and mfu_bound
                   printed, and for a "tp" cell its per-rank FLOPs and
                   useful_flops_ratio beside those of the step that
                   computed every block whole on every "model" rank. Its
                   seconds come out of the main path's share too;
  contracts      — the port's contract checker (tools/spjoin_lint_torch): its
                   AST layer over src/repro_torch must exit 0; then a mask
                   and a compact l1 join of 50,000 rows (default config)
                   under torch.cuda.set_sync_debug_mode("warn"), warnings
                   recorded (the mode reset in a finally): each path's
                   syncs per tile (tiles from VerifyStats, syncs from the
                   warnings raised on lines of the verify loop) held against
                   the loop's stream-tier budget, every line that synced
                   there one the checker counts; and the syncs of one
                   decode_step of lm_serve's qwen1.5-0.5b (measured in
                   lm_serve, after its run) held against the step tier's
                   budget. Its seconds come out of the main path's share;
  4. main path   — two l1 self-joins over a 1M x 128 clustered float32 set
                   (the shape of the SIFT1M base set): the default config
                   (emit="mask") and emit="compact", each with the launch
                   counts reset before and read after and a brute-force spot
                   check of 256 rows. A probe predicts both; if they do not
                   fit their share of the time limit, the mask join is halved
                   first, on a printed "reduced" line. The mask join's pairs
                   equal the compact join's (among its rows when halved)
                   byte for byte. Then the map-assign
                   kernel checked at the main path's shapes and timed
                   through its C entry point (both launches, against their
                   0.33 and 0.022 ms targets), its wrapper and the ops call,
                   a query batch's launch at 256 and 4,096 rows under the
                   launch plan and under 256-row CTAs, and a
                   50,000-row join of each emission mode under torch.profiler
                   (device busy share, time by kernel);
  serving        — build_index over the main path's rows, 8 timed query
                   batches of 4,096 fresh rows of the same mixture (route and
                   verify seconds, QPS, p50/p99), two checked against brute
                   force, save -> load -> query byte-identical, and one
                   insert_batch of 1 % of the rows with 256 delta rows
                   checked by brute force; then an index over 45,000
                   aol-like integer q-gram profiles at l1 delta = 4 (many
                   pairs at exactly delta), whose query batch and insert
                   must equal brute force byte for byte;
  distributed    — an NCCL process group of world size 1 on the card:
                   distributed_join over the compact join's rows with its
                   config (p = 16, prune pivot, placement lpt, emit
                   compact), pairs byte-identical to that join, stage
                   seconds, collective counts and telemetry printed, the
                   histogram, map-assign and verify-compact launches
                   counted; then DistIndex from the serving index: two
                   4,096-row query batches byte-identical to
                   MetricIndex.query_batch and one insert_batch (spot
                   checked by brute force). Four ranks need four cards: the
                   multi-rank path is held on the CPU by the gloo tests;
  5. exactness   — at N = 50,000 the join (l1, l2; prune pivot and none; one
                   R x S) equals a brute-force join done in row chunks with
                   the plain version on the card: byte for byte, or differing
                   only in pairs that straddle delta between the kernel's and
                   the plain fp32 distance (l2's expansion form), each within
                   the stated per-pair tolerance (``dist_tol``); emit="compact"
                   and prune="window" joins equal the default join byte for
                   byte (l1, l2, R x S), a forced-overflow compact join too,
                   and join_incremental over a 4-way split equals the join;
                   an l1 join with n_dims = 72 on the kernels equals the
                   plain join (backend="torch" on the card) byte for byte;
  6. comparison  — the paper's Fig. 9 on the card: SP-Join (generative +
                   learning), KPM (``baselines.kpm_config``) and the two
                   ball joins (``baselines.ball_join``, 16 and 32 pivots)
                   over the four datasets of benchmarks/common.py built
                   with the port's generators (netflix-, sift-, aol-like at
                   N = 250,000; pubmed-like, jaccard_minhash on the plain
                   path, cut to N = 100,000 on a printed "reduced" line), δ
                   for ~10 neighbours per row; the four pair sets byte for
                   byte equal and held against brute force, each arm's
                   launch counts set to 0 before it and read after (ball
                   joins: the plain pairdist kernel only; SP-Join and KPM:
                   map-assign and the filtered kernel; pubmed-like: none);
                   ``dedup`` over the aol-like profiles (pairs equal to the
                   SP-Join arm's, keep mask equal to the lowest index of
                   scipy's connected components); ``ops.pairdist_count``
                   over 4,096 rows against the sift-like set.
The line before the last is the per-kernel JSON report; the last line is
{"ok": true, "device": {...}}. Needs torch built for CUDA and one card.
A full run takes about 14-16 minutes on an H100 (build ~30 s, lm_serve ~3 min,
lm_train ~50 s, lm_mesh under a minute, lm_dryrun about a minute).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.core import baselines, distances, distributed, index, partition, spjoin, verify  # noqa: E402
from repro_torch.data import dedup as dedup_lib  # noqa: E402
from repro_torch.data import synthetic, vectorize  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import compact as _compact  # noqa: E402
from repro_torch.kernels import histogram as _histogram  # noqa: E402
from repro_torch.kernels import mapassign as _mapassign  # noqa: E402
from repro_torch.kernels import pairdist as _pairdist  # noqa: E402
from repro_torch.data import pipeline as lm_pipeline  # noqa: E402
from repro_torch.launch import mesh as lm_mesh_lib  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.models import base as lm_base  # noqa: E402
from repro_torch.models import collectives as lm_collectives  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import ssm as lm_ssm  # noqa: E402
from repro_torch.models import transformer as lm_transformer  # noqa: E402
from repro_torch.models import xlstm as lm_xlstm  # noqa: E402
from repro_torch.train import checkpoint as lm_ckpt  # noqa: E402
from repro_torch.train import optimizer as lm_opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from spjoin_lint_torch import astlint as lint_ast  # noqa: E402
from spjoin_lint_torch import budgets as lint_budgets  # noqa: E402
from spjoin_lint_torch import config as lint_config  # noqa: E402

EPS32 = float(torch.finfo(torch.float32).eps)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 peak outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
N_ROWS = 1_000_000  # the main path's rows before any "reduced" cut
MAIN_SHARE_S = 600.0  # the main-path joins' share of the time limit (the
#   mask and compact joins and the distributed join of the compact join's rows)
N_QUERY_BATCHES = 8  # timed query batches of the serving phase
QUERY_BATCH = 4096  # rows per query batch
N_SMALL_BATCHES = 100  # timed small batches, enough samples for a p99
SMALL_BATCH = 256  # rows per small batch (the JAX package's serve_qps.py batch)
SMALL_SHARE_S = 75.0  # time cap of the small-batch arm (0.8-1.1 s per batch on an H100, by host)
SERVING_ROWS = (N_QUERY_BATCHES + 1) * QUERY_BATCH + N_SMALL_BATCHES * SMALL_BATCH  # fresh query rows
INSERT_SHARE = 0.01  # the serving phase's insert: 1 % of the indexed rows
BRUTE_CHUNK = 2048  # spjoin.brute_force_pairs' default row chunk
T_START = time.perf_counter()


def log(*args) -> None:
    print(*args, flush=True)


def elapsed() -> float:
    return time.perf_counter() - T_START


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def entry_ms(lib_name: str, entry: str, *args, reps: int = 50) -> float:
    """Milliseconds per launch of a kernel's C entry point called back to
    back with its arguments marshalled once: the kernel's own time. (A
    wrapper's host work per call, checks and output allocation, can take as
    long as a 0.06 ms kernel on a busy host; wrapper_ms is timed apart.)"""
    fn = getattr(_build.lib(lib_name), entry)
    assert fn(*args) == 0, (entry, args)
    return cuda_ms(lambda: fn(*args), reps)


def filtered_args(x, y, px, py, out, delta: float, db: float, tile=None) -> tuple:
    """The pairdist_filtered_launch arguments of an l1 launch, as the
    wrapper passes them."""
    a, b = x.shape[0], y.shape[0]
    return (x.data_ptr(), y.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(), a, b,
            x.shape[1], px.shape[1], _build.METRIC_IDS["l1"], delta, db,
            _pairdist.launch_plan("pairdist_filtered", x, a, b, tile),
            _pairdist.stage_flags(x, y, px, py), _build.stream_ptr(x.device))


def plain_args(x, y, out, metric: str, delta: float) -> tuple:
    """The pairdist_launch arguments of a mask launch, as the wrapper
    passes them."""
    a, b = x.shape[0], y.shape[0]
    return (x.data_ptr(), y.data_ptr(), None, out.data_ptr(), a, b, x.shape[1],
            _build.METRIC_IDS[metric], 1, delta, _pairdist.launch_plan("pairdist", x, a, b),
            _pairdist.stage_flags(x, y), _build.stream_ptr(x.device))


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the fp32 peak."""
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOP_PER_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def pairdist64(x: torch.Tensor, y: torch.Tensor, metric: str) -> torch.Tensor:
    """float64 distances in the direct form (the borderline-band judge)."""
    x, y = x.double(), y.double()
    if metric == "cosine":
        x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
        y = y / y.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return 1.0 - x @ y.T
    if metric == "dot":
        return x @ y.T
    if metric == "l2":
        return ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] - 2 * x @ y.T).clamp_min(0).sqrt()
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float64, device=x.device)
    step = max(1, (1 << 25) // max(y.shape[0] * x.shape[1], 1))
    for i in range(0, x.shape[0], step):
        d = (x[i : i + step, None, :] - y[None]).abs()
        out[i : i + step] = d.sum(-1) if metric == "l1" else d.amax(-1)
    return out


def dist_tol(
    metric: str, m: int, nx: torch.Tensor, ny: torch.Tensor, d64: torch.Tensor,
    d_k: torch.Tensor, d_p: torch.Tensor,
) -> torch.Tensor:
    """Stated per-pair tolerance of |kernel − plain| for one distance: two
    fp32 evaluations of m-term sums in different orders, each within
    γ = (m+2)·eps of the exact sum's magnitude (any summation order), so
    g = 2·(m+2)·eps. ``nx``/``ny`` are the rows' float64 norms, ``d64`` the
    float64 distance, ``d_k``/``d_p`` the kernel's and the plain distance,
    all broadcast per pair.
      linf:   0 (the same roundings, a max is exact);
      l1:     g·D;
      cosine: g (pre-normalised rows);
      dot:    g·|x|·|y|;
      l2:     the expansion ‖x‖²+‖y‖²−2x·y is within E = g·(|x|+|y|)² in D²,
              so in D within E / max(D_k + D_p, √E).
    An fp32 kernel whose terms carried TF32 rounding (2¹² × eps) would break
    these at m = 128."""
    g = 2.0 * (m + 2) * EPS32
    if metric == "linf":
        return torch.zeros_like(d64)
    if metric == "l1":
        return g * d64.abs()
    if metric == "cosine":
        return torch.full_like(d64, g)
    if metric == "dot":
        return g * nx * ny + torch.zeros_like(d64)
    e = g * (nx + ny) ** 2 + torch.zeros_like(d64)
    return e / torch.maximum(d_k.double() + d_p.double(), e.sqrt())


def pair_tol(x: torch.Tensor, y: torch.Tensor, metric: str, d64, d_k, d_p) -> torch.Tensor:
    """:func:`dist_tol` for the (a, b) matrix of rows ``x`` against ``y``."""
    nx = x.double().norm(dim=1)[:, None]
    ny = y.double().norm(dim=1)[None, :]
    return dist_tol(metric, x.shape[1], nx, ny, d64, d_k, d_p)


def mask_mismatch(
    got: torch.Tensor, want: torch.Tensor, d_plain: torch.Tensor, delta: float,
    tol: torch.Tensor,
) -> int:
    """Mask disagreements outside the borderline band: only a pair whose
    plain fp32 distance is within its stated tolerance ``tol`` of δ can land
    on the other side of δ in the kernel."""
    band = (d_plain.double() - delta).abs() <= tol
    return int(((got != want) & ~band).sum())


def count_one_launch(name: str, fn):
    """Call ``fn`` and check that its wrapper added exactly one launch to
    the kernel's count."""
    before = ops.launch_counts()[name]
    out = fn()
    assert ops.launch_counts()[name] == before + 1, (name, before, ops.launch_counts())
    return out


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_environment() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    ops.strict_fp32()
    log("== phase 1: environment")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    return {"smi": smi, "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}


def ptxas_report() -> list[dict]:
    """Registers, spill bytes and static shared memory of every kernel
    compiled in this process, from nvcc's ``-Xptxas -v`` report (names
    demangled with c++filt where the toolkit's host has it)."""
    rows = []
    for src, text in _build.ptxas_log.items():
        for line in text.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                rows.append(dict(source=src, mangled=m[1], kernel=m[1]))
            elif rows and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
                rows[-1].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
            elif rows and (m := re.search(r"Used (\d+) registers", line)):
                rows[-1]["registers"] = int(m[1])
                if sm := re.search(r"(\d+) bytes smem", line):
                    rows[-1]["smem"] = int(sm[1])
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r["kernel"] = n.replace("repro_torch::", "").split("(")[0]
    return rows


# The instantiation each main path launches (l1; the 128 x 128 tile; self,
# pruned), by the name c++filt gives it, for the report line's registers.
MAIN_INSTANCE = {
    "pairdist": "pairdist_kernel<0, false, Tile<8, 8> >",
    "pairdist_filtered": "pairdist_kernel<0, true, Tile<8, 8> >",
    "map_assign": "map_assign_kernel<0, 8, 0>",
    "map_assign_member": "map_assign_stream_kernel<2, 2>",
    "verify_compact": "verify_compact_kernel<0, true, false, Tile<8, 8> >",
    "histogram": "histogram_reg_kernel<8, true>",
}


def ptxas_of(ptx: list[dict], name: str) -> dict:
    """Registers and spill bytes (stores + loads) of a kernel's main-path
    instantiation, from :func:`ptxas_report`."""
    for r in ptx:
        if r["kernel"].endswith(MAIN_INSTANCE[name]):
            return dict(registers=r.get("registers"),
                        spill_bytes=r.get("spill_stores", 0) + r.get("spill_loads", 0))
    return dict(registers=None, spill_bytes=None)


def phase_build() -> list[dict]:
    log("== phase 2: build")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.2f}s (per source {secs})")
    for name, text in _build.ptxas_log.items():
        for line in text.splitlines():
            if "error" in line.lower() or "warning" in line.lower():
                log(f"  nvcc[{name}] {line.strip()}")
    report = ptxas_report()
    for r in report:
        log(f"  ptxas {r['kernel']}: {r.get('registers')} registers, spill stores "
            f"{r.get('spill_stores')} loads {r.get('spill_loads')}, {r.get('smem')} bytes smem")
    log(f"ptxas: {len(report)} kernels, spill bytes in all "
        f"{sum(r.get('spill_stores', 0) + r.get('spill_loads', 0) for r in report)}")
    return report


def _mixture(n: int, m: int, seed: int) -> torch.Tensor:
    return torch.as_tensor(synthetic.mixture(n, m, n_clusters=64, seed=seed)).cuda()


def phase_kernels() -> dict:
    """Each kernel against its plain version on the card; returns the
    measurements of the report line (launches are filled in later)."""
    log("== phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}

    # --- pairdist, all metrics, ragged shapes and the engine's tile bucket.
    worst = 0.0
    for metric in ref.METRICS:
        for a, b, m in ((1000, 3001, 100), (77, 1030, 33), (1024, 4096, 128)):
            x = torch.randn((a, m), generator=gen, device="cuda") * 4 + 1
            y = torch.randn((b, m), generator=gen, device="cuda") * 4 + 1
            got = count_one_launch("pairdist", lambda: ops.pairdist(x, y, metric, backend="cuda"))
            want = ref.pairdist(x, y, metric)
            d64 = pairdist64(x, y, metric)
            tol = pair_tol(x, y, metric, d64, got, want)
            gap = (got.double() - want.double()).abs()
            err, over = float(gap.max()), int((gap > tol).sum())
            delta = float(d64.flatten()[:: max(1, d64.numel() // 4096)].median())
            mm = mask_mismatch(
                count_one_launch("pairdist", lambda: ops.pairdist_mask(x, y, delta, metric, backend="cuda")),
                ref.pairdist_mask(x, y, delta, metric), want, delta, tol,
            )
            log(f"pairdist {metric:6s} {a}x{b}x{m}: max_abs_err {err:.3e} "
                f"(max err/tol {float((gap / tol.clamp_min(1e-300)).max()):.3e}, pairs over tol {over}) "
                f"mask mismatches {mm}")
            assert over == 0, (metric, a, b, m, err, over)
            assert mm == 0, (metric, a, b, m, mm)
            if metric == "l1" and (a, b, m) == (1024, 4096, 128):
                worst = err
    a, b, m = 1024, 4096, 128
    z = _mixture(a + b, m, 1)
    x, y = z[:a], z[a:]
    delta = float(ref.pairdist(x[:64], y, "l1").flatten().kthvalue(64 * b // 100).values)
    # The kernel's time: its C entry point called back to back (ms); its
    # wrapper (ms_wrap) adds the checks and the output allocation, the ops
    # call (ms_ops, what earlier runs timed) the bool conversion too.
    out8 = torch.empty((a, b), dtype=torch.int8, device="cuda")
    ms = entry_ms("pairdist", "pairdist_launch", *plain_args(x, y, out8, "l1", delta))
    ms_wrap = cuda_ms(lambda: _pairdist.pairdist_cuda(x, y, "l1", delta), reps=20)
    ms_ops = cuda_ms(lambda: ops.pairdist_mask(x, y, delta, "l1", backend="cuda"))
    plain = cuda_ms(lambda: ref.pairdist_mask(x, y, delta, "l1"))
    lib = cuda_ms(lambda: torch.cdist(x, y, p=1.0) <= delta)
    bms, by = bound_ms(4 * (a + b) * m + a * b, 2.0 * a * b * m)
    report["pairdist"] = dict(
        name="pairdist", route="cuda", source="src/repro_torch/kernels/csrc/pairdist.cu",
        replaces="src/repro/kernels/pairdist.py:111", max_abs_err=worst, ms=ms,
        plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib, wrapper_ms=ms_wrap, ops_ms=ms_ops,
    )
    log(f"pairdist l1 {a}x{b}x{m} mask: kernel {ms:.4f} ms (wrapper {ms_wrap:.4f}, ops call {ms_ops:.4f}) plain {plain:.4f} ms "
        f"cdist {lib:.4f} ms bound {bms:.4f} ms ({by})")
    tile_chunk_cost(x, y, delta)

    # --- filtered: mapped coordinates of sorted clustered rows, so some
    # 64x64 blocks are pruned whole and some are not.
    worst = 0.0
    for metric in ops.PRUNABLE_METRICS:
        for a, b, m in ((1000, 3001, 100), (1024, 4096, 128)):
            z = _mixture(a + b, m, 3)
            x, y = z[:a], z[a:]
            anchors = y[:8]
            px = ref.pairdist(x, anchors, metric)
            py = ref.pairdist(y, anchors, metric)
            x, px = x[px[:, 0].argsort()], px[px[:, 0].argsort()]
            y, py = y[py[:, 0].argsort()], py[py[:, 0].argsort()]
            d64 = pairdist64(x, y, metric)
            delta = float(d64.flatten().kthvalue(max(1, d64.numel() // 1000)).values)
            db = ref.prune_delta(delta, metric, float(max(x.abs().max(), y.abs().max())), m)
            bound = ref.bound_mask(px, py, delta, db)
            tiles = torch.nn.functional.pad(bound, (0, (-b) % 64, 0, (-a) % 64))
            live = tiles.reshape(-(-a // 64), 64, -(-b // 64), 64).any(3).any(1)
            got = count_one_launch("pairdist_filtered", lambda: ops.pairdist_mask_filtered(
                x, y, px, py, delta, metric, delta_bound=db, backend="cuda"))
            want = ref.pairdist_mask_filtered(x, y, px, py, delta, metric, db)
            d_plain = ref.pairdist(x, y, metric)
            tol = pair_tol(x, y, metric, d64, ops.pairdist(x, y, metric, backend="cuda"), d_plain)
            mm = mask_mismatch(got, want, d_plain, delta, tol)
            # The output is an int8 mask: its max |kernel − plain| off the band.
            worst = max(worst, float(mm > 0))
            log(f"pairdist_filtered {metric:4s} {a}x{b}x{m}: blocks live {int(live.sum())} skipped {int((~live).sum())} mismatches {mm} hits {int(want.sum())}")
            assert mm == 0 and int(live.sum()) > 0 and int((~live).sum()) > 0
    a, b, m = 1024, 4096, 128
    z = _mixture(a + b, m, 5)
    x, y = z[:a], z[a:]
    anchors = y[:8]
    px, py = ref.pairdist(x, anchors, "l1"), ref.pairdist(y, anchors, "l1")
    delta = float(ref.pairdist(x[:64], y, "l1").flatten().kthvalue(64 * b // 100).values)
    db = ref.prune_delta(delta, "l1", float(max(x.abs().max(), y.abs().max())), m)
    bound = ref.bound_mask(px, py, delta, db)
    surv = int(bound.sum())
    log_live_shares("pairdist_filtered main tile (unsorted rows)", bound)
    out8 = torch.empty((a, b), dtype=torch.int8, device="cuda")
    ms = entry_ms("pairdist", "pairdist_filtered_launch", *filtered_args(x, y, px, py, out8, delta, db))
    ms64 = entry_ms("pairdist", "pairdist_filtered_launch", *filtered_args(x, y, px, py, out8, delta, db, 64))
    ms_wrap = cuda_ms(lambda: _pairdist.pairdist_filtered_cuda(x, y, px, py, "l1", delta, db), reps=20)
    ms_ops = cuda_ms(lambda: ops.pairdist_mask_filtered(x, y, px, py, delta, "l1", delta_bound=db, backend="cuda"))
    plain = cuda_ms(lambda: ref.pairdist_mask_filtered(x, y, px, py, delta, "l1", db))
    bms, by = bound_ms(4 * (a + b) * (m + 8) + a * b, 2.0 * a * b * 8 + 2.0 * surv * m)
    report["pairdist_filtered"] = dict(
        name="pairdist_filtered", route="cuda", source="src/repro_torch/kernels/csrc/pairdist.cu",
        replaces="src/repro/kernels/pairdist.py:214", max_abs_err=worst, ms=ms,
        plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None, wrapper_ms=ms_wrap, ops_ms=ms_ops,
        tile64_ms=ms64,
    )
    log(f"pairdist_filtered l1 {a}x{b}x{m} (surviving pairs {surv}): kernel {ms:.4f} ms (64x64 tile "
        f"{ms64:.4f}, wrapper {ms_wrap:.4f}, ops call {ms_ops:.4f}) plain {plain:.4f} ms bound {bms:.4f} ms ({by})")
    q, pq = x[:256].contiguous(), px[:256].contiguous()
    t128 = entry_ms("pairdist", "pairdist_filtered_launch", *filtered_args(q, y, pq, py, out8, delta, db, 128))
    t64 = entry_ms("pairdist", "pairdist_filtered_launch", *filtered_args(q, y, pq, py, out8, delta, db, 64))
    chosen = _pairdist.choose_tile(256, b, torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"pairdist_filtered l1 256x{b}x{m} (a query batch's tile): 128x128 tile {t128:.4f} ms, "
        f"64x64 tile {t64:.4f} ms; choose_tile takes {chosen}")

    # --- map-assign, both modes, p = 70 (three words, bit 31 in play).
    worst, any_top = 0.0, False
    for metric in ref.METRICS:
        n, m, na, p = 5003, 128, 8, 70
        x = _mixture(n, m, 7)
        anchors = x[torch.randperm(n, generator=gen, device="cuda")[:na]]
        piv = ref.pairdist(x[:2000], anchors, metric).cpu().numpy()
        plan = partition.build_partition(piv, p, 0.05, strategy="iterative", device="cuda")
        boxes = (plan.kernel_lo, plan.kernel_hi, plan.whole_lo, plan.whole_hi)
        xm, cells, bits = count_one_launch(
            "map_assign", lambda: ops.map_assign(x, anchors, *boxes, metric, backend="cuda"))
        xm_p, cells_p, bits_p = ops.map_assign(x, anchors, *boxes, metric, backend="torch")
        err, over, cm, bm, near = check_map_assign(
            x, anchors, boxes, metric, (xm, cells, bits), (xm_p, cells_p, bits_p))
        exact = True
        for want in ops.WANTS:  # assign-only, each output selection
            c2, b2 = count_one_launch(
                "map_assign", lambda: ops.assign_membership(xm_p, *boxes, backend="cuda", want=want))
            c3, b3 = ops.assign_membership(xm_p, *boxes, backend="torch", want=want)
            exact &= bool(torch.equal(c2, c3) and torch.equal(b2, b3))
        top = bool((bits_p < 0).any())
        log(f"map_assign {metric:6s} n={n} p={p}: xm max_abs_err {err:.3e} (coords over tol {over}) "
            f"cell/bit mismatches off-edge {cm}/{bm} (near-edge rows {near}); "
            f"assign-only exact for want {ops.WANTS}: {exact} (bit 31 set {top})")
        assert over == 0 and cm == 0 and bm == 0 and exact
        any_top |= top
        if metric == "l1":
            worst = err
    assert any_top, "no membership word had bit 31 set"
    report["map_assign"] = dict(
        name="map_assign", route="cuda", source="src/repro_torch/kernels/csrc/mapassign.cu",
        replaces="src/repro/kernels/mapassign.py:133", max_abs_err=worst, library_ms=None,
    )
    check_map_assign_shapes()
    check_verify_compact(report)
    check_tile_paths()
    check_histogram(report)
    return report


def block_live(bound: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Which (rows x cols) blocks of an (a, b) bound mask hold a survivor."""
    a, b = bound.shape
    t = torch.nn.functional.pad(bound, (0, (-b) % cols, 0, (-a) % rows))
    return t.reshape(-(-a // rows), rows, -(-b // cols), cols).any(3).any(1)


def mixed_ctas(bound: torch.Tensor, tile: int) -> int:
    """Live CTAs of the tile x tile kernel tile holding a dead warp
    sub-tile ((tile / 4) x 32 pairs): where the sub-tile vote skips work."""
    sub, cta = block_live(bound, tile // 4, 32), block_live(bound, tile, tile)
    per = tile // 32
    subs = torch.nn.functional.pad(sub, (0, (-sub.shape[1]) % per, 0, (-sub.shape[0]) % 4))
    full = subs.reshape(cta.shape[0], 4, cta.shape[1], per).all(3).all(1)
    return int((cta & ~full).sum())


def log_live_shares(label: str, bound: torch.Tensor) -> dict:
    """The share of a tile's work that each skip granularity leaves live:
    pairs (the bound survivors), 32x32 warp sub-tiles, 64x64 and 128x128
    CTAs; and the live 128x128 CTAs that hold a dead sub-tile."""
    sub, c64, c128 = block_live(bound, 32, 32), block_live(bound, 64, 64), block_live(bound, 128, 128)
    shares = dict(pairs=float(bound.float().mean()), sub32=float(sub.float().mean()),
                  cta64=float(c64.float().mean()), cta128=float(c128.float().mean()),
                  mixed_cta128=mixed_ctas(bound, 128), live_cta128=int(c128.sum()))
    log(f"live shares at the {label}: pairs {shares['pairs']:.4f}, 32x32 sub-tiles {shares['sub32']:.4f}, "
        f"64x64 CTAs {shares['cta64']:.4f}, 128x128 CTAs {shares['cta128']:.4f}; live 128x128 CTAs "
        f"with a dead sub-tile {shares['mixed_cta128']} of {shares['live_cta128']}")
    return shares


def tile_chunk_cost(x: torch.Tensor, y: torch.Tensor, delta: float) -> None:
    """What one 16-feature chunk of the 128x128 tile costs the card at the
    main tile: the plain pairdist mask kernel over m and 2m features, for
    l1 (two fp32 instructions per pair-feature) and dot (one FMA). The
    slope per chunk is set beside the time the chunk's fp32 instructions
    take at the card's peak issue rate (67 TFLOP/s counts an FMA as two)."""
    a, b, m = x.shape[0], y.shape[0], x.shape[1]
    x2, y2 = torch.cat([x, x], 1), torch.cat([y, y], 1)
    out = torch.empty((a, b), dtype=torch.int8, device="cuda")
    for metric, per_pf in (("l1", 2), ("dot", 1)):
        t1 = entry_ms("pairdist", "pairdist_launch", *plain_args(x, y, out, metric, delta))
        t2 = entry_ms("pairdist", "pairdist_launch", *plain_args(x2, y2, out, metric, delta))
        chunk_us = 1e3 * (t2 - t1) / (m / 16)
        issue_us = 1e6 * a * b * 16 * per_pf / (FP32_FLOP_PER_S / 2)
        log(f"chunk cost {metric}: {a}x{b} m={m} {t1:.4f} ms, m={2 * m} {t2:.4f} ms: {chunk_us:.3f} us per "
            f"16-feature chunk against {issue_us:.3f} us of fp32 issue at peak ({issue_us / chunk_us:.3f})")


def _placed(rows: torch.Tensor, offset: str) -> torch.Tensor:
    """``rows`` as a contiguous tensor whose base is: fresh ("none"), one
    row into a larger buffer ("row"), or one float into one ("float")."""
    n, w = rows.shape
    if offset == "none":
        return rows.clone()
    if offset == "row":
        buf = torch.zeros((n + 1, w), device=rows.device)
        buf[1:] = rows
        return buf[1:]
    buf = torch.zeros((n * w + 1,), device=rows.device)
    buf[1:] = rows.flatten()
    return buf[1:].view(n, w)


def check_tile_paths() -> None:
    """The filtered and verify-compact kernels against their plain versions
    on the tile's other paths (l1): bp in {1, 3, 8, 17} pivot dimensions
    (one staged slice or two; widths that are and are not multiples of 4);
    m in {33, 100, 128} on rows one row into a buffer (33: 4-byte copies;
    100, 128: still 16-byte aligned) or one float into one (4-byte copies
    at any width); tiles smaller than either CTA tile; a 1024 x 2176 tile
    (the 128 x 128 tile on 4-byte copies); and the main tile. Rows are
    sorted by a mapped coordinate, so some warps' sub-tiles are dead and
    others live.
    On every tile: the filtered mask off the delta band equals the plain
    one; the compact kernel (self and R x S) has no pair off the band
    against its plain version, its pairs equal the filtered kernel's mask
    ANDed with validity and the min-cell rule exactly (one core), and its
    candidate count equals the plain bound mask's valid pairs exactly."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases = ((300, 700, 33, "row"), (300, 700, 100, "row"), (300, 700, 128, "row"),
             (300, 700, 100, "float"), (300, 700, 128, "float"), (50, 40, 128, "none"),
             (100, 90, 33, "row"), (1, 1, 128, "none"), (1024, 2176, 33, "row"),
             (1024, 4096, 128, "none"))
    paths, worst_band, n_mixed = set(), 0, 0
    for bp in (1, 3, 8, 17):
        anchors = _mixture(bp, 128, 60 + bp)
        for a, b, m, offset in cases:
            z = _mixture(a + b, m, 40 + bp)
            pz = ref.pairdist(z, anchors[:, :m].contiguous(), "l1")
            order = pz[:, 0].argsort()  # sorted rows: dead and live blocks
            z, pz = z[order], pz[order]
            sel = torch.randperm(a + b, generator=torch.Generator(device="cuda").manual_seed(bp), device="cuda")
            xi, yi = sel[:a].sort().values, sel[a:].sort().values
            x, y = _placed(z[xi], offset), _placed(z[yi], offset)
            px, py = _placed(pz[xi], offset), _placed(pz[yi], offset)
            d64 = pairdist64(x, y, "l1")
            delta = float(d64.flatten().kthvalue(max(1, d64.numel() // 1000)).values)
            db = ref.prune_delta(delta, "l1", float(max(x.abs().max(), y.abs().max())), m)
            flags = _pairdist.stage_flags(x, y, px, py)
            tile = _pairdist.choose_tile(a, b, n_sm)
            paths.add((bool(flags & _pairdist.VEC_ROWS), bool(flags & _pairdist.VEC_PIVOTS), tile))
            mask = count_one_launch("pairdist_filtered", lambda: ops.pairdist_mask_filtered(
                x, y, px, py, delta, "l1", delta_bound=db, backend="cuda"))
            d_plain = ref.pairdist(x, y, "l1")
            tol = pair_tol(x, y, "l1", d64, ops.pairdist(x, y, "l1", backend="cuda"), d_plain)
            mm = mask_mismatch(mask, ref.pairdist_mask_filtered(x, y, px, py, delta, "l1", db), d_plain, delta, tol)
            bound = ref.bound_mask(px, py, delta, db)
            vids = torch.arange(a, dtype=torch.int32, device="cuda")
            wids = torch.arange(b, dtype=torch.int32, device="cuda")
            vids[a - a // 10 :] = -1  # the last tenth of each side is padding
            wids[b - b // 10 :] = -1
            wcells = (torch.arange(b, device="cuda", dtype=torch.int32) * 7) % 5
            line = []
            for cross in (False, True):
                kw = dict(delta=delta, metric="l1", cross=cross, delta_bound=db, capacity=a * b)
                gp, gc, gn = count_one_launch("verify_compact", lambda: ops.verify_compact(
                    x, y, vids, wids, wcells, 2, px, py, backend="cuda", **kw))
                wp, _, wn = ops.verify_compact(x, y, vids, wids, wcells, 2, px, py, backend="torch", **kw)
                k_keys = _pair_keys(gp)
                _, band, off = keys_off_band(k_keys, _pair_keys(wp), x, y, "l1", delta, d64)
                vi, wi = torch.nonzero(mask, as_tuple=True)
                vh, wh = vids[vi].long(), wids[wi].long()
                keep = ref.emit_keep(vh, wh, None if cross else wcells[wi].long(), 2, cross)
                same = torch.equal(k_keys, (vh[keep] * (1 << 32) + wh[keep]).sort().values)
                valid = (vids[:, None] >= 0) & (wids[None, :] >= 0)
                n_cand = int((bound & valid).sum())
                assert off == 0 and same and int(gc) == k_keys.numel() and int(gn) == n_cand == int(wn), (
                    bp, a, b, m, offset, cross, off, same, int(gc), k_keys.numel(), int(gn), n_cand, int(wn))
                worst_band = max(worst_band, band)
                line.append(f"{'RxS' if cross else 'self'} {int(gc)} pairs (band {band})")
            cta = block_live(bound, tile, tile)
            mixed = mixed_ctas(bound, tile)
            n_mixed += mixed
            log(f"tile paths l1 bp={bp} {a}x{b}x{m} {offset}: tile {tile}, 16-byte rows {bool(flags & 1)}, "
                f"16-byte pivots {bool(flags & 2)}; filtered mismatches {mm}; compact == mask & validity "
                f"& rule: {', '.join(line)}; CTAs live {int(cta.sum())} of {cta.numel()}, "
                f"live with a dead warp sub-tile {mixed}")
            assert mm == 0, (bp, a, b, m, offset, mm)
    log(f"tile paths exercised (16-byte rows, 16-byte pivots, tile): {sorted(paths)}; most delta-band "
        f"pairs {worst_band}; live CTAs with a dead warp sub-tile {n_mixed}")
    assert n_mixed > 0, "no tile had both dead and live warp sub-tiles in one CTA"
    for want in ((True, True, 128), (False, False, 128), (True, False, 64), (False, False, 64)):
        assert want in paths, (want, paths)


HIST_CELLS = (1, 8, 383, 384, 1024, 5000, 20_000)  # t of the histogram sweep


def histogram_args(u, w, out, t: int, plan=None) -> tuple:
    """The histogram_launch arguments, as the wrapper passes them."""
    n, m = u.shape
    if plan is None:
        plan = _histogram.launch_plan(n, m, t, torch.cuda.get_device_properties(0).multi_processor_count)
    vec = int(m % 4 == 0 and u.data_ptr() % 16 == 0)
    return (u.data_ptr(), w.data_ptr(), out.data_ptr(), n, m, t, plan.mode, plan.tmax, plan.qb,
            plan.copies, plan.grid_x, plan.grid_y, vec, _build.stream_ptr(u.device))


def check_histogram(report: dict) -> None:
    """The histogram kernel against its plain version: ragged shapes, every
    edge value of the cell rule, weights with zeros, rows one float into a
    buffer (scalar loads), every t of HIST_CELLS (registers, per-warp and
    single shared histograms, global atomics), and the stats stage's shape
    (1,000,000 x 128, t = 8) — counts are integers in float32, so equality
    is exact (torch.equal). One launch per call. Then the stats stage's
    shape timed through the C entry point, the wrapper and the ops call."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    edges = torch.tensor([0.0, 1.0 - 2.0**-24, 1.0, -0.5, 7.0, 1e30, float("nan"),
                          float("inf"), -float("inf")], device="cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    cases = [(1000, 33, 8, "none"), (1000, 33, 16, "none"), (77, 5, 4, "none"), (4099, 130, 16, "none"),
             (3001, 128, 8, "float")]
    cases += [(4099 + t % 7, 33 if t % 2 else 130, t, "none") for t in HIST_CELLS]
    cases += [(2000, 128, 1024, "float"), (1_000_000, 128, 8, "none")]
    modes = set()
    for n, m, t, offset in cases:
        u = torch.rand((n, m), generator=gen, device="cuda") * 1.1 - 0.05
        u[: edges.numel()] = edges[:, None]  # every edge value in every column
        u = _placed(u, offset)
        w = (torch.rand((n,), generator=gen, device="cuda") > 0.25).float()
        plan = _histogram.launch_plan(n, m, t, n_sm)
        modes.add(plan.mode)
        assert plan.smem == _build.lib("histogram").histogram_smem_bytes(  # the host's mirror
            t, plan.qb, plan.mode, plan.tmax, plan.copies), plan
        got = count_one_launch("histogram", lambda: ops.histogram(u, t, w, backend="cuda"))
        want = ref.histogram(u, t, w)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"histogram {n}x{m} t={t} {offset}: {plan} exact {bool(torch.equal(got, want))} "
            f"(max_abs_err {err}), weight sum {float(w.sum()):.0f} x {m} = total {float(got.sum()):.0f}")
        assert torch.equal(got, want), (n, m, t, offset)
    assert modes == {_histogram.REGISTERS, _histogram.SHARED, _histogram.GLOBAL}, modes
    n, m, t = u.shape[0], u.shape[1], 8
    out = torch.zeros((m, t), device="cuda")
    ms = entry_ms("histogram", "histogram_launch", *histogram_args(u, w, out, t))
    ms_wrap = cuda_ms(lambda: _histogram.histogram_cuda(u, w, t), reps=20)
    ms_ops = cuda_ms(lambda: ops.histogram(u, t, w, backend="cuda"))
    plain = cuda_ms(lambda: ref.histogram(u, t, w), reps=3)
    # Library yardstick: one torch.bincount with weights over the flat
    # dim·t + cell index, precomputed outside the timing (the time is the
    # bincount call alone: it reads the index and the expanded weights).
    flat = (torch.arange(m, device="cuda")[None, :] * t + ref.histogram_cells(u, t)).reshape(-1)
    wf = w[:, None].expand(-1, m).reshape(-1).contiguous()
    lib = cuda_ms(lambda: torch.bincount(flat, weights=wf, minlength=m * t))
    assert torch.equal(torch.bincount(flat, weights=wf, minlength=m * t).float().reshape(m, t),
                       ref.histogram(u, t, w))
    del flat, wf
    bms, by = bound_ms(4 * n * m + 4 * n + 4 * m * t, 3.0 * n * m)
    occ = _build.lib("histogram").histogram_occupancy(8)
    report["histogram"] = dict(
        name="histogram", route="cuda", source="src/repro_torch/kernels/csrc/histogram.cu",
        replaces="src/repro/kernels/histogram.py:42", max_abs_err=worst, ms=ms,
        plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib, wrapper_ms=ms_wrap, ops_ms=ms_ops,
        ctas_per_sm=occ,
    )
    log(f"histogram {n}x{m} t={t} ({_histogram.launch_plan(n, m, t, n_sm)}, {occ} CTAs per SM): "
        f"kernel {ms:.4f} ms (wrapper {ms_wrap:.4f}, ops call {ms_ops:.4f}) plain {plain:.4f} ms "
        f"bincount {lib:.4f} ms bound {bms:.4f} ms ({by}); target <= 0.25 ms: {'met' if ms <= 0.25 else 'MISSED'}")


def _pair_keys(pairs: torch.Tensor) -> torch.Tensor:
    """Sorted int64 keys v * 2**32 + w of a pair buffer's filled slots."""
    p = pairs[pairs[:, 0] >= 0].long()
    return (p[:, 0] * (1 << 32) + p[:, 1]).sort().values


def keys_off_band(k_keys, p_keys, x, y, metric: str, delta: float, d64) -> tuple:
    """The pair keys found by only one of kernel and plain version, and how
    many of them lie in the delta band (plain distance within its stated
    tolerance of delta, ``dist_tol``) and off it. Returns (diff, band, off)."""
    uniq, cnt = torch.unique(torch.cat([k_keys, p_keys]), return_counts=True)
    diff = uniq[cnt == 1]
    band = off = 0
    if diff.numel():
        i, j = diff >> 32, diff & 0xFFFFFFFF
        d_plain = ref.pairdist(x, y, metric)[i, j]
        d_k = ops.pairdist(x, y, metric, backend="cuda")[i, j]
        nx, ny = x[i].double().norm(dim=1), y[j].double().norm(dim=1)
        tol = dist_tol(metric, x.shape[1], nx, ny, d64[i, j], d_k, d_plain)
        off = int(((d_plain.double() - delta).abs() > tol).sum())
        band = int(diff.numel()) - off
    return diff, band, off


def compact_tile(x, y, metric: str, coords: bool):
    """Ids and pivot coordinates of a verify-compact test tile: V ids 0..a-1
    and W ids 0..b-1 (so an id is its row), the last rows padding (-1), W
    kernel cells around the verified cell 2, rows sorted by their first
    mapped coordinate so some 64x64 blocks are pruned whole."""
    a, b = x.shape[0], y.shape[0]
    vids = torch.arange(a, dtype=torch.int32, device="cuda")
    wids = torch.arange(b, dtype=torch.int32, device="cuda")
    vids[-3:] = -1
    wids[-2:] = -1
    wcells = (torch.arange(b, device="cuda", dtype=torch.int32) * 7) % 5
    px = py = None
    if coords:
        anchors = y[:8]
        px, py = ref.pairdist(x, anchors, metric), ref.pairdist(y, anchors, metric)
    return vids, wids, wcells, px, py


def check_verify_compact_tile(x, y, metric: str, cross: bool, coords: bool) -> tuple[int, int, int, int]:
    """The verify-compact kernel against its plain version on one tile:
    the candidate count exact; the pair sets equal except pairs whose plain
    distance is within its stated tolerance of delta (``dist_tol``), and the
    kernel's count exactly its filled slots; then a forced overflow
    (capacity a third of the count) keeps the exact count and fills every
    slot with kernel pairs. Returns (count, n_cand, band pairs, pairs that
    differ off the band), the last asserted 0."""
    a, b, m = x.shape[0], y.shape[0], x.shape[1]
    vids, wids, wcells, px, py = compact_tile(x, y, metric, coords)
    d64 = pairdist64(x, y, metric)
    delta = float(d64.flatten().kthvalue(max(1, d64.numel() // 1000)).values)
    db = ref.prune_delta(delta, metric, float(max(x.abs().max(), y.abs().max())), m) if coords else None
    kw = dict(delta=delta, metric=metric, cross=cross, delta_bound=db)

    def run(backend, capacity):
        return ops.verify_compact(x, y, vids, wids, wcells, 2, px, py, capacity=capacity,
                                  backend=backend, **kw)

    gp, gc, gn = count_one_launch("verify_compact", lambda: run("cuda", a * b))
    wp, wc, wn = run("torch", a * b)
    gc, gn, wc, wn = int(gc), int(gn), int(wc), int(wn)
    assert gn == wn, (metric, cross, coords, gn, wn)
    assert bool((gp[:gc] >= 0).all()) and bool((gp[gc:] == -1).all()), "count != filled slots"
    k_keys, p_keys = _pair_keys(gp), _pair_keys(wp)
    diff, band, off = keys_off_band(k_keys, p_keys, x, y, metric, delta, d64)
    assert off == 0, f"{off} compact pairs differ off the delta band"
    assert gc - wc == int(torch.isin(diff, k_keys).sum()) - int(torch.isin(diff, p_keys).sum())
    cap = max(gc // 3, 1)
    op, oc, _ = count_one_launch("verify_compact", lambda: run("cuda", cap))
    assert int(oc) == gc and bool(torch.isin(_pair_keys(op), k_keys).all()) and int((op[:, 0] >= 0).sum()) == cap
    return gc, gn, band, off


def check_verify_compact(report: dict) -> None:
    worst_band = worst_off = 0
    for metric in ref.METRICS:
        for a, b, m in ((1000, 3001, 100), (77, 1030, 33)):
            z = _mixture(a + b, m, 17)
            x, y = z[:a], z[a:]
            for cross in (False, True):
                for coords in (False, True) if metric in ops.PRUNABLE_METRICS else (False,):
                    count, n_cand, band, off = check_verify_compact_tile(x, y, metric, cross, coords)
                    worst_band, worst_off = max(worst_band, band), max(worst_off, off)
                    log(f"verify_compact {metric:6s} {a}x{b}x{m} cross={cross} coords={coords}: "
                        f"count {count} n_cand {n_cand} delta-band pairs {band}; overflow exact")
    # The main path's tile: l1, 1024 x 4096 x 128, 8 mapped dims, sorted
    # clustered rows (some blocks pruned whole).
    a, b, m = 1024, 4096, 128
    z = _mixture(a + b, m, 5)
    x, y = z[:a], z[a:]
    anchors = y[:8]
    order_x = ref.pairdist(x, anchors, "l1")[:, 0].argsort()
    order_y = ref.pairdist(y, anchors, "l1")[:, 0].argsort()
    x, y = x[order_x].contiguous(), y[order_y].contiguous()
    for cross in (False, True):
        count, n_cand, band, off = check_verify_compact_tile(x, y, "l1", cross, True)
        worst_band, worst_off = max(worst_band, band), max(worst_off, off)
        log(f"verify_compact l1 {a}x{b}x{m} (main tile) cross={cross} coords=True: count {count} "
            f"n_cand {n_cand} of {a * b} delta-band pairs {band}; overflow exact")
        assert n_cand < a * b
    vids, wids, wcells, px, py = compact_tile(x, y, "l1", True)
    delta = float(ref.pairdist(x[:64], y, "l1").flatten().kthvalue(64 * b // 100).values)
    db = ref.prune_delta(delta, "l1", float(max(x.abs().max(), y.abs().max())), m)
    _, count, n_cand = ops.verify_compact(x, y, vids, wids, wcells, 2, px, py, capacity=a * b,
                                          delta=delta, metric="l1", delta_bound=db, backend="cuda")
    count, n_cand = int(count), int(n_cand)
    cap = verify.bucket_size(2 * count + verify._EMIT_FLOOR, a * b)
    kw = dict(capacity=cap, delta=delta, metric="l1", delta_bound=db)
    log_live_shares("verify_compact main tile (sorted rows)", ref.bound_mask(px, py, delta, db))

    # The kernel's own time through its C entry point (the counter keeps
    # growing over the repeats, so after the first launch no pair is
    # written: 26,099 pairs of 8 bytes, next to 10 MB of rows read).
    pairs = torch.full((cap, 2), -1, dtype=torch.int32, device="cuda")
    counters = torch.zeros((2,), dtype=torch.int32, device="cuda")

    def entry(tile=None):
        return (x.data_ptr(), y.data_ptr(), px.data_ptr(), py.data_ptr(), vids.data_ptr(),
                wids.data_ptr(), wcells.data_ptr(), 2, a, b, m, px.shape[1], _build.METRIC_IDS["l1"],
                1, 0, delta, db, cap, _pairdist.launch_plan("verify_compact", x, a, b, tile),
                _pairdist.stage_flags(x, y, px, py), pairs.data_ptr(), counters.data_ptr(),
                _build.stream_ptr(x.device))

    ms = entry_ms("compact", "verify_compact_launch", *entry())
    ms64 = entry_ms("compact", "verify_compact_launch", *entry(64))
    ms_wrap = cuda_ms(lambda: _compact.verify_compact_cuda(
        x, y, vids, wids, wcells, 2, px, py, metric="l1", delta=delta, delta_bound=db, capacity=cap,
        cross=False), reps=20)
    ms_ops = cuda_ms(lambda: ops.verify_compact(x, y, vids, wids, wcells, 2, px, py, backend="cuda", **kw))
    plain = cuda_ms(lambda: ops.verify_compact(x, y, vids, wids, wcells, 2, px, py, backend="torch", **kw))
    # Bytes: rows and pivot coordinates, ids and cells read once, the pair
    # buffer and the counters written once. Operations: the bound pass over
    # every pair and the exact distance of the bound survivors.
    n_bytes = 4 * (a + b) * (m + 8) + 4 * (a + 2 * b) + 8 * cap + 8
    bms, by = bound_ms(n_bytes, 2.0 * a * b * 8 + 2.0 * n_cand * m)
    report["verify_compact"] = dict(
        name="verify_compact", route="cuda", source="src/repro_torch/kernels/csrc/compact.cu",
        # The output is a pair buffer: its error is the most pairs of one
        # tile that differ off the delta band (asserted 0; band pairs are
        # allowed and counted in delta_band_pairs).
        replaces="src/repro/kernels/compact.py:179", max_abs_err=float(worst_off), ms=ms,
        plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None, delta_band_pairs=worst_band,
        wrapper_ms=ms_wrap, ops_ms=ms_ops, tile64_ms=ms64,
    )
    log(f"verify_compact: most pairs of one tile off the delta band {worst_off}, in the band {worst_band}")
    log(f"verify_compact l1 {a}x{b}x{m} self (count {count}, bound survivors {n_cand}, capacity {cap}): "
        f"kernel {ms:.4f} ms (64x64 tile {ms64:.4f}, wrapper {ms_wrap:.4f}, ops call {ms_ops:.4f}) plain {plain:.4f} ms "
        f"bound {bms:.4f} ms ({by})")


def check_map_assign(x, anchors, boxes, metric, got, want) -> tuple[float, int, int, int, int]:
    """The metric mode of map-assign against its plain version: coordinates
    within :func:`dist_tol`, cells and membership words equal on every row
    whose plain coordinates are farther than their tolerance from every box
    edge (a row nearer may land on either side). Returns (max |xm error|,
    coordinates over tolerance, cell and bit mismatches off the edges,
    near-edge rows)."""
    xm, cells, bits = got
    xm_p, cells_p, bits_p = want
    tol = pair_tol(x, anchors, metric, pairdist64(x, anchors, metric), xm, xm_p)
    gap = (xm.double() - xm_p.double()).abs()
    near = near_edges(xm_p, tol, boxes)
    cm = int(((cells != cells_p) & ~near).sum())
    bm = int(((bits != bits_p).any(1) & ~near).sum())
    return float(gap.max()), int((gap > tol).sum()), cm, bm, int(near.sum())


def near_edges(xm_p: torch.Tensor, tol: torch.Tensor, boxes) -> torch.Tensor:
    """Rows whose plain coordinates lie within their tolerance of any box
    edge, in row chunks of at most 2^24 (row, box, dim) terms."""
    n, nd = xm_p.shape
    step = max(1, (1 << 24) // (boxes[0].shape[0] * nd))
    near = torch.zeros(n, dtype=torch.bool, device=xm_p.device)
    for i in range(0, n, step):
        xs, ts = xm_p[i : i + step, None, :].double(), tol[i : i + step, None, :]
        for edge in boxes:
            near[i : i + step] |= ((xs - edge[None].double()).abs() <= ts).any(-1).any(-1)
    return near


MAP_DIMS = (8, 16, 64, 72, 130)  # n_dims of the shape sweep: one and several dim blocks
MAP_PARTS = (16, 100, 1024)  # partitions of the shape sweep


def open_boxes(xm: torch.Tensor, p: int, gen: torch.Generator) -> tuple:
    """p kernel boxes over mapped rows ``xm`` (n, n_dims): each bounds 3
    random dimensions by order-statistic intervals and leaves the others
    open (±1e30), so every dimension block decides some boxes and a row
    falls in a few; the whole boxes are the kernel boxes grown by 1 % of
    the widest spread."""
    n, nd = xm.shape
    srt = xm.sort(0).values
    lo = torch.full((p, nd), -1e30, device="cuda")
    hi = torch.full((p, nd), 1e30, device="cuda")
    dims = torch.rand((p, nd), generator=gen, device="cuda").argsort(1)[:, :3]
    q = torch.rand((p, 2), generator=gen, device="cuda").sort(1).values
    i_lo = (q[:, :1] * 0.5 * (n - 1)).long().expand(-1, 3)
    i_hi = ((0.5 + 0.5 * q[:, 1:]) * (n - 1)).long().expand(-1, 3)
    rows = torch.arange(p, device="cuda")[:, None].expand(-1, 3)
    lo[rows, dims] = srt[i_lo, dims]
    hi[rows, dims] = srt[i_hi, dims]
    grow = 0.01 * float((srt[-1] - srt[0]).max())
    return lo, hi, lo - grow, hi + grow


def forced_plans(n: int, nap: int, pp: int, p: int, metric_mode: bool) -> list:
    """Every plan the map-assign kernel can be launched with at these
    shapes: each rows-per-CTA choice, with the card's shared memory and
    with a 48 KB budget (more word and dim blocks), where one fits."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = _mapassign.ROWS if metric_mode else _mapassign.ASSIGN_ROWS
    plans = []
    for r in rows:
        for budget in (_mapassign.SMEM_OPTIN, 48 * 1024):
            try:
                plan = _mapassign.launch_plan(n, nap, pp, p, metric_mode, n_sm, budget, rows=r)
            except ValueError:  # no block fits this budget at this CTA size
                continue
            if plan not in plans:
                plans.append(plan)
    return plans


def check_map_assign_shapes() -> None:
    """The map-assign kernel against its plain version over one and
    several dim and word blocks: n_dims in MAP_DIMS x p in MAP_PARTS x every metric x
    every want, on ragged rows (m = 100, 16-byte copies, or 33, 4-byte
    copies): coordinates within ``dist_tol``, cells and bits equal off box
    edges, the assign-only mode exact on the plain coordinates. Then every
    plan (``forced_plans``: rows per CTA, word and dim blocks) gives the
    default plan's outputs bit for bit, in both modes."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    t0 = time.perf_counter()
    n_checks = n_plans = 0
    worst = 0.0
    for nd in MAP_DIMS:
        for p in MAP_PARTS:
            n = 997 + 13 * nd + p
            m = 33 if (nd + p) % 3 == 0 else 100
            x = _mixture(n, m, 30 + nd)
            anchors = x[torch.randperm(n, generator=gen, device="cuda")[:nd]]
            edge_rows = 0
            for metric in ref.METRICS:
                boxes = open_boxes(ref.pairdist(x, anchors, metric), p, gen)
                tol = near = None
                for want in ops.WANTS:
                    got = count_one_launch("map_assign", lambda: ops.map_assign(
                        x, anchors, *boxes, metric, backend="cuda", want=want))
                    plain = ops.map_assign(x, anchors, *boxes, metric, backend="torch", want=want)
                    if near is None:
                        tol = pair_tol(x, anchors, metric, pairdist64(x, anchors, metric), got[0], plain[0])
                        near = near_edges(plain[0], tol, boxes)
                    gap = (got[0].double() - plain[0].double()).abs()
                    over = int((gap > tol).sum())
                    cm = int(((got[1] != plain[1]) & ~near).sum())
                    bm = int(((got[2] != plain[2]).any(1) & ~near).sum())
                    c_k, b_k = count_one_launch("map_assign", lambda: ops.assign_membership(
                        plain[0], *boxes, backend="cuda", want=want))
                    c_p, b_p = ops.assign_membership(plain[0], *boxes, backend="torch", want=want)
                    exact = bool(torch.equal(c_k, c_p) and torch.equal(b_k, b_p))
                    assert over == 0 and cm == 0 and bm == 0 and exact, (nd, p, metric, want, over, cm, bm, exact)
                    n_checks += 1
                    if metric == "l1":
                        worst = max(worst, float(gap.max()))
                edge_rows = max(edge_rows, int(near.sum()))
            # Every plan gives the default plan's bits (l1, both outputs).
            xp, ap = ops._prep(x, anchors, "l1")
            pb = ops._prep_boxes(*open_boxes(ref.pairdist(x, anchors, "l1"), p, gen))
            nap, pp = pb[0].shape[1], pb[0].shape[0]
            base = _mapassign.map_assign_cuda(xp, ap, *pb, "l1", nd, True, True, p=p)
            base_a = _mapassign.map_assign_cuda(base[0], None, *pb, None, nd, True, True, p=p)
            lib = _build.lib("mapassign")
            for metric_mode in (True, False):
                for plan in forced_plans(n, nap, pp, p, metric_mode):
                    # The host's layout mirror against the kernel's own.
                    assert plan.smem == lib.map_assign_smem_bytes(
                        plan.rows, plan.db, plan.pw, int(metric_mode), int(plan.stream)), plan
                    if metric_mode:
                        out = _mapassign.map_assign_cuda(xp, ap, *pb, "l1", nd, True, True, p=p, plan=plan)
                        same = all(torch.equal(u, v) for u, v in zip(out, base))
                    else:
                        out = _mapassign.map_assign_cuda(base[0], None, *pb, None, nd, True, True, p=p, plan=plan)
                        same = all(torch.equal(u, v) for u, v in zip(out[1:], base_a[1:]))
                    assert same, (nd, p, metric_mode, plan)
                    n_plans += 1
            log(f"map_assign shapes n={n} m={m} n_dims={nd} p={p}: 5 metrics x {len(ops.WANTS)} wants exact "
                f"off edges (most near-edge rows {edge_rows}); plans bit-identical: "
                f"{len(forced_plans(n, nap, pp, p, True))} metric-mode, {len(forced_plans(n, nap, pp, p, False))} assign-only")
    log(f"map_assign shape sweep: {n_checks} (shape, metric, want) checks and {n_plans} forced plans, "
        f"0 coordinates over tolerance, 0 cell or bit mismatches off box edges, assign-only exact; "
        f"l1 max_abs_err {worst:.3e} ({time.perf_counter() - t0:.1f}s)")


def map_assign_args(x, anchors, boxes, out, metric: str | None, want: str, p: int, plan) -> tuple:
    """The map_assign_launch arguments, as the wrapper passes them: ``x``
    and ``anchors`` prepared (``ops._prep``; anchors None in the
    assign-only mode), ``boxes`` padded (``ops._prep_boxes``), ``out`` the
    (xm, cells, bits) buffers (xm None in the assign-only mode)."""
    cells, member = ops._want_flags(want)
    n = x.shape[0]
    pp, nap = boxes[0].shape
    na = x.shape[1] if anchors is None else anchors.shape[0]
    vec = int(x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0)
    return (x.data_ptr(), None if anchors is None else anchors.data_ptr(),
            *(b.data_ptr() for b in boxes), None if out[0] is None else out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), n, x.shape[1], na, nap, pp,
            -1 if metric is None else _build.METRIC_IDS[metric], int(cells), int(member),
            plan.rows, plan.a, plan.db, plan.pw, p, plan.grid, int(plan.stream), vec,
            _build.stream_ptr(x.device))


def check_and_time_map_assign(report: dict, x: torch.Tensor, cfg, ptx: list) -> None:
    """The map-assign kernel at the main path's shapes, in both of the
    modes the main path launches it: the metric mode over all rows with the
    plan's boxes (``want="cells"``), then the assign-only mode over the
    mapped rows with the tightened plan (``want="member"``). Each is checked
    against its plain version on the same inputs (coordinates within
    tolerance and cells equal off box edges; membership exact) and timed
    through its C entry point (the kernel), its wrapper and the ops call;
    the report row carries the sum of the two launches. Then the query
    path's launch (metric mode, ``want="member"``) at a 256- and a
    4,096-row batch, under the launch plan and under 256-row CTAs."""
    anchors, plan = main_path_plan(x, cfg)
    boxes = (plan.kernel_lo, plan.kernel_hi, plan.whole_lo, plan.whole_hi)
    n, m = x.shape
    na, p = anchors.shape[0], plan.p
    words = -(-p // ref.MEMBER_WORD)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build.lib("mapassign")

    def metric_mode(backend):
        return ops.map_assign(x, anchors, *boxes, cfg.metric, backend=backend, want="cells")

    got, want = metric_mode("cuda"), metric_mode("torch")
    err, over, cm, bm, near = check_map_assign(x, anchors, boxes, cfg.metric, got, want)
    log(f"map_assign {cfg.metric} n={n} m={m} dims={na} p={p} want=cells: xm max_abs_err {err:.3e} "
        f"(coords over tol {over}) cell mismatches off-edge {cm} (near-edge rows {near})")
    assert over == 0 and cm == 0 and bm == 0
    tight = partition.tighten(plan, want[0], want[1])
    tboxes = (tight.kernel_lo, tight.kernel_hi, tight.whole_lo, tight.whole_hi)

    def assign_mode(backend):
        return ops.assign_membership(want[0], *tboxes, backend=backend, want="member")

    (c_k, b_k), (c_p, b_p) = assign_mode("cuda"), assign_mode("torch")
    exact = bool(torch.equal(c_k, c_p) and torch.equal(b_k, b_p))
    log(f"map_assign assign-only n={n} dims={na} p={p} want=member (tightened plan): "
        f"exact {exact}, rows in >1 partition {int((ops.unpack_membership(b_p, p).sum(1) > 1).sum())}")
    assert exact
    # The kernel's time: each launch's C entry point back to back.
    xp, ap = ops._prep(x, anchors, cfg.metric)
    pb, tpb = ops._prep_boxes(*boxes), ops._prep_boxes(*tboxes)
    nap, pp = pb[0].shape[1], pb[0].shape[0]
    plan_m = _mapassign.launch_plan(n, nap, pp, p, True, n_sm)
    plan_a = _mapassign.launch_plan(n, nap, pp, p, False, n_sm)
    xm_in = want[0].contiguous()
    out_m = (torch.empty((n, na), device="cuda"), torch.empty(n, dtype=torch.int32, device="cuda"),
             torch.empty((n, pp // 32), dtype=torch.int32, device="cuda"))
    out_a = (None, torch.empty_like(out_m[1]), torch.empty_like(out_m[2]))
    args_m = map_assign_args(xp, ap, pb, out_m, cfg.metric, "cells", p, plan_m)
    args_a = map_assign_args(xm_in, None, tpb, out_a, None, "member", p, plan_a)
    ms_m = entry_ms("mapassign", "map_assign_launch", *args_m)
    ms_a = entry_ms("mapassign", "map_assign_launch", *args_a)
    assert torch.equal(out_m[1], got[1]) and torch.equal(out_a[2][:, :words], b_k)  # the same launches
    wrap_m = cuda_ms(lambda: _mapassign.map_assign_cuda(xp, ap, *pb, cfg.metric, na, True, False, p=p), reps=10)
    wrap_a = cuda_ms(lambda: _mapassign.map_assign_cuda(xm_in, None, *tpb, None, na, False, True, p=p), reps=10)
    ops_m = cuda_ms(lambda: metric_mode("cuda"), reps=5)
    ops_a = cuda_ms(lambda: assign_mode("cuda"), reps=5)
    plain_m = cuda_ms(lambda: metric_mode("torch"), reps=2)
    plain_a = cuda_ms(lambda: assign_mode("torch"), reps=2)
    occ_m = lib.map_assign_occupancy(0, plan_m.a, 1, 0, plan_m.smem, 0)
    occ_a = lib.map_assign_occupancy(-1, 1, 0, 1, plan_a.smem, plan_a.rows // 256 if plan_a.stream else 0)
    # Bytes: each input read once, each wanted output written once.
    bytes_m = 4 * (n * m + na * m + 4 * p * na + n * (na + 1))  # metric mode, want="cells"
    bytes_a = 4 * (n * na + 4 * p * na + n * words)  # assign-only mode, want="member"
    n_ops = 2.0 * n * na * m + 2.0 * n * p * na + 2.0 * n * p * na
    bms, by = bound_ms(bytes_m + bytes_a, n_ops)
    bm_m, _ = bound_ms(bytes_m, 2.0 * n * na * m + 2.0 * n * p * na)
    bm_a, _ = bound_ms(bytes_a, 2.0 * n * p * na)
    report["map_assign"].update(
        ms=ms_m + ms_a, plain_ms=plain_m + plain_a, bound_ms=bms, bound_by=by,
        metric_ms=ms_m, assign_ms=ms_a, wrapper_ms=wrap_m + wrap_a, ops_ms=ops_m + ops_a,
        ctas_per_sm=[occ_m, occ_a], **{f"assign_{k}": v for k, v in ptxas_of(ptx, "map_assign_member").items()},
    )
    log(f"map_assign main-path launches through the C entry point: metric mode {ms_m:.4f} ms "
        f"(plan {plan_m}, {occ_m} CTAs per SM; bound {bm_m:.4f} ms, target <= 0.33 ms: "
        f"{'met' if ms_m <= 0.33 else 'MISSED'}) + assign-only {ms_a:.4f} ms (plan {plan_a}, {occ_a} CTAs "
        f"per SM; bound {bm_a:.4f} ms, target <= 0.022 ms: {'met' if ms_a <= 0.022 else 'MISSED'}); "
        f"wrapper {wrap_m:.4f} + {wrap_a:.4f} ms, ops call {ops_m:.4f} + {ops_a:.4f} ms, "
        f"plain {plain_m:.4f} + {plain_a:.4f} ms, bound of the pair {bms:.4f} ms ({by})")
    for q in (256, 4096):  # the query path's launch at a batch's rows
        xq = xp[:q].contiguous()
        outq = tuple(t[:q].contiguous() for t in out_m)
        line = []
        for label, rows in (("launch plan", None), ("256-row CTAs", 256)):
            pq = _mapassign.launch_plan(q, nap, pp, p, True, n_sm, rows=rows)
            t = entry_ms("mapassign", "map_assign_launch",
                         *map_assign_args(xq, ap, pb, outq, cfg.metric, "member", p, pq), reps=100)
            line.append(f"{label} ({pq.grid} CTAs of {pq.rows} rows, {pq.a} anchors a thread) {t * 1e3:.2f} us")
        log(f"map_assign query batch of {q} rows (metric mode, want=member): {'; '.join(line)}")


def check_join_n_dims(n: int = 50_000, n_dims: int = 72) -> dict:
    """A join with more than 64 mapped dims (several anchor blocks): l1,
    ``n_dims`` anchors, on the kernels and on the plain versions (backend
    "torch" on the card); pairs byte-identical (δ in a gap of the pair
    distances). Returns the kernel join's launch counts (set to 0 just
    before it, read just after)."""
    x = _mixture(n, 128, 24)
    delta = gap_delta(x, "l1", 10.0)
    ops.reset_launch_counts()
    res, t_k = run_join(x, spjoin.JoinConfig(delta=delta, n_dims=n_dims))
    counts = ops.launch_counts()
    plain, t_p = run_join(x, spjoin.JoinConfig(delta=delta, n_dims=n_dims, backend="torch"))
    same = res.pairs.tobytes() == plain.pairs.tobytes()
    log(f"l1 join n_dims={n_dims} N={n}: {res.n_pairs} pairs in {t_k:.2f}s ({res.verify_stats.n_tiles} tiles), "
        f"plain join {t_p:.2f}s: byte-identical {same}; launch counts {json.dumps(counts)}")
    assert same and res.n_pairs > 0
    assert counts["map_assign"] > 0 and counts["pairdist_filtered"] > 0, counts
    return counts


def pick_delta(x: torch.Tensor, metric: str, mean_neighbours: float, y=None, sample: int = 2048) -> float:
    """δ with about ``mean_neighbours`` neighbours in ``y`` (default ``x``)
    per row of ``x``, from the distance quantile of a row sample. Metrics
    without a kernel take shorter row chunks (their plain distance
    broadcasts over the features)."""
    self_join = y is None
    y = x if self_join else y
    q = x[torch.randperm(x.shape[0], device=x.device)[:sample]]
    step = 256 if metric in ref.METRICS else 16
    d = torch.cat([distances.pairwise(q[i : i + step], y, metric) for i in range(0, q.shape[0], step)])
    # + the zero self-distances of a self-join
    k = int(mean_neighbours * q.shape[0]) + (q.shape[0] if self_join else 0)
    return float(d.flatten().kthvalue(k).values)


def gap_delta(x: torch.Tensor, metric: str, mean_neighbours: float, s=None) -> float:
    """δ near ``mean_neighbours`` per row, moved to the middle of the widest
    gap between neighbouring pair distances around it, so that no pair sits
    within fp reach of δ and kernel and plain distances must agree."""
    y = x if s is None else s
    d0 = pick_delta(x, metric, mean_neighbours, y=s)
    lo, hi = d0 * (1 - 1e-3), d0 * (1 + 1e-3)
    near = []
    for i in range(0, x.shape[0], 1024):
        d = ref.pairdist(x[i : i + 1024], y, metric)
        near.append(d[(d >= lo) & (d <= hi)])
    v = torch.cat(near + [torch.tensor([lo, hi], device=x.device)]).sort().values
    g = (v[1:] - v[:-1]).argmax()
    return float((v[g] + v[g + 1]) / 2)


def check_exact(got: np.ndarray, truth: np.ndarray, x, y, metric: str, delta: float) -> str:
    """The join's pairs against brute force. Byte-identical, or else every
    differing pair straddles δ between the two fp32 evaluations of its
    distance — the kernel's (what the join decides on) and the plain
    version's in the brute-force row chunk (what brute force decides on) —
    and both evaluations are within the stated tolerance (``dist_tol``) of
    the float64 distance. Anything else fails."""
    if got.tobytes() == truth.tobytes():
        return "byte-identical"
    g = {tuple(p) for p in got.tolist()}
    t = {tuple(p) for p in truth.tolist()}
    diff = torch.as_tensor(sorted(g ^ t), device="cuda")
    i, j = diff[:, 0], diff[:, 1]
    kd = torch.stack([
        ops.pairdist(x[a : a + 1], y[b : b + 1], metric, backend="cuda")[0, 0]
        for a, b in diff.tolist()
    ])
    # The plain distance exactly as brute_force_pairs computed it: the
    # same row chunk against all of y.
    pd = torch.empty_like(kd)
    for c in torch.unique(i // BRUTE_CHUNK).tolist():
        sel = (i // BRUTE_CHUNK) == c
        block = ref.pairdist(x[c * BRUTE_CHUNK : (c + 1) * BRUTE_CHUNK], y, metric)
        pd[sel] = block[i[sel] - c * BRUTE_CHUNK, j[sel]]
    d64 = (x[i].double() - y[j].double())
    d64 = d64.abs().sum(1) if metric == "l1" else d64.pow(2).sum(1).sqrt()
    nx, ny = x[i].double().norm(dim=1), y[j].double().norm(dim=1)
    tol = dist_tol(metric, x.shape[1], nx, ny, d64, kd, pd)
    in_join = torch.tensor([tuple(p) in g for p in diff.tolist()], device="cuda")
    ok = (in_join == (kd <= delta)) & (~in_join == (pd <= delta))
    ok &= (kd.double() - pd.double()).abs() <= tol
    ok &= ((kd.double() - d64).abs() <= tol) & ((pd.double() - d64).abs() <= tol)
    assert bool(ok.all()), "join pairs differ from brute force beyond fp32 straddles"
    return (f"identical but {len(diff)} pairs that straddle delta between kernel and plain fp32 "
            f"(max |kernel - plain| {float((kd - pd).abs().max()):.3e}, "
            f"largest share of its tolerance {float(((kd.double() - pd.double()).abs() / tol).max()):.3f})")


def run_join(x, cfg, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = spjoin.join(x, cfg, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def spot_check(x: torch.Tensor, pairs: np.ndarray, delta: float, rows: torch.Tensor,
               metric: str = "l1") -> str:
    """Every partner of the sampled ``rows`` by brute force on the card
    (plain version) against the join's pairs. A difference is allowed only
    for a pair whose float64 distance is within 1e-5·max(1, δ) of δ (l1),
    within its stated l2 tolerance of δ (``dist_tol``, kernel and plain
    distances both taken as the float64 one), and never for
    ``jaccard_minhash``, whose fp32 distances k/64 are exact."""
    d = distances.pairwise(x[rows], x, metric)
    hit = d <= delta
    hit[torch.arange(rows.numel(), device="cuda"), rows] = False
    pt = torch.as_tensor(pairs, device="cuda")
    got = torch.zeros_like(hit)
    for j, r in enumerate(rows.tolist()):
        partners = torch.cat([pt[pt[:, 0] == r, 1], pt[pt[:, 1] == r, 0]])
        got[j, partners] = True
    diff = (got != hit).nonzero()
    if diff.numel():
        assert metric in ("l1", "l2"), f"{metric}: join pairs differ from brute force"
        xa, xb = x[rows[diff[:, 0]]].double(), x[diff[:, 1]].double()
        if metric == "l1":
            d64 = (xa - xb).abs().sum(1)
            tol = torch.full_like(d64, 1e-5 * max(1.0, delta))
        else:
            d64 = (xa - xb).pow(2).sum(1).sqrt()
            tol = dist_tol("l2", x.shape[1], xa.norm(dim=1), xb.norm(dim=1), d64, d64, d64)
        assert bool(((d64 - delta).abs() <= tol).all()), "join missed pairs"
    return f"{rows.numel()} rows, {int(hit.sum())} partners, {diff.shape[0]} borderline differences"


def main_join(x: torch.Tensor, cfg, label: str) -> tuple[object, dict]:
    """One main-path join with the launch counts set to 0 just before and
    read just after; prints its phases, VerifyStats and counts."""
    n = x.shape[0]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res, wall = run_join(x, cfg)
    counts = ops.launch_counts()
    vs = res.verify_stats
    mean_nb = 2.0 * res.n_pairs / n
    log(f"[{label}] N={n} m={x.shape[1]} delta={cfg.delta:.6f} emit={cfg.emit} n_pairs={res.n_pairs} "
        f"mean_neighbours={mean_nb:.3f}")
    log(f"[{label}] seconds: sample {res.sample_time_s:.3f} map {res.map_time_s:.3f} "
        f"verify {res.verify_time_s:.3f} total {wall:.3f}")
    log(f"[{label}] VerifyStats " + json.dumps({
        k: getattr(vs, k) for k in (
            "n_verifications", "n_padded", "n_dispatched", "n_tiles", "n_cells", "n_hits",
            "n_pruned", "n_tiles_pruned", "n_overflow_retries", "prune", "emit",
            "n_buckets", "occupancy", "n_exact", "prune_rate",
        )
    }))
    log(f"[{label}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"[{label}] launch counts {json.dumps(counts)}")
    assert 1.0 <= mean_nb <= 100.0, mean_nb
    pairs = res.pairs
    assert pairs.dtype == np.int64 and pairs.shape[1] == 2 and (pairs[:, 0] < pairs[:, 1]).all()
    assert (np.diff(pairs[:, 0]) >= 0).all()
    log(f"[{label}] spot check: {spot_check(x, pairs, cfg.delta, torch.randperm(n, device='cuda')[:256])}")
    return res, counts


def phase_main_path(report: dict, z: torch.Tensor, ptx: list,
                    share: float) -> tuple[dict, dict, torch.Tensor, float, object]:
    """The two main-path joins over the first N_ROWS rows of ``z``, fitted
    into ``share`` seconds (MAIN_SHARE_S less the lm_serve, lm_train, lm_mesh, lm_dryrun and
    contracts phases'). The probe's budget also holds the distributed join of the compact join's
    rows (phase "distributed"), predicted as a compact join. Returns the
    launch counts of both joins, the compact join's rows, δ and its
    result."""
    log("== phase 4: main path (l1 self-join; default config, then emit=\"compact\")")
    m = z.shape[1]
    # Probe both configs at n/16, each run twice so the timed run is warm.
    # The verify work grows ~quadratically: predict both full runs and halve
    # the mask join's N first until the pair fits the share.
    probe_n = max(N_ROWS // 16, 20000)
    xp = _mixture(probe_n, m, 11)
    dp = pick_delta(xp, "l1", 10.0 * probe_n / N_ROWS)
    probes = {}
    for emit in ("mask", "compact"):
        run_join(xp, spjoin.JoinConfig(delta=dp, emit=emit))
        probes[emit] = run_join(xp, spjoin.JoinConfig(delta=dp, emit=emit))
    del xp

    def predict(emit: str, rows: int) -> float:  # sampling + map ~linear, verify ~quadratic
        res, t = probes[emit]
        r = rows / probe_n
        return (t - res.verify_time_s) * r + res.verify_time_s * r * r

    n_mask = n_compact = N_ROWS

    def total(nm: int, nc: int) -> float:  # mask + compact + distributed compact
        return predict("mask", nm) + 2 * predict("compact", nc)

    log(f"probe: {probe_n} rows, mask {probes['mask'][1]:.2f}s compact {probes['compact'][1]:.2f}s; "
        f"predicted {predict('mask', N_ROWS):.1f}s + 2 x {predict('compact', N_ROWS):.1f}s at {N_ROWS} rows")
    # δ gives ~10 neighbours a row at N_ROWS, so a quarter of the rows keeps
    # ~2.5 a row, over main_join's floor of 1: no join is cut below that (a
    # slow host then overruns the share rather than the check), and the
    # compact join keeps at least the mask join's rows.
    min_rows = N_ROWS // 4
    while n_mask > min_rows and total(n_mask, n_compact) > share:
        log(f"reduced: mask join n_rows {n_mask} -> {n_mask // 2} (predicted "
            f"{total(n_mask, n_compact):.1f}s > {share:.0f}s)")
        n_mask //= 2
    while n_compact > n_mask and total(n_mask, n_compact) > share:
        log(f"reduced: compact and distributed joins n_rows {n_compact} -> {n_compact // 2}")
        n_compact //= 2
    if total(n_mask, n_compact) > share:
        log(f"probe: predicted {total(n_mask, n_compact):.1f}s at the floor of {min_rows} rows, "
            f"over the {share:.0f}s share")
    x = z[:N_ROWS]
    delta = pick_delta(x, "l1", 10.0)
    res_m, counts_m = main_join(x[:n_mask], spjoin.JoinConfig(delta=delta), "mask")
    assert counts_m["map_assign"] > 0 and counts_m["pairdist_filtered"] > 0, counts_m
    assert counts_m["verify_compact"] == 0, counts_m
    res_c, counts_c = main_join(x[:n_compact], spjoin.JoinConfig(delta=delta, emit="compact"), "compact")
    assert counts_c["map_assign"] > 0 and counts_c["verify_compact"] > 0, counts_c
    assert counts_c["pairdist_filtered"] == 0, counts_c
    if n_mask == n_compact:
        same = res_m.pairs.tobytes() == res_c.pairs.tobytes()
        log(f"compact == mask pairs at N={n_mask}: {same}")
    else:
        # Both joins are exact, so the mask join over the first n_mask rows
        # holds exactly the compact join's pairs among those rows.
        sub = res_c.pairs[(res_c.pairs < n_mask).all(1)]
        same = res_m.pairs.tobytes() == sub.tobytes()
        log(f"mask pairs at N={n_mask} == the compact join's pairs among those rows ({len(sub)}): {same}")
    assert same
    check_and_time_map_assign(report, x[:n_compact], spjoin.JoinConfig(delta=delta), ptx)
    return counts_m, counts_c, x[:n_compact], delta, res_c


def main_path_plan(x: torch.Tensor, cfg) -> tuple:
    """The anchors and (untightened) plan that ``spjoin.join(x, cfg)``
    builds: the same seeded generators, four shards and control plane."""
    gen = torch.Generator().manual_seed(cfg.seed)
    gen_anchor = torch.Generator().manual_seed(cfg.seed + spjoin._ANCHOR_SEED_OFFSET)
    shards = list(torch.tensor_split(x, 4))
    stats = spjoin.fit_node_stats(shards, cfg.t_cells)
    pivots = spjoin.draw_pivots(gen, shards, stats, cfg)
    plan, smap = spjoin.build_plan(gen_anchor, pivots, cfg)
    return smap.anchors, plan


def profile_join(n: int, emit: str) -> None:
    """Where the join's time goes on the device: one l1 join of n rows
    under torch.profiler (:func:`device_time`)."""
    from torch.profiler import ProfilerActivity, profile

    x = _mixture(n, 128, 13)
    torch.manual_seed(1)  # the same δ for both emission modes
    cfg = spjoin.JoinConfig(delta=pick_delta(x, "l1", 10.0), emit=emit)
    run_join(x, cfg)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res, wall = run_join(x, cfg)
    busy, per_kernel = device_time(prof)
    log(f"profile emit={emit}: N={n} join wall {wall * 1e3:.1f} ms (verify {res.verify_time_s * 1e3:.1f} ms, "
        f"{res.verify_stats.n_tiles} tiles) device busy {busy:.1f} ms = {busy / (wall * 1e3):.3f} of wall")
    for name, ms in per_kernel[:8]:
        log(f"  device {ms:10.2f} ms  {name[:100]}")


def device_time(prof) -> tuple[float, list]:
    """Device milliseconds of a profiled window in all and by kernel name
    (largest first): the sum of the kernels' intervals (one stream, so
    they do not overlap)."""
    from torch.autograd import DeviceType

    per_kernel: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return sum(per_kernel.values()), sorted(per_kernel.items(), key=lambda kv: -kv[1])


def _timed_queries(idx, batches: list, label: str) -> tuple[np.ndarray, list, dict]:
    """Query ``batches`` in turn, each timed on the host clock around a
    synchronised call, with the launch counts set to 0 just before the
    first and read just after the last; stops early once SMALL_SHARE_S is
    spent (the small-batch arm). Returns (latencies, answers, counts)."""
    lat, answers = [], []
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    for i, q in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pairs, st = idx.query_batch(q, with_stats=True)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        answers.append(pairs)
        if q.shape[0] == QUERY_BATCH:
            log(f"query batch {i}: {q.shape[0]} rows, {len(pairs)} pairs, route {st.route_s:.4f}s "
                f"verify {st.verify_s:.4f}s total {lat[-1]:.4f}s, duplication {st.duplication:.3f}, "
                f"tiles {st.verify.n_tiles}, prune rate {st.verify.prune_rate:.4f}")
        elif time.perf_counter() - t_start > SMALL_SHARE_S:
            break
    counts = ops.launch_counts()
    log(f"{label} launch counts {json.dumps(counts)}")
    assert counts["map_assign"] > 0 and counts["pairdist_filtered"] > 0, counts
    return np.array(lat), answers, counts


def phase_serving(z: torch.Tensor, delta: float) -> tuple[object, list]:
    """The persistent index over the main path's rows: build, timed query
    batches of fresh rows of the same mixture (4,096-row batches, then
    256-row batches for a tail latency), brute-force checks, save -> load
    -> query, and one insert of 1 % of the rows. Each part's launch counts
    are set to 0 just before it and read just after."""
    log("== serving: build_index over the main path's rows, query, save/load, insert")
    x = z[:N_ROWS]
    fresh = z[N_ROWS : N_ROWS + SERVING_ROWS]
    n_ins = int(INSERT_SHARE * N_ROWS)
    delta_rows = z[N_ROWS + SERVING_ROWS : N_ROWS + SERVING_ROWS + n_ins]
    cfg = spjoin.JoinConfig(delta=delta)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = index.build_index(x, cfg)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"build_index: N={idx.n_rows} p={idx.p} k={idx.k} backend={idx.backend} in {time.perf_counter() - t0:.3f}s; "
        f"launch counts {json.dumps(counts)}")
    assert counts["map_assign"] > 0, counts
    n_big = (N_QUERY_BATCHES + 1) * QUERY_BATCH
    batches = [fresh[i * QUERY_BATCH : (i + 1) * QUERY_BATCH] for i in range(N_QUERY_BATCHES + 1)]
    idx.query_batch(batches[-1])  # warm
    lat_s, answers, _ = _timed_queries(idx, batches[:-1], f"{QUERY_BATCH}-row batches")
    log(f"serving {QUERY_BATCH}-row batches: QPS {N_QUERY_BATCHES * QUERY_BATCH / lat_s.sum():.1f} "
        f"p50 {np.percentile(lat_s, 50):.4f}s largest of {lat_s.size} {lat_s.max():.4f}s per batch")
    small = [fresh[n_big + i * SMALL_BATCH : n_big + (i + 1) * SMALL_BATCH] for i in range(N_SMALL_BATCHES)]
    lat_s, _, _ = _timed_queries(idx, small, f"{SMALL_BATCH}-row batches")
    log(f"serving {SMALL_BATCH}-row batches: {lat_s.size} timed, QPS {lat_s.size * SMALL_BATCH / lat_s.sum():.1f} "
        f"p50 {np.percentile(lat_s, 50):.4f}s p99 {np.percentile(lat_s, 99):.4f}s largest {lat_s.max():.4f}s per batch")
    for i in (0, 1):
        truth = index.brute_force_query(x, batches[i], delta, "l1")
        log(f"query batch {i} vs brute force: {check_exact(answers[i], truth, x, batches[i], 'l1', delta)}")
    path = os.path.join(ROOT, "build", "chip_smoke_index")
    t0 = time.perf_counter()
    idx.save(path)
    loaded = index.MetricIndex.load(path, metric="l1", delta=delta, k=idx.k)
    same = loaded.query_batch(batches[0]).tobytes() == answers[0].tobytes()
    log(f"save -> load -> query: byte-identical {same} ({time.perf_counter() - t0:.2f}s)")
    assert same
    del loaded
    n_old = idx.n_rows
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_pairs, st = idx.insert_batch(delta_rows)
    torch.cuda.synchronize()
    t_ins = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"insert_batch: {st.n_delta} rows onto {st.n_resident} in {t_ins:.3f}s (route {st.route_s:.3f}s "
        f"verify {st.verify_s:.3f}s update {st.update_s:.3f}s), action {st.action}, drift {st.drift:.4f}, "
        f"new pairs {st.n_new_pairs} (cross {st.n_cross_pairs}, self {st.n_self_pairs}); "
        f"launch counts {json.dumps(counts)}")
    assert counts["map_assign"] > 0 and counts["pairdist_filtered"] > 0, counts
    full = torch.cat([x, delta_rows])
    rows = n_old + torch.randperm(n_ins, device="cuda")[:256]
    log(f"insert spot check: {spot_check(full, new_pairs, delta, rows)}")
    assert idx.n_rows == n_old + n_ins and (new_pairs[:, 1] >= n_old).all()
    check_index_integer_rows()
    return idx, batches


INT_INDEX_ROWS, INT_INDEX_QUERIES, INT_INDEX_INSERT = 45_000, 2_500, 2_500  # aol-like q-gram rows
INT_INDEX_DELTA = 4.0  # l1 on integer profiles: many pairs at exactly delta


def check_index_integer_rows() -> None:
    """The index on integer rows, where many pairs sit at exactly delta and
    the card's map-assign sums a coordinate in another order than the
    plain path: aol-like q-gram profiles (``vectorize.qgram_profile`` of
    ``synthetic.strings``, seed 4), an index over INT_INDEX_ROWS, a query
    batch of INT_INDEX_QUERIES and an insert of INT_INDEX_INSERT rows, l1
    at delta = 4. l1 distances of integer rows are exact in fp32, so the
    query's and the insert's pairs must equal brute force byte for byte.
    The launch counts are set to 0 just before and read just after."""
    n = INT_INDEX_ROWS + INT_INDEX_QUERIES + INT_INDEX_INSERT
    strs = synthetic.strings(n, mutate=0.12, n_templates=n // STRINGS_PER_TEMPLATE, seed=4)
    rows = torch.as_tensor(vectorize.qgram_profile(strs, q=2, dim=64)).cuda()
    x, q = rows[:INT_INDEX_ROWS], rows[INT_INDEX_ROWS : INT_INDEX_ROWS + INT_INDEX_QUERIES]
    new = rows[INT_INDEX_ROWS + INT_INDEX_QUERIES :]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    idx = index.build_index(x, spjoin.JoinConfig(delta=INT_INDEX_DELTA, metric="l1"))
    got_q = idx.query_batch(q)
    got_i, st = idx.insert_batch(new)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    want_q = index.brute_force_query(x, q, INT_INDEX_DELTA, "l1")
    cross = index.brute_force_query(x, new, INT_INDEX_DELTA, "l1")
    own = spjoin.brute_force_pairs(new, INT_INDEX_DELTA, "l1")
    want_i = np.unique(np.concatenate([np.stack([cross[:, 0], INT_INDEX_ROWS + cross[:, 1]], 1),
                                       INT_INDEX_ROWS + own]), axis=0).astype(np.int64)
    at_delta = int((torch.cdist(q, x, p=1) == INT_INDEX_DELTA).sum())
    ok = got_q.tobytes() == want_q.tobytes() and got_i.tobytes() == want_i.tobytes()
    log(f"integer-row index (aol-like q-gram profiles, {INT_INDEX_ROWS} rows, l1 delta {INT_INDEX_DELTA}): "
        f"query batch of {INT_INDEX_QUERIES}: {len(got_q)} pairs vs brute force {len(want_q)} ({at_delta} at exactly "
        f"delta); insert of {INT_INDEX_INSERT}: {len(got_i)} new pairs vs {len(want_i)} (cross {st.n_cross_pairs}, "
        f"self {st.n_self_pairs}); build + query + insert {secs:.3f}s; launch counts {json.dumps(counts)}: "
        f"{'equal' if ok else 'DIFFERENT'}")
    assert counts["map_assign"] > 0, counts
    assert ok


def phase_distributed(x: torch.Tensor, delta: float, compact, idx, batches: list) -> dict:
    """The distributed executor on an NCCL process group of world size 1:
    distributed_join over the compact join's rows with its config, pairs
    byte-identical to it; then DistIndex over the serving index (two query
    batches byte-identical to MetricIndex.query_batch, one insert). The
    launch and collective counts are set to 0 just before the join and
    each DistIndex call and read just after it; returns the join's."""
    import torch.distributed as dist

    log("== distributed: torch.distributed (NCCL, world size 1) join and DistIndex serving")
    rdzv = os.path.join(ROOT, "build", "chip_smoke_rdzv")
    os.makedirs(os.path.dirname(rdzv), exist_ok=True)
    if os.path.exists(rdzv):
        os.remove(rdzv)
    dist.init_process_group("nccl", init_method=f"file://{rdzv}", world_size=1, rank=0,
                            device_id=torch.device("cuda:0"))
    try:
        n = x.shape[0]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        distributed.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = distributed.distributed_join(
            x, delta=delta, metric="l1", k=1024, p=16, n_dims=8, prune="pivot",
            placement="lpt", emit_pairs=True, emit="compact",
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        coll = distributed.collective_counts()
        log(f"[distributed] N={n} m={x.shape[1]} delta={delta:.6f} n_pairs={len(res.pairs)} in {wall:.3f}s: "
            f"stats {res.stats_time_s:.3f}s control {res.control_time_s:.3f}s counts {res.counts_time_s:.3f}s "
            f"verify {res.verify_time_s:.3f}s")
        log(f"[distributed] collectives {json.dumps(coll)}")
        pl = res.placement_plan
        log("[distributed] telemetry " + json.dumps({
            "n_hits": res.n_hits, "n_verifications": res.n_verifications,
            "n_candidates": res.n_candidates, "pruning_rate": res.pruning_rate,
            "n_tiles": res.n_tiles, "n_overflow_retries": res.n_overflow_retries,
            "overflow": res.overflow, "emit": res.emit, "prune": res.prune,
            "capacity_padding": res.capacity_padding, "duplication": res.duplication,
            "exact_cap_w": res.exact_cap_w, "predicted_cap_w": res.predicted_cap_w,
            "predicted_survival": res.predicted_survival, "accept_rate": res.accept_rate,
            "device_loads": res.device_loads.tolist(), "balance_std": res.balance_std,
            "makespan_ratio": res.makespan_ratio, "capacity_saved_bytes": res.capacity_saved_bytes,
            "placement": res.placement, "n_slots": pl.n_slots, "split_cells": pl.n_split_cells,
        }))
        log(f"[distributed] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        log(f"[distributed] launch counts {json.dumps(counts)}")
        same = res.pairs.tobytes() == compact.pairs.tobytes()
        log(f"[distributed] pairs == the compact join's ({len(compact.pairs)} pairs): {same}")
        assert same
        assert res.overflow == 0 and res.n_hits == len(res.pairs)
        for name in ("histogram", "map_assign", "verify_compact"):
            assert counts[name] > 0, (name, counts)
        assert coll == {"stats.all_gather": 3, "counts.all_gather": 8, "verify.all_to_all": 6,
                        "result.all_gather": 2}, coll

        t0 = time.perf_counter()
        didx = idx.to_distributed()
        torch.cuda.synchronize()
        log(f"[distributed] DistIndex pinned {didx.pl.n_slots} slots, cap_v {didx.cap_v}, "
            f"in {time.perf_counter() - t0:.3f}s")
        # The DistIndex path's own counts: set to 0 just before each of its
        # calls and read just after, before the MetricIndex reference runs.
        for i in (0, 1):
            ops.reset_launch_counts()
            distributed.reset_collective_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = didx.query_batch(batches[i])
            torch.cuda.synchronize()
            t_q = time.perf_counter() - t0
            q_counts, q_coll = ops.launch_counts(), distributed.collective_counts()
            want = idx.query_batch(batches[i])
            same = got.tobytes() == want.tobytes()
            log(f"[distributed] DistIndex query batch {i}: {len(got)} pairs in {t_q:.3f}s, "
                f"== MetricIndex.query_batch {same}; launch counts {json.dumps(q_counts)}, "
                f"collectives {json.dumps(q_coll)}")
            assert same
            assert q_counts["map_assign"] > 0 and q_counts["pairdist_filtered"] > 0, q_counts
            assert q_coll == {"serve.all_to_all": 3, "result.all_gather": 2}, q_coll
        n_old = idx.n_rows
        rows_new = batches[-1][: QUERY_BATCH // 4]  # query rows, not in the index
        ops.reset_launch_counts()
        distributed.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new_pairs, st = didx.insert_batch(rows_new)
        torch.cuda.synchronize()
        t_ins = time.perf_counter() - t0
        ins_counts, ins_coll = ops.launch_counts(), distributed.collective_counts()
        log(f"[distributed] DistIndex insert_batch: {st.n_delta} rows onto {st.n_resident} in "
            f"{t_ins:.3f}s, action {st.action}, new pairs {st.n_new_pairs} (cross {st.n_cross_pairs}); "
            f"launch counts {json.dumps(ins_counts)}, collectives {json.dumps(ins_coll)}")
        assert ins_counts["map_assign"] > 0 and ins_counts["pairdist_filtered"] > 0, ins_counts
        assert ins_coll.get("serve.all_to_all") == 3, ins_coll  # ΔR×R_old through the serve stage
        rows = n_old + torch.randperm(rows_new.shape[0], device="cuda")[:256]
        log(f"[distributed] insert spot check: {spot_check(idx.data, new_pairs, delta, rows)}")
        assert idx.n_rows == n_old + rows_new.shape[0]
        profile_distributed(50_000)
        return counts
    finally:
        dist.destroy_process_group()


def profile_distributed(n: int) -> None:
    """Where the distributed join's time goes on the device: one compact l1
    join of n rows on the initialised world under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    x = _mixture(n, 128, 13)
    torch.manual_seed(1)
    kw = dict(delta=pick_delta(x, "l1", 10.0), metric="l1", k=1024, p=16, n_dims=8,
              emit_pairs=True, emit="compact")
    distributed.distributed_join(x, **kw)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = distributed.distributed_join(x, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, per_kernel = device_time(prof)
    log(f"profile distributed emit=compact: N={n} join wall {wall * 1e3:.1f} ms (verify "
        f"{res.verify_time_s * 1e3:.1f} ms, {res.n_tiles} tiles) device busy {busy:.1f} ms = "
        f"{busy / (wall * 1e3):.3f} of wall")
    for name, ms in per_kernel[:8]:
        log(f"  device {ms:10.2f} ms  {name[:100]}")


def _same_or_straddles(got: np.ndarray, want: np.ndarray, truth, x, y, metric, delta) -> str:
    """Byte-identical to ``want``, or else both exact against brute force
    up to delta straddles (``check_exact``)."""
    if got.tobytes() == want.tobytes():
        return "byte-identical"
    return "differs only by straddles: " + check_exact(got, truth, x, y, metric, delta)


def phase_exactness() -> dict:
    log("== phase 5: exactness on the card (N = 50,000)")
    n, m = 50_000, 128
    counts = {}
    for metric in ("l1", "l2"):
        x = _mixture(n, m, 21)
        delta = gap_delta(x, metric, 10.0)
        truth = spjoin.brute_force_pairs(x, delta, metric, device="cuda", chunk=BRUTE_CHUNK)
        base = spjoin.JoinConfig(delta=delta, metric=metric)
        pivot, t_pivot = run_join(x, base)
        ops.reset_launch_counts()
        none, t_none = run_join(x, spjoin.JoinConfig(delta=delta, metric=metric, prune="none"))
        counts = ops.launch_counts()  # the prune="none" path: the plain pairdist kernel
        same = pivot.pairs.tobytes() == none.pairs.tobytes()
        verdict = check_exact(pivot.pairs, truth, x, x, metric, delta)
        log(f"{metric}: delta {delta:.6f} pairs {pivot.n_pairs} brute force {len(truth)}: "
            f"{verdict}; prune pivot == none {same} ({t_pivot:.2f}s / {t_none:.2f}s); "
            f"prune=none launch counts {json.dumps(counts)}")
        assert same, metric
        assert counts["pairdist"] > 0, counts
        for kw in (dict(emit="compact"), dict(prune="window"), dict(prune="window", emit="compact")):
            ops.reset_launch_counts()
            res, t = run_join(x, spjoin.JoinConfig(delta=delta, metric=metric, **kw))
            kw_counts = ops.launch_counts()
            same = res.pairs.tobytes() == pivot.pairs.tobytes()
            log(f"{metric} {kw}: == default join {same} ({t:.2f}s, {res.verify_stats.n_tiles} tiles, "
                f"prune rate {res.verify_stats.prune_rate:.4f}); launch counts {json.dumps(kw_counts)}")
            assert same, (metric, kw)
            # Window tiles run the plain pairdist kernel (mask) or the
            # verify-compact kernel without coordinates (compact).
            verify_kernel = "verify_compact" if kw.get("emit") == "compact" else "pairdist"
            assert kw_counts["map_assign"] > 0 and kw_counts[verify_kernel] > 0, kw_counts
            if kw.get("prune") == "window":
                assert kw_counts["pairdist_filtered"] == 0, kw_counts
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        inc = spjoin.join_incremental(torch.tensor_split(x, 4), base)
        t_inc = time.perf_counter() - t0
        inc_counts = ops.launch_counts()
        verdict = _same_or_straddles(inc.pairs, pivot.pairs, truth, x, x, metric, delta)
        log(f"{metric} join_incremental (4-way split, actions {[st.action for st in inc.stats]}): "
            f"{verdict} ({t_inc:.2f}s); launch counts {json.dumps(inc_counts)}")
        assert inc_counts["map_assign"] > 0 and inc_counts["pairdist_filtered"] > 0, inc_counts
        if metric == "l1":
            assert verdict == "byte-identical"
    check_join_n_dims(n)
    x = _mixture(n, m, 21)
    delta = gap_delta(x, "l1", 10.0)
    base, _ = run_join(x, spjoin.JoinConfig(delta=delta))
    knobs = {k: getattr(verify, k) for k in
             ("DEFAULT_EMIT_RATE", "EMIT_SLACK", "_EMIT_FLOOR", "_estimate_emit_rate")}
    verify.DEFAULT_EMIT_RATE = verify.EMIT_SLACK = 1e-9
    verify._EMIT_FLOOR = 1
    verify._estimate_emit_rate = lambda *a, **k: 1e-9
    forced, t = run_join(x, spjoin.JoinConfig(delta=delta, emit="compact"))
    for k, v in knobs.items():
        setattr(verify, k, v)
    vs = forced.verify_stats
    log(f"l1 forced-overflow compact join: n_overflow_retries {vs.n_overflow_retries} over {vs.n_tiles} "
        f"tiles, == default join {forced.pairs.tobytes() == base.pairs.tobytes()} ({t:.2f}s)")
    assert vs.n_overflow_retries > 0 and forced.pairs.tobytes() == base.pairs.tobytes()
    r, s = synthetic.rs_mixture(20_000, 40_000, m, n_clusters=64, seed=22)
    r, s = torch.as_tensor(r).cuda(), torch.as_tensor(s).cuda()
    delta = gap_delta(r, "l1", 10.0, s=s)
    truth = spjoin.brute_force_pairs(r, delta, "l1", s=s, device="cuda", chunk=BRUTE_CHUNK)
    res, t = run_join(r, spjoin.JoinConfig(delta=delta), s=s)
    verdict = check_exact(res.pairs, truth, r, s, "l1", delta)
    log(f"R x S l1: |R|={r.shape[0]} |S|={s.shape[0]} delta {delta:.6f} pairs {res.n_pairs} brute force {len(truth)}: {verdict} ({t:.2f}s)")
    for kw in (dict(emit="compact"), dict(prune="window")):
        other, t = run_join(r, spjoin.JoinConfig(delta=delta, **kw), s=s)
        same = other.pairs.tobytes() == res.pairs.tobytes()
        log(f"R x S l1 {kw}: == default join {same} ({t:.2f}s)")
        assert same, kw
    return counts


# --------------------------------------------------------------------------
# the paper's comparison (Fig. 9) and dedup
# --------------------------------------------------------------------------

FIG9_ROWS = 250_000  # rows of each dataset of the comparison
FIG9_PUBMED_ROWS = 100_000  # the pubmed-like set's rows (cut: plain path only)
STRINGS_PER_TEMPLATE = 47  # benchmarks/common.py: 1,500 strings over 32 templates
FIG9_ARMS = ("spjoin", "kpm", "mrsim", "cluster")


def fig9_datasets(n: int, n_pubmed: int) -> list[tuple[str, torch.Tensor, str]]:
    """The paper's four datasets, built with the port's generators as
    ``benchmarks/common.py`` builds them (seed 0), on the card:
    (name, rows, metric)."""
    nf = synthetic.mixture(n, 20, n_clusters=6, spread=6.0, skew=0.3, seed=0)
    sift = synthetic.heavy_tailed(n, 32, alpha=2.5, seed=1)
    strs = synthetic.strings(n, mutate=0.12, n_templates=n // STRINGS_PER_TEMPLATE, seed=2)
    aol = vectorize.qgram_profile(strs, q=2, dim=64)
    docs = synthetic.strings(n_pubmed, length=(24, 60), mutate=0.08,
                             n_templates=n_pubmed // STRINGS_PER_TEMPLATE, seed=3)
    pubmed = vectorize.minhash(vectorize.shingle_sets(docs, q=3), k=64).astype(np.float32)
    return [
        (name, torch.as_tensor(v).cuda(), metric)
        for name, v, metric in (
            ("netflix-like", nf, "l1"), ("sift-like", sift, "l2"),
            ("aol-like", aol, "l1"), ("pubmed-like", pubmed, "jaccard_minhash"),
        )
    ]


def fig9_arm(fn) -> tuple[object, float, dict]:
    """One arm's join with the launch counts set to 0 just before and read
    just after: (result, wall seconds, counts)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, ops.launch_counts()


def check_fig9_launches(metric: str, counts: dict) -> None:
    """The kernels each arm must (and must not) have launched."""
    if not ops.supports_kernel(metric):  # plain path by capability
        assert all(v == 0 for c in counts.values() for v in c.values()), counts
        return
    for arm in ("mrsim", "cluster"):
        assert counts[arm]["pairdist"] > 0 and counts[arm]["pairdist_filtered"] == 0, (arm, counts)
    for arm in ("spjoin", "kpm"):
        assert counts[arm]["map_assign"] > 0 and counts[arm]["pairdist_filtered"] > 0, (arm, counts)


def fig9_dataset(name: str, x: torch.Tensor, metric: str) -> tuple[float, dict, dict]:
    """The four arms of Fig. 9 over one dataset at δ for ~10 neighbours per
    row; pairs byte-identical across the arms and checked against brute
    force (in full at the cut pubmed size, 256 sampled rows otherwise).
    Returns (δ, (result, wall seconds) by arm, launch counts by arm)."""
    n = x.shape[0]
    delta = pick_delta(x, metric, 10.0)
    cfg = dict(k=1024, p=16, n_dims=8)
    arms = {
        "spjoin": lambda: spjoin.join(x, spjoin.JoinConfig(
            delta=delta, metric=metric, sampler="generative", partitioner="learning", **cfg)),
        "kpm": lambda: spjoin.join(x, baselines.kpm_config(delta, metric, **cfg)),
        "mrsim": lambda: baselines.ball_join(x, delta, metric, n_pivots=16),
        "cluster": lambda: baselines.ball_join(x, delta, metric, n_pivots=32),
    }
    results, counts = {}, {}
    for arm, fn in arms.items():
        res, wall, counts[arm] = fig9_arm(fn)
        results[arm] = res, wall
        vs = res.verify_stats
        log(f"[fig9 {name} {arm}] N={n} m={x.shape[1]} {metric} delta={delta:.6f} wall {wall:.3f}s "
            f"(sample {res.sample_time_s:.3f} map {res.map_time_s:.3f} verify {res.verify_time_s:.3f}); "
            f"verifications {res.n_verifications} tiles {vs.n_tiles} pairs {res.n_pairs} "
            f"prune {vs.prune} prune_rate {vs.prune_rate:.4f}; launch counts {json.dumps(counts[arm])}")
    base = results["spjoin"][0].pairs
    same = {arm: r.pairs.tobytes() == base.tobytes() for arm, (r, _) in results.items()}
    log(f"[fig9 {name}] pairs byte-identical across the arms: {same}")
    assert all(same.values()), same
    assert base.shape[0] > 0
    if ops.supports_kernel(metric):
        verdict = spot_check(x, base, delta, torch.randperm(n, device="cuda")[:256], metric)
    else:
        truth = spjoin.brute_force_pairs(x, delta, metric, device="cuda", chunk=64)
        assert base.tobytes() == truth.tobytes(), "pairs differ from brute force"
        verdict = f"byte-identical to brute force ({len(truth)} pairs)"
    log(f"[fig9 {name}] brute force: {verdict}")
    check_fig9_launches(metric, counts)
    return delta, results, counts


def check_dedup(x: torch.Tensor, delta: float, sp_pairs: np.ndarray) -> dict:
    """``dedup`` over the aol-like profiles at δ: its pairs equal the
    SP-Join arm's, its keep mask the lowest index of each connected
    component (scipy's ``connected_components`` over the same pairs)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = x.shape[0]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = dedup_lib.dedup(x, delta, metric="l1")
    t = time.perf_counter() - t0
    counts = ops.launch_counts()
    p = res.pairs
    graph = coo_matrix((np.ones(len(p)), (p[:, 0], p[:, 1])), shape=(n, n))
    n_comp, labels = connected_components(graph, directed=False)
    first = np.full(n_comp, n)
    np.minimum.at(first, labels, np.arange(n))
    keep = np.zeros(n, bool)
    keep[first] = True
    log(f"[dedup aol-like] N={n} delta={delta:.6f}: {res.n_components} components, "
        f"{res.n_duplicates} duplicates, {len(p)} pairs in {t:.3f}s; pairs == SP-Join arm's "
        f"{p.tobytes() == sp_pairs.tobytes()}, keep mask == connected_components' "
        f"{np.array_equal(keep, res.keep_mask)} ({n_comp} components); launch counts {json.dumps(counts)}")
    assert p.tobytes() == sp_pairs.tobytes()
    assert n_comp == res.n_components and np.array_equal(keep, res.keep_mask)
    assert counts["map_assign"] > 0 and counts["pairdist_filtered"] > 0, counts
    return counts


def check_pairdist_count(x: torch.Tensor, delta: float) -> None:
    """``ops.pairdist_count`` (the plain pairdist kernel's mask, summed)
    over 4,096 rows against all of ``x`` (l2), held against the plain
    count: a row's counts may differ only by its pairs whose plain distance
    lies within the stated l2 tolerance of δ."""
    q = x[torch.randperm(x.shape[0], device="cuda")[:4096]]
    got = count_one_launch("pairdist", lambda: ops.pairdist_count(q, x, delta, "l2", backend="cuda"))
    want = ref.pairdist_count(q, x, delta, "l2")
    d = ref.pairdist(q, x, "l2").double()
    tol = dist_tol("l2", x.shape[1], q.double().norm(dim=1)[:, None],
                   x.double().norm(dim=1)[None, :], d, d, d)
    band = ((d - delta).abs() <= tol).sum(1)
    off = (got.long() - want.long()).abs()
    log(f"pairdist_count 4096 x {x.shape[0]} l2: {int(want.sum())} pairs, rows that differ "
        f"{int((off > 0).sum())} (largest difference {int(off.max())}, all within the band: "
        f"{bool((off <= band).all())})")
    assert got.dtype == torch.int32 and bool((off <= band).all())


def phase_fig9() -> dict:
    """The paper's comparison on the card: SP-Join, KPM and the two ball
    joins over the four datasets, then dedup and ``pairdist_count``.
    Returns each dataset's launch counts by arm."""
    log("== phase 6: the paper's comparison (Fig. 9) and dedup")
    log(f"reduced: the string corpora keep benchmarks/common.py's ~{STRINGS_PER_TEMPLATE} strings "
        f"per template: n_templates = N // {STRINGS_PER_TEMPLATE} ({FIG9_ROWS // STRINGS_PER_TEMPLATE} "
        f"at N = {FIG9_ROWS}, not the generator's default 32)")
    log(f"reduced: pubmed-like N = {FIG9_PUBMED_ROWS} (not {FIG9_ROWS}): jaccard_minhash has no "
        f"kernel and takes the plain path, whose arms each verify ~N^2 pairs of 64 signature entries")
    t0 = time.perf_counter()
    data = fig9_datasets(FIG9_ROWS, FIG9_PUBMED_ROWS)
    log(f"datasets built in {time.perf_counter() - t0:.2f}s")
    table, launches, deltas = [], {}, {}
    for name, x, metric in data:
        deltas[name], results, launches[name] = fig9_dataset(name, x, metric)
        for arm, (res, wall) in results.items():
            table.append([name, arm, x.shape[0], round(deltas[name], 6), round(wall, 3),
                          round(res.sample_time_s, 3), round(res.map_time_s, 3),
                          round(res.verify_time_s, 3), res.n_verifications,
                          res.verify_stats.n_tiles, res.n_pairs])
        if name == "aol-like":
            launches["dedup"] = check_dedup(x, deltas[name], results["spjoin"][0].pairs)
        if name == "sift-like":
            check_pairdist_count(x, deltas[name])
        del results
    log("fig9 table [dataset, arm, N, delta, wall s, sample s, map s, verify s, "
        "verifications, tiles, pairs]:")
    for row in table:
        log("  " + json.dumps(row))
    log(f"fig9 launches {json.dumps(launches)}")
    return launches


# --------------------------------------------------------------------------
# lm_serve: the LM stack's serving path at full width, every family
# --------------------------------------------------------------------------

LM_ARCH = "qwen1.5-0.5b"  # the smallest dense model of the zoo, whole on one card
LM_REQUESTS, LM_PROMPT, LM_GEN = 8, 128, 64  # requests, prompt tokens, generated tokens
LM_MQA_ARCH, LM_MQA_LAYERS, LM_MQA_GEN = "granite-34b", 4, 16  # MQA + GELU, depth cut
# The moe, hybrid and ssm runs: (arch, layers served or None for full depth,
# generated tokens, layers of check (a)'s act fp32 model (None: full depth),
# layers of check (b)'s cut: one of each block kind).
LM_FAMILY_RUNS = (
    ("deepseek-moe-16b", None, 64, None, 2),  # (b): layer0 (dense) + one MoE layer
    ("llama4-scout-17b-a16e", 2, 16, 2, 1),  # 107.8 B parameters whole: 2 of 48 layers
    ("zamba2-2.7b", None, 16, None, 6),  # (b): one group, 6 Mamba2 layers + the shared block
    ("xlstm-1.3b", None, 16, 8, 8),  # one group: 7 mLSTM layers + 1 sLSTM layer
)
LM_SSM_AGREE = 0.9  # argmax agreement, the reference's bar for hybrid and ssm (tests/test_models.py)
LM_PROFILE = 4  # prompt and generated tokens of each run's profiled window
LM_BF16_TOL = 0.15  # rtol = atol of the reference's decode-vs-forward bar (tests/test_models.py)
LM_AGREE = 0.95  # ... and its argmax agreement
LM_CPU_BATCH, LM_CPU_PROMPT, LM_CPU_GEN = 2, 8, 4  # check (b): act fp32, card against CPU
LM_FP32_REL = 1e-2  # check (b): max |logit difference| / max |logit|; the fp32 path keeps
#   the reference's bf16 steps (KV cache, probabilities, the o @ wo product), each a
#   rounding of 2^-8 = 3.9e-3 that the card and the CPU may take on either side


def lm_trace(model, prompts: torch.Tensor, n_gen: int,
             fp32_caches: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The steps ``serve.generate`` runs (prefill by decode, then greedy
    decode from the last prompt token at position prompt_len), keeping
    every step's logits: (ids (B, n_gen), fp32 logits (B, T + n_gen, V)).
    ``fp32_caches``: the KV caches (``kv``, ``kv0``) held in fp32."""
    step = ts.make_serve_step(model.cfg)
    B, T = prompts.shape
    state = model.init_state(B, T + n_gen)
    if fp32_caches:
        state = {k: {n: c.float() for n, c in v.items()} if k in ("kv", "kv0") else v
                 for k, v in state.items()}
    logits = []
    for t in range(T):
        _, lg, state = step(model, prompts[:, t : t + 1], state, t)
        logits.append(lg[:, 0].float())
    tok, ids = prompts[:, -1:], []
    for i in range(n_gen):
        tok, lg, state = step(model, tok, state, T + i)
        ids.append(tok[:, 0])
        logits.append(lg[:, 0].float())
    return torch.stack(ids, 1) if ids else prompts[:, :0], torch.stack(logits, 1)


def lm_over_bar(got: torch.Tensor, want: torch.Tensor) -> int:
    """Positions (B, S) whose worst |got - want| - LM_BF16_TOL |want|
    exceeds LM_BF16_TOL."""
    d = (got.float() - want.float()).abs() - LM_BF16_TOL * want.float().abs()
    return int((d.amax(-1) > LM_BF16_TOL).sum())


def lm_bf16_gap(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float, float]:
    """(worst |got - want| - LM_BF16_TOL |want|, max |got - want|, argmax
    agreement, argmax agreement at bf16 resolution). The reference's
    assert_allclose(got, want, 0.15, 0.15) holds when the first is at most
    0.15. At bf16 resolution a position agrees when ``want`` scores got's
    argmax within one bf16 ulp of its own maximum: over 32,000-202,048
    random logits the top two often lie within one ulp (2^-7 relative), and
    which of them an argmax takes says nothing of the path."""
    a, b = got.float(), want.float()
    d = (a - b).abs()
    excess = float((d - LM_BF16_TOL * b.abs()).max())
    pick = a.argmax(-1)
    top = b.amax(-1)
    ulp = torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
    tie = (b.gather(-1, pick[..., None])[..., 0] >= top - ulp).float().mean()
    return excess, float(d.max()), float((pick == b.argmax(-1)).float().mean()), float(tie)


def lm_gaps(model, prompts: torch.Tensor, dec: torch.Tensor, label: str) -> tuple[float, float]:
    """forward's full logits and make_prefill_step's last-position logits
    against the decode path's logits ``dec`` (B, T, V) at each prompt
    position; logs each and returns (worst excess, argmax agreement at bf16
    resolution) over the positions of both."""
    full, _ = model({"tokens": prompts})
    last = ts.make_prefill_step(model.cfg)(model, {"tokens": prompts})
    parts = {"forward": (full, dec), "prefill_step": (last, dec[:, -1:]),
             "both": (torch.cat([full, last], 1), torch.cat([dec, dec[:, -1:]], 1))}
    gaps = {}
    for what, (got, want) in parts.items():
        gaps[what] = excess, dmax, agree, tie = lm_bf16_gap(got, want)
        log(f"[lm_serve {elapsed():.1f}s] {label}: {what} vs decode over {got.shape[0]}x{got.shape[1]} "
            f"positions: worst |d| - {LM_BF16_TOL}|decode| = {excess:.4f} (bar {LM_BF16_TOL}; "
            f"{lm_over_bar(got, want)} positions over it), max |d| {dmax:.4f}; argmax agreement "
            f"{tie:.4f} at bf16 resolution, {agree:.4f} exact")
    excess, _, _, tie = gaps["both"]
    return excess, tie


def lm_check_a(model, prompts: torch.Tensor, dec: torch.Tensor, label: str) -> bool:
    """Check (a), dense families: forward and prefill_step against decode
    (``lm_gaps``) on the reference's bar, worst excess <= 0.15 and argmax
    agreement > 0.95 at bf16 resolution. moe, hybrid, ssm: the same gaps
    against the same bars (moe: the dense bar at capacity factor
    n_experts / top_k, where the forward drops nothing, as decode never
    does, with the default factor's gap beside it; hybrid and ssm:
    agreement > 0.9, the excess beside it) are logged as met or not and
    not asserted: at full width and bf16 these models amplify a rounding
    past them (the reference's own gap on full-width cuts:
    tests/test_torch_lm_witness.py). What is asserted for them is
    ``lm_block_forms`` here and ``lm_check_a_fp32``."""
    cfg = model.cfg
    if cfg.family in lm_transformer.DENSE_BODY:
        excess, tie = lm_gaps(model, prompts, dec, f"check (a) {label}")
        ok = excess <= LM_BF16_TOL and tie > LM_AGREE
        log(f"[lm_serve {elapsed():.1f}s] check (a) {label}: {'ok' if ok else 'FAILED'} "
            f"(bars: {LM_BF16_TOL}, agreement > {LM_AGREE})")
        return ok
    if cfg.family == "moe":
        lm_gaps(model, prompts, dec, f"{label} at capacity factor {cfg.capacity_factor} (default)")
        model.cfg = _no_drop(cfg)
        try:
            excess, tie = lm_gaps(model, prompts, dec, f"{label} at capacity factor "
                                                       f"{model.cfg.capacity_factor:.4f} (no drop)")
        finally:
            model.cfg = cfg
        met, bars = excess <= LM_BF16_TOL and tie > LM_AGREE, f"{LM_BF16_TOL}, agreement > {LM_AGREE}"
    else:
        excess, tie = lm_gaps(model, prompts, dec, label)
        met, bars = tie > LM_SSM_AGREE, f"agreement > {LM_SSM_AGREE}; excess {excess:.4f} beside it"
    log(f"[lm_serve {elapsed():.1f}s] {label} at bf16, the whole model's forward vs decode on the "
        f"family's bar ({bars}): {'met' if met else 'NOT MET'} (logged, not asserted)")
    return lm_block_forms(model, prompts, label)


def _no_drop(cfg):
    """``cfg`` at capacity factor n_experts / top_k: C >= the group size."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def lm_block_forms(model, prompts: torch.Tensor, label: str) -> bool:
    """Check (a), moe, hybrid, ssm, in addition to ``lm_check_a_fp32``:
    each routed or recurrent block kind of the served model (the first
    layer's: the MoE block at capacity factor n_experts / top_k; Mamba2;
    mLSTM and sLSTM), at full width on its weights, over the prompts'
    embeddings normed by the layer's norm: the full-sequence form against
    decode, one token at a time from the block's initial state. Bar: worst
    |d| - 0.15 |decode| <= 0.15 (the reference's rtol = atol)."""
    cfg, tree = model.cfg, model.tree
    B, dev = prompts.shape[0], prompts.device
    emb = lm_layers.embed(tree["embed"], prompts, cfg)
    if cfg.family == "moe":
        lp = tree["layers"][0]
        x = lm_layers.rmsnorm(lp["mlp_norm"], emb)
        blocks = {"moe": (lambda xs, st: (lm_moe.moe_block(lp["moe"], xs, _no_drop(cfg))[0], None),
                          lambda: None)}
    elif cfg.family == "hybrid":
        lp = tree["layers"][0][0]
        x = lm_layers.rmsnorm(lp["norm"], emb)
        blocks = {"mamba2": (lambda xs, st: lm_ssm.mamba2_block(lp["mamba"], xs, cfg, state=st),
                             lambda: lm_ssm.mamba2_state_init(cfg, B, device=dev))}
    else:
        lp, sp = tree["layers"][0][0], tree["slstm_layers"][0]
        x = lm_layers.rmsnorm(lp["norm"], emb)
        blocks = {"mlstm": (lambda xs, st: lm_xlstm.mlstm_block(lp["mlstm"], xs, cfg, state=st),
                            lambda: lm_xlstm.mlstm_state_init(cfg, B, device=dev)),
                  "slstm": (lambda xs, st: lm_xlstm.slstm_block(sp["slstm"], xs, cfg, state=st),
                            lambda: lm_xlstm.slstm_state_init(cfg, B, device=dev))}
    ok = True
    for name, (block, init) in blocks.items():
        full, _ = block(x, None)
        state, ys = init(), []
        for t in range(x.shape[1]):
            y, state = block(x[:, t : t + 1], state)
            ys.append(y)
        excess, dmax, _, _ = lm_bf16_gap(full, torch.cat(ys, 1))
        ok = ok and excess <= LM_BF16_TOL
        log(f"[lm_serve {elapsed():.1f}s] check (a) {label}: {name} block of layer 0, full sequence vs "
            f"decode over {B}x{x.shape[1]} tokens: worst |d| - {LM_BF16_TOL}|decode| = {excess:.4f} "
            f"(bar {LM_BF16_TOL}), max |d| {dmax:.4f} of max |y| {float(full.float().abs().max()):.4f}")
    log(f"[lm_serve {elapsed():.1f}s] check (a) {label}: {'ok' if ok else 'FAILED'} (block forms, bar {LM_BF16_TOL})")
    return ok


def lm_check_a_fp32(cfg, n_layers: int | None, label: str) -> bool:
    """Check (a), moe, hybrid, ssm, whole model: ``cfg`` at act fp32 from
    the serving model's seed, at full width on ``n_layers`` (None: full
    depth), through ``serve.build_model``: the forward's logits against
    decode's (``lm_trace``) at the LM_REQUESTS x LM_PROMPT prompt
    positions. moe: at capacity factor n_experts / top_k with every KV
    cache in fp32 (through the reference's bf16 caches a rounding moves a
    router logit across a near-tie), on the dense bar: worst excess <=
    0.15, argmax agreement > 0.95. hybrid: the reference's caches, the
    same bar. ssm: one group (deeper, an mLSTM stack at fp32 turns a
    summation-order difference into another argmax), agreement > 0.9 with
    the excess beside it."""
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    if n_layers is not None:
        cfg32 = lm_cut(cfg32, n_layers, "check (a) at act fp32")
    if cfg.family == "moe":
        cfg32 = _no_drop(cfg32)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = serve.build_model(cfg32, seed=0)
    prompts = serve.lm_prompts(cfg32, LM_REQUESTS, LM_PROMPT)
    t0 = time.perf_counter()
    full, _ = model({"tokens": prompts})
    _, dec = lm_trace(model, prompts, 0, fp32_caches=cfg.family == "moe")
    excess, dmax, agree, _ = lm_bf16_gap(full, dec)
    rel = dmax / float(dec.abs().max())
    if cfg.family == "ssm":
        ok, bars = agree > LM_SSM_AGREE, f"agreement > {LM_SSM_AGREE}"
    else:
        ok, bars = excess <= LM_BF16_TOL and agree > LM_AGREE, f"{LM_BF16_TOL}, agreement > {LM_AGREE}"
    log(f"[lm_serve {elapsed():.1f}s] check (a) {label} act fp32, {cfg32.n_layers} layers"
        f"{', capacity factor %.4f, KV caches in fp32' % cfg32.capacity_factor if cfg.family == 'moe' else ''}: "
        f"forward vs decode over {prompts.shape[0]}x{prompts.shape[1]} positions: worst |d| - "
        f"{LM_BF16_TOL}|decode| = {excess:.4f} ({lm_over_bar(full, dec)} positions over {LM_BF16_TOL}), "
        f"max |d| {dmax:.6f} = {rel:.3e} of max |logit|, argmax agreement {agree:.4f} in "
        f"{time.perf_counter() - t0:.2f}s; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB: "
        f"{'ok' if ok else 'FAILED'} (bars: {bars})")
    return ok


def lm_reference_init_gap(cfg, prompts: torch.Tensor) -> None:
    """Not a check: the same draw with the reference's fan-in (a stacked
    layer weight divided by √n_layers, not √d_in), to show what the port's
    init avoids. Logs the decode-vs-forward gap and the bf16 forward's gap
    to the fp32 forward."""
    defs = lm_transformer.model_defs(cfg)
    params = lm_base.init_params(torch.Generator(device="cuda").manual_seed(0), defs)

    def rescale(p, d):
        if isinstance(p, dict):
            return {k: rescale(p[k], d[k]) for k in p}
        return p * math.sqrt(lm_base.fan_in_of(d) / d.shape[0]) if d.init == "scaled" else p

    params = rescale(params, defs)
    bf = lm_transformer.Transformer(cfg, params)
    f32 = lm_transformer.Transformer(dataclasses.replace(cfg, act_dtype="float32"), params)
    _, dec = lm_trace(bf, prompts, 0)
    fwd, _ = bf({"tokens": prompts})
    truth, _ = f32({"tokens": prompts})
    for what, got, want in (("forward vs decode", fwd, dec), ("bf16 forward vs fp32 forward", fwd, truth)):
        excess, dmax, agree, tie = lm_bf16_gap(got, want)
        log(f"[lm_serve {elapsed():.1f}s] {cfg.name} under the reference's init (fan_in = n_layers), {what}: worst "
            f"|d| - {LM_BF16_TOL}|ref| = {excess:.4f}, max |d| {dmax:.4f}, argmax agreement {tie:.4f} "
            f"at bf16 resolution, {agree:.4f} exact (not a check)")


def lm_check_c(ids: torch.Tensor, vocab: int, label: str) -> bool:
    """Check (c): every generated id lies in [0, vocab)."""
    ok = bool(((ids >= 0) & (ids < vocab)).all())
    log(f"[lm_serve {elapsed():.1f}s] check (c) {label}: {ids.numel()} generated ids in [0, {vocab}): {ok}")
    return ok


def lm_profile(model, prompts: torch.Tensor, n_gen: int, step, label: str) -> None:
    """Where a decode step's time goes: ``serve.generate`` over a short
    prompt under torch.profiler (:func:`device_time`), with the device
    launches per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_steps = prompts.shape[1] + n_gen
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only: listing
        #   the host's events too takes the profiler ~2 s a step at ~4,000 launches
        t0 = time.perf_counter()
        serve.generate(model, prompts, n_gen, step)
        wall = 1e3 * (time.perf_counter() - t0)
    busy, per_kernel = device_time(prof)
    n_launch = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    log(f"[lm_serve {elapsed():.1f}s] {label} profiled: {n_steps} steps of batch {prompts.shape[0]} in {wall:.1f} ms, "
        f"device busy {busy:.1f} ms = {busy / wall:.3f} of wall, {n_launch / n_steps:.0f} device "
        f"launches per step")
    for name, ms in per_kernel[:5]:
        log(f"  device {ms:9.2f} ms  {name[:100]}")


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def lm_serve_run(cfg, n_gen: int, label: str, smi: str) -> tuple[object, torch.Tensor, torch.Tensor, bool]:
    """Build ``cfg``'s model from a seeded generator on the card and serve
    LM_REQUESTS prompts of LM_PROMPT tokens through ``serve.generate``
    (a short warm-up first; LM_PROFILE prompt and LM_PROFILE generated
    tokens profiled). Returns (model, prompts, the decode path's
    fp32 logits at the prompt positions, ok: ids reproduced by the same
    steps run again, and in range)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = serve.build_model(cfg, seed=0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompts = serve.lm_prompts(cfg, LM_REQUESTS, LM_PROMPT)
    step = ts.make_serve_step(cfg)
    _, w_pre, w_dec = serve.generate(model, prompts[:, :8], 4, step)
    ids, t_pre, t_dec = serve.generate(model, prompts, n_gen, step)
    B, T = prompts.shape
    state_bytes = sum(t.numel() * t.element_size()
                      for t in _tensors(lm_transformer.init_state(cfg, B, T + n_gen, device="meta")))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[lm_serve {elapsed():.1f}s] {label}: {n_params:,} params ({4 * n_params / 1e9:.3f} GB in fp32; "
        f"{param_bytes / 1e9:.3f} GB held for serving in {cfg.act_dtype}, fp32 where the reference "
        f"reads fp32), built in {t_build:.3f}s, build peak {build_peak:.3f} GiB; warm-up (8x8 prompt, "
        f"4 generated) {w_pre + w_dec:.3f}s")
    log(f"[lm_serve {elapsed():.1f}s] {label}: {B} requests x {T} prompt tokens, prefill by decode in {t_pre:.4f}s "
        f"({B * T / t_pre:.1f} prompt tok/s, {1e3 * t_pre / T:.3f} ms/step); decode {n_gen} steps in "
        f"{t_dec:.4f}s ({B * n_gen / t_dec:.1f} tok/s, {1e3 * t_dec / n_gen:.3f} ms/step); decode state "
        f"{state_bytes / 2**20:.1f} MiB; peak {peak:.3f} GiB; {smi}")
    lm_profile(model, prompts[:, :LM_PROFILE], LM_PROFILE, step, label)
    same, logits = lm_trace(model, prompts, n_gen)
    reproduced = torch.equal(same, ids)
    log(f"[lm_serve {elapsed():.1f}s] {label}: the same steps run again give the same {ids.numel()} ids: {reproduced}")
    ok = reproduced and lm_check_c(ids, cfg.vocab, label)
    return model, prompts, logits[:, :T], ok


def lm_check_b(cfg, label: str) -> bool:
    """Check (b): ``cfg`` at act_dtype float32 from the serving model's seed
    on the card and on the CPU (the card's weights copied), TF32 off:
    generated ids equal, logits within LM_FP32_REL of the largest."""
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    params = lm_base.init_params(torch.Generator(device="cuda").manual_seed(0),
                                 lm_transformer.model_defs(cfg32))
    card = lm_transformer.Transformer(cfg32, params)
    host = lm_transformer.Transformer(cfg32, lm_base.tree_map(lambda t: t.cpu(), params))
    del params
    prompts = serve.lm_prompts(cfg32, LM_CPU_BATCH, LM_CPU_PROMPT)
    t0 = time.perf_counter()
    ids_d, lg_d = lm_trace(card, prompts, LM_CPU_GEN)
    ids_h, lg_h = lm_trace(host, prompts.cpu(), LM_CPU_GEN)
    rel = float((lg_d.cpu() - lg_h).abs().max() / lg_h.abs().max())
    same = torch.equal(ids_d.cpu(), ids_h)
    ok = same and rel <= LM_FP32_REL
    log(f"[lm_serve {elapsed():.1f}s] check (b) {label} act fp32, card vs CPU (batch {LM_CPU_BATCH}, "
        f"{LM_CPU_PROMPT} prompt, {LM_CPU_GEN} generated; tf32 {torch.backends.cuda.matmul.allow_tf32}): "
        f"ids equal {same} {ids_h.tolist()}; max |d logit| / max |logit| {rel:.3e} (bar {LM_FP32_REL}) "
        f"in {time.perf_counter() - t0:.2f}s: {'ok' if ok else 'FAILED'}")
    return ok


def lm_cut(cfg, n_layers: int, what: str):
    """``cfg`` at full width on ``n_layers`` layers, on a printed
    "reduced" line."""
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    log(f"reduced: {cfg.name} n_layers {cfg.n_layers} -> {n_layers} for {what} (full width: d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, kv {cfg.n_kv_heads}, vocab {cfg.vocab})")
    return cut


def phase_lm_serve(smi: str) -> tuple[float, dict]:
    """The LM stack's serving path on the card, through ``launch.serve``'s
    functions (8 requests x 128 prompt tokens, greedy): qwen1.5-0.5b at
    full width and depth (64 generated) with checks (a)-(c), granite-34b
    at full width on 4 of its 88 layers, then the moe, hybrid and ssm
    families (``LM_FAMILY_RUNS``), each with (a), (c), the ids reproduced
    and (b) on a cut depth. The path launches none of the repo's kernels:
    the counts are set to 0 before it and must read 0 after. Returns the
    phase's seconds and the host syncs of one qwen decode step
    (:func:`decode_syncs`, for the contracts phase)."""
    log("== lm_serve: the LM stack's serving path at full width (dense, moe, hybrid, ssm)")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    ok = []
    with torch.inference_mode():
        cfg = lm_configs.get(LM_ARCH)
        model, prompts, dec, served = lm_serve_run(cfg, LM_GEN, cfg.name, smi)
        ok += [served, lm_check_a(model, prompts, dec, cfg.name)]
        dec_syncs = dict(decode_syncs(model, prompts), arch=cfg.name, batch=prompts.shape[0])
        log(f"[lm_serve {elapsed():.1f}s] {cfg.name}: one decode_step made {dec_syncs['syncs']} host syncs "
            "(held by the contracts phase)")
        del model
        lm_reference_init_gap(cfg, prompts)
        ok.append(lm_check_b(cfg, cfg.name))
        gcfg = lm_cut(lm_configs.get(LM_MQA_ARCH), LM_MQA_LAYERS, f"serving ({LM_MQA_GEN} generated; MQA, GELU)")
        model, prompts, dec, served = lm_serve_run(gcfg, LM_MQA_GEN, f"{gcfg.name} (4 layers)", smi)
        ok += [served, lm_check_a(model, prompts, dec, gcfg.name)]
        del model
        for arch, n_layers, n_gen, cut_a, cut_b in LM_FAMILY_RUNS:
            t1 = time.perf_counter()
            cfg = lm_configs.get(arch)
            label = cfg.name
            if n_layers is not None:
                cfg = lm_cut(cfg, n_layers, f"serving ({cfg.n_params_active[0] / 1e9:.1f} B parameters, "
                                            f"{2 * cfg.n_params_active[0] / 1e9:.1f} GB in bf16 whole)")
                label = f"{cfg.name} ({n_layers} layers)"
            model, prompts, dec, served = lm_serve_run(cfg, n_gen, label, smi)
            ok += [served, lm_check_a(model, prompts, dec, label)]
            del model, dec
            ok.append(lm_check_a_fp32(lm_configs.get(arch), cut_a, label))
            torch.cuda.empty_cache()
            ok.append(lm_check_b(lm_cut(lm_configs.get(arch), cut_b, "check (b)"), f"{arch} ({cut_b} layers)"))
            log(f"[lm_serve {elapsed():.1f}s] {label}: {time.perf_counter() - t1:.1f}s for the run and its checks")
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    log(f"[lm_serve {elapsed():.1f}s] launch counts of the repo's kernels {json.dumps(counts)}")
    assert not any(counts.values()), counts
    assert all(ok), ok
    return time.perf_counter() - t0, dec_syncs


# --------------------------------------------------------------------------
# lm_train: the LM stack's training path
# --------------------------------------------------------------------------

LM_TRAIN_SEQ = 4096  # train_4k's sequence length
LM_TRAIN_BATCH, LM_TRAIN_MICRO = 4, 2  # global batch in n_micro microbatches
LM_TRAIN_STEPS = 6  # steps on one fixed pipeline batch, check (a)
LM_TRAIN_LAYERS = 2  # checks (b)-(e): qwen at full width on this many layers
LM_TRAIN_CUT_B, LM_TRAIN_CUT_S = 2, 256  # their batch and sequence length
LM_TRAIN_LOSS_REL = 1e-6  # (b): |loss card - loss CPU| / |loss CPU| at each step (measured on an H100: 2.1e-7)
LM_TRAIN_GNORM_REL = 1e-6  # (b): the same for grad_norm (6.4e-8)
LM_TRAIN_LEAF_MAX = 2.5e-4  # (b): max |d| over every leaf after the steps (3.5e-5; an Adam
#   step moves a weight by about lr = 3e-4, and the sign of a near-zero gradient element
#   decides its direction, so 2 lr x steps bounds it)
LM_TRAIN_LEAF_SHARE = 0.995  # (b): share of each leaf's elements within 1 % of lr x steps
#   (smallest 0.99951)
LM_TRAIN_MICRO_GAP = 2e-5  # (c): max |g2 - g1| over max |g1|, each leaf (3.8e-6)
LM_TRAIN_RESUME_REL = 1e-5  # (d): the reference test's bound (tests/test_train.py)


def lm_train_setup(cfg, n_micro: int = 1, compress: bool = False, steps: int = LM_TRAIN_STEPS,
                   seed: int = 0):
    """``launch.train``'s objects for ``cfg``: the model from a seeded
    generator, the optimizer state, the step (the launcher's optimizer
    settings for ``steps`` steps)."""
    ocfg = lm_opt.OptConfig(total_steps=steps, warmup_steps=max(steps // 20, 1), compress_grads=compress)
    model = lm_train.build_model(cfg, seed=seed)
    state = lm_opt.init_opt_state(model.param_tree(), ocfg)
    return model, state, ts.make_train_step(cfg, ocfg, ts.StepConfig(n_micro=n_micro)), ocfg


def lm_train_batch(cfg, batch: int, seq: int) -> dict:
    """The pipeline's step-0 batch on the card."""
    pipe = lm_pipeline.TokenPipeline(cfg, lm_pipeline.PipelineConfig(seed=0, seq_len=seq, global_batch=batch))
    return lm_train.to_device(pipe.global_batch(0), "cuda")


def lm_train_profile(model, state, step, batch) -> tuple[float, float, int, list]:
    """One train step under torch.profiler (device events only): (wall ms,
    device busy ms, device launches, device ms by kernel name, largest
    first). Reads the profiler's raw events: the step makes tens of
    thousands of launches, and building its event tree takes longer than
    the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    per_kernel: dict[str, float] = {}
    n = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            per_kernel[e.name()] = per_kernel.get(e.name(), 0.0) + e.duration_ns() / 1e6
            n += 1
    return wall, sum(per_kernel.values()), n, sorted(per_kernel.items(), key=lambda kv: -kv[1])


def lm_train_full(smi: str) -> bool:
    """Check (a): qwen1.5-0.5b at full width and depth, bf16 activations
    over fp32 leaves, remat "full", train_4k's 4,096 tokens, a global batch
    of 4 in 2 microbatches (the chunked attention's 4 x 4 blocklist, the
    fp32 accumulator), LM_TRAIN_STEPS steps on one fixed pipeline batch:
    the loss finite and falling, grad_norm finite, lr equal to lr_at.
    Logs seconds per step after the first, tokens/s, model FLOP/s (6 N
    tokens/s, N = n_params_active) and its share of the dense bf16 peak,
    parameter and optimizer bytes, peak GiB, and a profiled step."""
    cfg = lm_configs.get(LM_ARCH)
    assert cfg.remat == "full" and cfg.act_dtype == "bfloat16", cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, state, step, ocfg = lm_train_setup(cfg, n_micro=LM_TRAIN_MICRO)
    batch = lm_train_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    p_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    o_bytes = sum(t.numel() * t.element_size() for t in _tensors([state.mu, state.nu]))
    losses, secs, ok = [], [], True
    for i in range(LM_TRAIN_STEPS):
        t1 = time.perf_counter()
        model, state, m = step(model, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        m = {k: float(v) for k, v in m.items()}
        want_lr = float(lm_opt.lr_at(state.step, ocfg))  # the step just taken, i + 1
        losses.append(m["total"])
        ok = ok and math.isfinite(m["total"]) and math.isfinite(m["grad_norm"]) and m["lr"] == want_lr
        log(f"[lm_train {elapsed():.1f}s] {cfg.name} step {i + 1}: loss {m['total']:.4f} gnorm "
            f"{m['grad_norm']:.4f} lr {m['lr']:.3e} (lr_at {want_lr:.3e}) in {secs[-1]:.3f}s")
    peak = torch.cuda.max_memory_allocated() / 2**30
    s_step = sum(secs[1:]) / len(secs[1:])
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    n_active = cfg.n_params_active[1]
    flops = 6 * n_active * tokens / s_step
    wall, busy, n_launch, per_kernel = lm_train_profile(model, state, step, batch)
    falls = losses[-1] < losses[0]
    ok = ok and falls
    log(f"[lm_train {elapsed():.1f}s] check (a) {cfg.name} {cfg.n_layers} layers, remat {cfg.remat}, act "
        f"{cfg.act_dtype} over fp32 leaves, batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens in {LM_TRAIN_MICRO} "
        f"microbatches: {n_params:,} params ({p_bytes / 1e9:.3f} GB fp32), optimizer state "
        f"{o_bytes / 1e9:.3f} GB, built in {t_build:.3f}s; first step {secs[0]:.3f}s, then {s_step:.4f} "
        f"s/step, {tokens / s_step:.1f} tokens/s, model FLOP/s 6 N tokens/s = {flops / 1e12:.2f} TFLOP/s "
        f"(N = {n_active:,}) = {flops / BF16_FLOP_PER_S:.4f} of the dense bf16 peak; peak {peak:.3f} GiB; "
        f"profiled step {wall:.1f} ms, device busy {busy:.1f} ms = {busy / wall:.3f}, {n_launch} device "
        f"launches; loss {losses[0]:.4f} -> {losses[-1]:.4f} falls {falls}: {'ok' if ok else 'FAILED'}; {smi}")
    for name, ms in per_kernel[:8]:
        log(f"  device {ms:9.2f} ms  {name[:100]}")
    return ok


def lm_leaf_gaps(got: list, want: list, moved: float) -> tuple[float, float]:
    """(max |got - want| over every leaf, the smallest share of a leaf's
    elements within 1 % of ``moved``)."""
    worst, share = 0.0, 1.0
    for a, b in zip(got, want):
        d = (a.detach().float().cpu() - b.detach().float().cpu()).abs()
        worst = max(worst, float(d.max()))
        share = min(share, float((d <= 0.01 * moved).float().mean()))
    return worst, share


def lm_train_card_vs_cpu(cfg) -> bool:
    """Check (b): ``cfg`` at act fp32, 2 train steps on the card and on
    the CPU from the same weights (the card's, copied) on the same batch:
    loss and grad_norm at each step, and every leaf after the steps."""
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    t0 = time.perf_counter()
    card, c_state, c_step, ocfg = lm_train_setup(cfg32, steps=2)
    host = lm_transformer.Transformer(
        cfg32, lm_base.tree_map(lambda t: t.detach().to("cpu", copy=True), card.param_tree()), trainable=True)
    h_state = lm_opt.init_opt_state(host.param_tree(), ocfg)
    h_step = ts.make_train_step(cfg32, ocfg, ts.StepConfig())
    batch = lm_train_batch(cfg32, LM_TRAIN_CUT_B, LM_TRAIN_CUT_S)
    hbatch = {k: v.cpu() for k, v in batch.items()}
    ok, rel = True, {"loss": 0.0, "grad_norm": 0.0}
    for _ in range(2):
        card, c_state, mc = c_step(card, c_state, batch)
        host, h_state, mh = h_step(host, h_state, hbatch)
        for k in rel:
            rel[k] = max(rel[k], abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k])))
    moved = ocfg.lr * 2
    worst, share = lm_leaf_gaps(lm_base.tree_leaves(card.param_tree()), lm_base.tree_leaves(host.param_tree()), moved)
    ok = (rel["loss"] <= LM_TRAIN_LOSS_REL and rel["grad_norm"] <= LM_TRAIN_GNORM_REL
          and worst <= LM_TRAIN_LEAF_MAX and share >= LM_TRAIN_LEAF_SHARE)
    log(f"[lm_train {elapsed():.1f}s] check (b) {cfg32.name} ({cfg32.n_layers} layers) act fp32, 2 steps card vs "
        f"CPU (batch {LM_TRAIN_CUT_B} x {LM_TRAIN_CUT_S}; tf32 {torch.backends.cuda.matmul.allow_tf32}): "
        f"loss rel {rel['loss']:.3e} (bar {LM_TRAIN_LOSS_REL}), grad_norm rel {rel['grad_norm']:.3e} (bar "
        f"{LM_TRAIN_GNORM_REL}), leaves max |d| {worst:.3e} (bar {LM_TRAIN_LEAF_MAX}; 2 lr x steps = "
        f"{2 * moved:.1e}), smallest "
        f"share within 1 % of lr x steps {share:.6f} (bar {LM_TRAIN_LEAF_SHARE}) in "
        f"{time.perf_counter() - t0:.2f}s: {'ok' if ok else 'FAILED'}")
    return ok


def lm_train_micro(cfg) -> bool:
    """Check (c): at act fp32 the n_micro = 2 gradient equals the n_micro
    = 1 gradient, each leaf within LM_TRAIN_MICRO_GAP of its max."""
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    model = lm_train.build_model(cfg32, seed=0)
    batch = lm_train_batch(cfg32, LM_TRAIN_CUT_B, LM_TRAIN_CUT_S)
    _, _, g1 = ts.make_grad_fn(cfg32, ts.StepConfig(n_micro=1))(model, batch)
    _, _, g2 = ts.make_grad_fn(cfg32, ts.StepConfig(n_micro=2))(model, batch)
    gap = max(float((b - a).abs().max() / a.abs().max().clamp(min=1e-30)) for a, b in zip(g1, g2))
    ok = gap <= LM_TRAIN_MICRO_GAP
    log(f"[lm_train {elapsed():.1f}s] check (c) {cfg32.name} ({cfg32.n_layers} layers) act fp32: n_micro 2 vs 1 "
        f"gradient, worst leaf max |d| / max |g| {gap:.3e} (bar {LM_TRAIN_MICRO_GAP}): {'ok' if ok else 'FAILED'}")
    return ok


def lm_train_resume(cfg) -> bool:
    """Check (d), bf16: 2 steps, ``checkpoint.save`` under build/,
    ``restore`` into freshly built objects, 2 more steps; the final loss
    against a straight 4-step run at LM_TRAIN_RESUME_REL (bit equality is
    logged: CUDA sums some gradients with atomics)."""
    path = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    batch = lm_train_batch(cfg, LM_TRAIN_CUT_B, LM_TRAIN_CUT_S)
    model, state, step, _ = lm_train_setup(cfg, steps=4)
    for _ in range(4):
        model, state, m = step(model, state, batch)
    straight = float(m["total"])
    model, state, step, _ = lm_train_setup(cfg, steps=4)
    for _ in range(2):
        model, state, _ = step(model, state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    saved = lm_ckpt.save(path, lm_ckpt.TrainState(model.param_tree(), state, 2, 2 * LM_TRAIN_CUT_B, 0))
    t_save = time.perf_counter() - t0
    n_bytes = sum(os.path.getsize(os.path.join(saved, f)) for f in os.listdir(saved))
    del model, state
    model, state, step, _ = lm_train_setup(cfg, steps=4, seed=1)  # fresh objects, other weights
    t0 = time.perf_counter()
    back = lm_ckpt.restore(path, lm_ckpt.TrainState(model.param_tree(), state, 0, 0, 0))
    model.load_param_tree(back.params)
    state = back.opt_state
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    for _ in range(2):
        model, state, m = step(model, state, batch)
    resumed = float(m["total"])
    rel = abs(resumed - straight) / abs(straight)
    ok = rel <= LM_TRAIN_RESUME_REL and back.step == 2 and int(state.step) == 4
    shutil.rmtree(path)
    log(f"[lm_train {elapsed():.1f}s] check (d) {cfg.name} ({cfg.n_layers} layers) {cfg.act_dtype}: resumed loss "
        f"{resumed!r} vs straight {straight!r}, rel {rel:.3e} (bar {LM_TRAIN_RESUME_REL}), bit-equal "
        f"{resumed == straight}; checkpoint {n_bytes:,} bytes, save {t_save:.3f}s, restore {t_restore:.3f}s: "
        f"{'ok' if ok else 'FAILED'}")
    return ok


def lm_train_compressed(cfg) -> bool:
    """Check (e): with int8 error-feedback compression 4 steps on the cut
    model, the loss falls."""
    model, state, step, _ = lm_train_setup(cfg, compress=True, steps=4)
    batch = lm_train_batch(cfg, LM_TRAIN_CUT_B, LM_TRAIN_CUT_S)
    losses = []
    for _ in range(4):
        model, state, m = step(model, state, batch)
        losses.append(float(m["total"]))
    ok = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    log(f"[lm_train {elapsed():.1f}s] check (e) {cfg.name} ({cfg.n_layers} layers) compressed gradients: "
        f"losses {[round(x, 4) for x in losses]}: {'ok' if ok else 'FAILED'}")
    return ok


def phase_lm_train(smi: str) -> float:
    """The LM stack's training path on the card through ``launch.train``'s
    functions, outside inference mode: check (a) qwen1.5-0.5b at full width
    and depth, then (b)-(e) on its cut to LM_TRAIN_LAYERS layers. The path
    launches none of the repo's kernels: the counts are set to 0 before it
    and must read 0 after. Returns the phase's seconds."""
    log("== lm_train: the LM stack's training path (qwen1.5-0.5b, AdamW, int8 error feedback, checkpoints)")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    ok = [lm_train_full(smi)]
    torch.cuda.empty_cache()
    cut = lm_cut(lm_configs.get(LM_ARCH), LM_TRAIN_LAYERS, "lm_train checks (b)-(e)")
    ok += [lm_train_card_vs_cpu(cut), lm_train_micro(cut), lm_train_resume(cut), lm_train_compressed(cut)]
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    log(f"[lm_train {elapsed():.1f}s] launch counts of the repo's kernels {json.dumps(counts)}")
    assert not any(counts.values()), counts
    assert all(ok), ok
    return time.perf_counter() - t0


LM_MESH_STEPS = 4  # check (a): steps through each path, taken in turns
LM_MESH_LOSS_REL = 1e-6  # (a): |loss mesh - loss single| / |loss single| at each step; on a
#   (1, 1) mesh the two paths make the same products in the same order
LM_MESH_GNORM_REL = 1e-6  # (a): the same for grad_norm
LM_MESH_BUDGET = "mesh_step[qwen1.5-0.5b, tp, (1, 1)]"  # (a): the step's collectives, port_budgets.json
LM_MESH_MOE_ARCH = "deepseek-moe-16b"  # check (b): its MoE block at full width
LM_MESH_MOE_B, LM_MESH_MOE_S = 4, 2048  # (b): tokens of one group (group_size 2048)
LM_MESH_EP_RANKS = 4  # (b): virtual ranks, 16 experts each
LM_MESH_EP_REL = 1e-5  # (b): max |sum of partials - local| / max |local| at fp32 (each token's
#   six choices are added per rank and the ranks' partials then, another order)


def lm_mesh_steps(mesh, smi: str) -> bool:
    """Check (a): lm_train's model and batch (qwen1.5-0.5b at full width
    and depth, bf16 over fp32 leaves, remat full, 4 x 4,096 tokens in 2
    microbatches), LM_MESH_STEPS steps through the mesh path
    (ShardedTransformer on ``mesh``, make_mesh_train_step, device_batch)
    and the same steps from a copy of the weights through the
    single-process path, the two taken in turns (mesh, single; single,
    mesh; ...): loss and grad_norm at each step, s/step of each after the
    first, the mesh path's collectives per step (each equal to the
    contract checker's LM_MESH_BUDGET), then one profiled step of each
    (device busy, launches, time by kernel)."""
    cfg = lm_configs.get(LM_ARCH)
    ocfg = lm_opt.OptConfig(total_steps=LM_TRAIN_STEPS, warmup_steps=max(LM_TRAIN_STEPS // 20, 1))
    scfg = ts.StepConfig(n_micro=LM_TRAIN_MICRO)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    single = lm_train.build_model(cfg, seed=0)
    sharded = lm_transformer.ShardedTransformer(cfg, single.param_tree(), mesh)  # a copy of each leaf
    pipe = lm_pipeline.TokenPipeline(cfg, lm_pipeline.PipelineConfig(seed=0, seq_len=LM_TRAIN_SEQ,
                                                                     global_batch=LM_TRAIN_BATCH))
    runs = {
        "mesh": [sharded, lm_opt.init_opt_state(sharded.param_tree(), ocfg),
                 ts.make_mesh_train_step(cfg, ocfg, scfg), pipe.device_batch(0, mesh)],
        "single": [single, lm_opt.init_opt_state(single.param_tree(), ocfg),
                   ts.make_train_step(cfg, ocfg, scfg), lm_train_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)],
    }
    metrics = {k: [] for k in runs}
    secs = {k: [] for k in runs}
    colls = []
    for i in range(LM_MESH_STEPS):
        for name in (("mesh", "single") if i % 2 == 0 else ("single", "mesh")):
            model, state, step_fn, batch = runs[name]
            lm_collectives.reset_collective_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, state, m = step_fn(model, state, batch)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
            runs[name][:2] = [model, state]
            metrics[name].append({k: float(v) for k, v in m.items()})
            if name == "mesh":
                colls.append(lm_collectives.collective_counts())
    peak = torch.cuda.max_memory_allocated() / 2**30
    mm, sm = metrics["mesh"], metrics["single"]
    budget = lint_budgets.port_budget(LM_MESH_BUDGET)
    ok, bit = all(c == budget for c in colls), True
    for i in range(LM_MESH_STEPS):
        rel_l = abs(mm[i]["total"] - sm[i]["total"]) / abs(sm[i]["total"])
        rel_g = abs(mm[i]["grad_norm"] - sm[i]["grad_norm"]) / abs(sm[i]["grad_norm"])
        ok = ok and rel_l <= LM_MESH_LOSS_REL and rel_g <= LM_MESH_GNORM_REL and math.isfinite(mm[i]["total"])
        bit = bit and mm[i]["total"] == sm[i]["total"] and mm[i]["grad_norm"] == sm[i]["grad_norm"]
        log(f"[lm_mesh {elapsed():.1f}s] check (a) step {i + 1}: mesh loss {mm[i]['total']!r} gnorm "
            f"{mm[i]['grad_norm']!r} in {secs['mesh'][i]:.4f}s; single loss {sm[i]['total']!r} gnorm "
            f"{sm[i]['grad_norm']!r} in {secs['single'][i]:.4f}s; loss rel {rel_l:.3e} (bar {LM_MESH_LOSS_REL}), "
            f"grad_norm rel {rel_g:.3e} (bar {LM_MESH_GNORM_REL}); mesh collectives {json.dumps(colls[i])}")
    s_step = {k: sum(v[1:]) / len(v[1:]) for k, v in secs.items()}
    log(f"[lm_mesh {elapsed():.1f}s] check (a) {cfg.name} {cfg.n_layers} layers on a (1, 1) (data, model) mesh, "
        f"LOGICAL_RULES, batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} in {LM_TRAIN_MICRO} microbatches: s/step after "
        f"the first: mesh {s_step['mesh']:.4f}, single {s_step['single']:.4f}; collectives per step "
        f"{json.dumps(colls[-1])} (budget {json.dumps(budget)}, every step equal "
        f"{all(c == budget for c in colls)}); bit-equal {bit}; peak {peak:.3f} GiB: {'ok' if ok else 'FAILED'}; "
        f"{smi}")
    for name, (model, state, step_fn, batch) in runs.items():
        wall, busy, n_launch, per_kernel = lm_train_profile(model, state, step_fn, batch)
        log(f"[lm_mesh {elapsed():.1f}s] profiled {name} step: {wall:.1f} ms, device busy {busy:.1f} ms = "
            f"{busy / wall:.3f}, {n_launch} device launches")
        for kname, ms in per_kernel[:6]:
            log(f"  device {ms:9.2f} ms  {kname[:100]}")
    return ok


def lm_mesh_ep(mesh) -> bool:
    """Check (b): deepseek-moe-16b's MoE block at full width on the card.
    At fp32 (weights from a seeded generator), the expert-parallel
    dispatch of LM_MESH_EP_RANKS virtual ranks (each its slice of the
    experts, e_offset 0, 16, 32, 48) summed, plus the shared experts,
    against the local dispatch; then, the weights in bf16, moe_block under
    the (1, 1) mesh (the expert-parallel branch: one all-reduce over
    "model", the aux loss averaged over "data") against the local path,
    bit for bit."""
    cfg = lm_configs.get(LM_MESH_MOE_ARCH)
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm_base.init_params(gen, lm_moe.moe_defs(cfg32), torch.float32)
    x = torch.randn((LM_MESH_MOE_B, LM_MESH_MOE_S, cfg.d_model), generator=gen, device="cuda")
    n_local = cfg.n_experts // LM_MESH_EP_RANKS
    with torch.no_grad():
        t0 = time.perf_counter()
        want, aux = lm_moe._dispatch_group(params, x, cfg32)
        torch.cuda.synchronize()
        t_local = time.perf_counter() - t0
        total = lm_layers.mlp(params["shared"], x, "swiglu")
        same_aux = True  # routing is computed in full on every rank
        t0 = time.perf_counter()
        for r in range(LM_MESH_EP_RANKS):
            off = r * n_local
            sl = {"router": params["router"], **{k: params[k][off : off + n_local] for k in ("gate", "up", "down")}}
            part, aux_r = lm_moe._dispatch_group_ep(sl, x, cfg32, off, n_local)
            total = total + part
            same_aux = same_aux and torch.equal(aux_r, aux)
        torch.cuda.synchronize()
        t_ep = time.perf_counter() - t0
        rel = float((total - want).abs().max() / want.abs().max())
        routed_bytes = sum(params[k].numel() for k in ("gate", "up", "down")) * 2
        p16 = lm_base.tree_map(lambda t: t.to(torch.bfloat16), params)
        del params
        x16 = x.to(torch.bfloat16)
        y_local, a_local = lm_moe.moe_block(p16, x16, cfg)
        lm_collectives.reset_collective_counts()
        with lm_base.use_mesh(mesh):
            y_mesh, a_mesh = lm_moe.moe_block(p16, x16, cfg)
        colls = lm_collectives.collective_counts()
        bit = torch.equal(y_mesh, y_local) and torch.equal(a_mesh, a_local)
    ok = rel <= LM_MESH_EP_REL and same_aux and bit and colls["all_reduce"] == 2
    log(f"[lm_mesh {elapsed():.1f}s] check (b) {cfg.name} MoE block at full width (d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, {cfg.n_shared_experts} shared, expert d_ff {cfg.d_ff_expert}; "
        f"routed weights {routed_bytes / 1e9:.3f} GB in bf16), {LM_MESH_MOE_B} x {LM_MESH_MOE_S} tokens: fp32 sum "
        f"of {LM_MESH_EP_RANKS} ranks' partials vs _dispatch_group max |d| / max |y| {rel:.3e} (bar "
        f"{LM_MESH_EP_REL}; aux equal {same_aux}; local {t_local:.4f}s, partials {t_ep:.4f}s); bf16 moe_block under the (1, 1) mesh "
        f"equal to the local path bit for bit: {bit} (collectives {json.dumps(colls)}): {'ok' if ok else 'FAILED'}")
    return ok


LM_MESH_VIRTUAL = (2, 4)  # check (c): virtual "model" ranks
LM_MESH_VIRTUAL_B, LM_MESH_VIRTUAL_S = 2, 2048  # (c): tokens of the layer and the loss
LM_MESH_VIRTUAL_REL = 1e-5  # (c): at fp32, max |split - whole| / max |whole| of the layer's output
#   and |loss split - loss whole| / loss whole: the row splits (wo, down) add the ranks' partial
#   sums (K / m terms each) in another order than one product of K terms, and the split
#   log-sum-exp sums the ranks' sums of exp; a few ulps of the outputs' scale


def lm_mesh_virtual(cfg=None, device: str = "cuda") -> bool:
    """Check (c): the "tp" split of qwen1.5-0.5b at full width, computed as
    m virtual "model" ranks for each m of LM_MESH_VIRTUAL (no collective:
    each rank's share from its own column and row slices, ``Split(m, r,
    [])`` and ``attention.head_split``, the partials summed in rank order):
    the embedding by vocabulary row (the rows a rank does not own read
    zeros), one attention + MLP layer (its heads and rows of wo, its
    columns of gate/up and rows of down), and the vocabulary-parallel loss
    (each rank's columns of the tied logits; the max over the ranks, Σ exp
    and the label's logit summed: collectives.vocab_terms / vocab_lse), held
    against the whole layer and the whole loss (train_step.cross_entropy)
    on the same seeded weights and tokens; at fp32 within
    LM_MESH_VIRTUAL_REL, at bf16 the gaps logged."""
    from repro_torch.models import attention as lm_attention

    cfg = cfg or lm_configs.get(LM_ARCH)
    gen = torch.Generator(device=device).manual_seed(0)
    defs = {"layer": lm_transformer._attn_layer_defs(cfg), "embed": lm_layers.embed_defs(cfg),
            "final_norm": lm_layers.rmsnorm_defs(cfg.d_model)}
    params = lm_base.init_params(gen, defs, torch.float32)
    lp, emb = params["layer"], params["embed"]
    B, S, V = LM_MESH_VIRTUAL_B, LM_MESH_VIRTUAL_S, cfg.vocab
    tokens = torch.randint(0, V, (B, S), generator=gen, device=device)
    labels = torch.where(torch.rand((B, S), generator=gen, device=device) < 0.1, -1, tokens.roll(-1, 1))
    positions = torch.arange(S, device=device)[None, :].expand(B, S)
    ok = True
    for act in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, act_dtype=act)
        dt = lm_layers.act_dt(c)
        with torch.no_grad():
            h = lm_layers.embed(emb, tokens, c)
            h1 = h + lm_attention.attention_share(lp["attn"], lm_layers.rmsnorm(lp["attn_norm"], h), c, positions)
            y = h1 + lm_layers.mlp(lp["mlp"], lm_layers.rmsnorm(lp["mlp_norm"], h1), c.mlp_kind)
            logits = lm_layers.unembed(emb, lm_layers.rmsnorm(params["final_norm"], y), c)
            loss = float(ts.cross_entropy(logits, labels, True)[0])
            del logits
            for m in LM_MESH_VIRTUAL:
                sps = [lm_collectives.Split(m, r, []) for r in range(m)]
                he = torch.zeros_like(h)
                for sp in sps:  # the embedding: each rank's vocabulary rows, the others' tokens read 0
                    he = he + lm_layers.embed_share(emb, tokens, c, sp)
                xa = lm_layers.rmsnorm(lp["attn_norm"], he)
                a = torch.zeros_like(he)
                for sp in sps:
                    hs = lm_attention.head_split(c, m, sp.rank)
                    a = a + lm_attention.attention_share(lp["attn"], xa, c, positions, sp, hs)
                g1 = he + a
                xm = lm_layers.rmsnorm(lp["mlp_norm"], g1)
                f = torch.zeros_like(g1)
                for sp in sps:
                    f = f + lm_layers.mlp_share(lp["mlp"], xm, c.mlp_kind, sp, c.d_ff)
                ys = g1 + f
                xf = lm_layers.rmsnorm(params["final_norm"], ys)
                lab, mask = labels[:, 1:], labels[:, 1:] >= 0
                parts = [(xf[:, :-1] @ sp.block(emb["tokens"], 0, V).to(dt).T).float() for sp in sps]
                mx = parts[0].amax(-1)
                for lg in parts[1:]:
                    mx = torch.maximum(mx, lg.amax(-1))
                tot_s, tot_ll = None, None
                for sp, lg in zip(sps, parts):
                    s_r, ll_r, _, _ = lm_collectives.vocab_terms(lg, lab, sp.span(V)[0], mx)
                    tot_s = s_r if tot_s is None else tot_s + s_r
                    tot_ll = ll_r if tot_ll is None else tot_ll + ll_r
                del parts
                nll = (lm_collectives.vocab_lse(tot_s, mx) - tot_ll) * mask
                loss_s = float(nll.sum() / mask.sum().clamp(min=1))
                emb_eq = torch.equal(he, h)
                rel_y = float((ys.float() - y.float()).abs().max() / y.float().abs().max())
                rel_l = abs(loss_s - loss) / abs(loss)
                held = act == "float32"
                ok_m = emb_eq and rel_y <= LM_MESH_VIRTUAL_REL and rel_l <= LM_MESH_VIRTUAL_REL
                ok = ok and (ok_m or not held)
                log(f"[lm_mesh {elapsed():.1f}s] check (c) {c.name} at {act}, {m} virtual model ranks "
                    f"({c.n_heads // m} heads, {c.d_ff // m} FFN columns, {V // m} vocabulary rows a rank; "
                    f"{B} x {S} tokens): embedding equal {emb_eq}; layer output max |split - whole| / max |whole| "
                    f"{rel_y:.3e}; loss {loss_s!r} vs whole {loss!r}, rel {rel_l:.3e}"
                    + (f" (bar {LM_MESH_VIRTUAL_REL}): {'ok' if ok_m else 'FAILED'}" if held else " (logged)"))
    return ok


class VirtualModelAxis:
    """m virtual "model" ranks as threads of this process, standing in for
    ``torch.distributed`` inside ``repro_torch.models.collectives`` (its
    module attribute ``dist`` swapped for this object while ``run`` runs):
    every collective the blocks make (``copy_to``'s and ``reduce_sum``'s
    all-reduces, ``gather_last``, ``scatter_last``) is exchanged through
    a barrier, each rank's tensor read in place and the sum taken in rank
    order. The threads launch on one stream, so a rank's reads of another
    rank's tensor run after the kernels that wrote it."""

    def __init__(self, m: int):
        self.m, self.slots = m, [None] * m
        self.barrier = threading.Barrier(m)
        self.local = threading.local()

    def get_world_size(self, group=None) -> int:
        return self.m

    def get_rank(self, group=None) -> int:
        return self.local.rank

    def _each(self, t: torch.Tensor) -> list:
        self.slots[self.local.rank] = t
        self.barrier.wait()
        return list(self.slots)

    @staticmethod
    def _total(parts: list) -> torch.Tensor:
        out = parts[0].clone()
        for t in parts[1:]:
            out = out + t
        return out

    def all_reduce(self, x, op=None, group=None) -> None:  # SUM: the mixers make no other
        total = self._total(self._each(x))
        self.barrier.wait()
        x.copy_(total)

    def all_gather_into_tensor(self, out, x, group=None) -> None:
        out.copy_(torch.cat([t.reshape(-1) for t in self._each(x)]))
        self.barrier.wait()

    def reduce_scatter_tensor(self, out, x, group=None) -> None:
        r = self.local.rank
        out.copy_(self._total([t.view(self.m, -1)[r] for t in self._each(x)]).view_as(out))
        self.barrier.wait()

    def run(self, fn) -> list:
        """``fn(split)`` on every virtual rank (``collectives.Split(m, r,
        [group])``, no autograd), in m threads; the ranks' results."""
        out, errs = [None] * self.m, []

        def rank(r: int) -> None:
            self.local.rank = r
            try:
                with torch.no_grad():
                    out[r] = fn(lm_collectives.Split(self.m, r, [self]))
            except BaseException as e:  # noqa: BLE001 - re-raised below, after every thread ends
                errs.append(e)
                self.barrier.abort()

        real = lm_collectives.dist
        lm_collectives.dist = self
        try:
            threads = [threading.Thread(target=rank, args=(r,)) for r in range(self.m)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            lm_collectives.dist = real
        if errs:
            raise errs[0]
        return out


LM_MESH_MIXERS = (("zamba2-2.7b", "mamba"), ("xlstm-1.3b", "mlstm"), ("xlstm-1.3b", "slstm"))
LM_MESH_MIXER_RANKS = (2, 4, 16)  # check (c): virtual "model" ranks of each mixer layer; 16 is
#   the production mesh's (xlstm's 4 heads on 16 ranks: a quarter of a head's value columns)
LM_MESH_MIXER_S = {"mamba": 2048, "mlstm": 2048, "slstm": 256}  # (c): tokens a row (sLSTM steps
#   token by token: 256 of them keep its loop of 16 threads to a few seconds)
LM_MESH_MIXER_REL = 1e-5  # (c): at fp32, max |sum of partials - whole| / max |whole| of a
#   mixer layer's output, as qwen's layer (LM_MESH_VIRTUAL_REL) ...
LM_MESH_MIXER_NOISE, LM_MESH_MIXER_TIMES = 1e-7, 10.0  # ... or, where larger, ten times the whole
#   layer's own response to its input scaled by 1 + 1e-7 N(0, 1) (a rounding of fp32): the
#   split moves the inputs of the recurrences by fp32 roundings (the column blocks' products, the
#   ranks' partial sums), and the mLSTM's normaliser max(|q . n|, 1e-6) amplifies them (reduced
#   xlstm on a CPU, lm_mesh_mixers(..., device="cpu"): a response of 3.3e-5, split gaps of 1e-5)


def lm_mesh_mixers(cfgs: dict | None = None, device: str = "cuda", ranks=LM_MESH_MIXER_RANKS,
                   seqs: dict | None = None) -> bool:
    """Check (c) for the Mamba2 and xLSTM mixers: one full-width Mamba2
    layer of zamba2-2.7b and one mLSTM and one sLSTM layer of xlstm-1.3b,
    each computed as m virtual "model" ranks for each m of ``ranks``
    (``VirtualModelAxis``: each rank's ``ssm.mamba2_share`` /
    ``xlstm.mlstm_share`` / ``xlstm.slstm_share`` with the collectives
    between its stages exchanged among the threads, the partial outputs
    summed in rank order), against the whole layer (the same function
    without a split) on the same seeded weights and inputs; at fp32
    within LM_MESH_MIXER_REL or ten times the whole layer's response to
    a rounding-sized perturbation of its input, at bf16 the gaps logged."""
    seqs = seqs or LM_MESH_MIXER_S
    shares = {"mamba": (lm_ssm.mamba2_defs, lm_ssm.mamba2_share),
              "mlstm": (lm_xlstm.mlstm_defs, lm_xlstm.mlstm_share),
              "slstm": (lm_xlstm.slstm_defs, lm_xlstm.slstm_share)}
    ok = True
    for arch, kind in LM_MESH_MIXERS:
        cfg = (cfgs or {}).get(arch) or lm_configs.get(arch)
        defs_of, share = shares[kind]
        gen = torch.Generator(device=device).manual_seed(0)
        params = lm_base.init_params(gen, defs_of(cfg), torch.float32)
        x = torch.randn((LM_MESH_VIRTUAL_B, seqs[kind], cfg.d_model), generator=gen, device=device)
        for act in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, act_dtype=act)
            xa = x.to(lm_layers.act_dt(c))
            with torch.no_grad():
                t0 = time.perf_counter()
                want = share(params, xa, c)[0].float()
                t_whole = time.perf_counter() - t0
                held = act == "float32"
                response = 0.0
                if held:
                    noisy = xa * (1 + LM_MESH_MIXER_NOISE * torch.randn(xa.shape, generator=gen, device=device))
                    response = float((share(params, noisy, c)[0] - want).abs().max() / want.abs().max())
            bar = max(LM_MESH_MIXER_REL, LM_MESH_MIXER_TIMES * response)
            for m in ranks:
                axis = VirtualModelAxis(m)
                t0 = time.perf_counter()
                parts = axis.run(lambda sp: share(params, xa, c, sp)[0])
                got = parts[0].float()
                for p in parts[1:]:
                    got = got + p.float()
                secs = time.perf_counter() - t0
                rel = float((got - want).abs().max() / want.abs().max())
                ok_m = rel <= bar and bool(torch.isfinite(got).all())
                ok = ok and (ok_m or not held)
                log(f"[lm_mesh {elapsed():.1f}s] check (c) {cfg.name} {kind} layer at {act}, {m} virtual model "
                    f"ranks ({LM_MESH_VIRTUAL_B} x {seqs[kind]} tokens, whole {t_whole:.3f}s, split {secs:.3f}s): "
                    f"max |split - whole| / max |whole| {rel:.3e}"
                    + (f"; the whole layer's response to a {LM_MESH_MIXER_NOISE} perturbation of its input "
                       f"{response:.3e} (bar {bar:.3e}): {'ok' if ok_m else 'FAILED'}" if held else " (logged)"))
        del params, x
    return ok


def phase_lm_mesh(smi: str) -> float:
    """The mesh layer on the card in an NCCL world of 1 rank (file
    rendezvous in a temporary directory, destroyed in a finally): checks
    (a) and (b) on a (1, 1) ("data", "model") mesh, (c) the "tp" split
    of qwen's layer as 2 and 4 virtual ranks and of the Mamba2, mLSTM and
    sLSTM layers as 2, 4 and 16 (``lm_mesh_mixers``), then (d) the repo's
    kernels launched 0 times. Returns the phase's seconds."""
    import torch.distributed as dist

    log("== lm_mesh: the mesh layer (DP x TP step, expert-parallel MoE) in an NCCL world of 1")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv", world_size=1, rank=0,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = lm_mesh_lib.make_mesh((1, 1), ("data", "model"), "cuda")
            ok = [lm_mesh_steps(mesh, smi)]
            torch.cuda.empty_cache()
            ok.append(lm_mesh_ep(mesh))
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    ok.append(lm_mesh_virtual())
    torch.cuda.empty_cache()
    ok.append(lm_mesh_mixers())
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    log(f"[lm_mesh {elapsed():.1f}s] check (d) launch counts of the repo's kernels {json.dumps(counts)} "
        "(the mesh path runs none of the five)")
    assert not any(counts.values()), counts
    assert all(ok), ok
    return time.perf_counter() - t0


LM_DRYRUN_PEAK_REL = 0.05  # (a): |predicted peak - card peak| / card peak; the dry run sees no
#   allocator rounding and no library workspace (cuBLAS's ~32 MiB), nor a kernel's own scratch
LM_DRYRUN_OPT_ARCHS = ("qwen1.5-0.5b", "deepseek-moe-16b")  # (b): dryrun_opt's train_4k cells
LM_DRYRUN_TIMEOUT_S = 300  # each dry-run subprocess
# (b): dryrun_opt's train_4k records on (16, 16) under whole-leaf gathering (the tree before the
#   mesh step gathered layer by layer; python -m repro_torch.launch.dryrun_opt --shape train_4k
#   --single-pod): peak bytes, and the split at the peak in bytes
# (b): the "tp" cells' per-rank FLOPs and useful_flops_ratio when every "model" rank computed
#   each block whole (the tree before the "tp" split; python -m repro_torch.launch.dryrun_opt
#   --shape train_4k --single-pod on the CPU)
LM_DRYRUN_UNSPLIT = {"deepseek-moe-16b": (789316204756992.0, 0.14448489201586706)}
LM_DRYRUN_WHOLE_LEAF = {
    "qwen1.5-0.5b": (14254430740, {"parameters": 7743488, "optimizer": 15486980, "inputs": 32768,
                                   "activations": 4276304404, "gradients": 0, "temporaries": 9954863100}),
    "deepseek-moe-16b": (166872072244, {"parameters": 257165312, "optimizer": 514330628, "inputs": 524288,
                                        "activations": 44, "gradients": 335022084,
                                        "temporaries": 165765029888}),
}


def lm_dryrun_card_step() -> dict:
    """Check (a)'s card side: lm_train's model and batch through the mesh
    step on a (1, 1) mesh in an NCCL world of 1 (file rendezvous in a
    temporary directory, destroyed in a finally). One step to warm up,
    then, after ``reset_peak_memory_stats``, one step under
    ``FlopCounterMode``: its FLOPs, the peak over what was allocated before
    the model was built, and its collectives."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    cfg = lm_configs.get(LM_ARCH)
    ocfg = lm_opt.OptConfig(total_steps=LM_TRAIN_STEPS, warmup_steps=max(LM_TRAIN_STEPS // 20, 1))
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rdzv", world_size=1, rank=0,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = lm_mesh_lib.make_mesh((1, 1), ("data", "model"), "cuda")
            model = lm_train.build_model(cfg, seed=0, mesh=mesh)
            state = lm_opt.init_opt_state(model.param_tree(), ocfg)
            pipe = lm_pipeline.TokenPipeline(cfg, lm_pipeline.PipelineConfig(seed=0, seq_len=LM_TRAIN_SEQ,
                                                                             global_batch=LM_TRAIN_BATCH))
            batch = pipe.device_batch(0, mesh)
            step = ts.make_mesh_train_step(cfg, ocfg, ts.StepConfig(n_micro=LM_TRAIN_MICRO))
            model, state, _ = step(model, state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() - before
            lm_collectives.reset_collective_counts()
            t0 = time.perf_counter()
            with FlopCounterMode(display=False) as fc:
                model, state, m = step(model, state, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            out = {"flops": float(fc.get_total_flops()), "peak": torch.cuda.max_memory_allocated() - before,
                   "held": held, "colls": lm_collectives.collective_counts(), "loss": float(m["total"]),
                   "s": secs}
            del model, state, batch, m
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def _dryrun_records(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_lm_dryrun(smi: str) -> float:
    """The dry run (launch.dryrun, launch.dryrun_opt) against the card. Two
    subprocesses, started first and run beside the card step (so that no
    fake world meets this process's NCCL state): (a) the dry run of
    lm_train's cell (qwen1.5-0.5b at full width and depth, 4 x 4,096
    tokens in 2 microbatches, remat full, bf16 over fp32 leaves) on a
    (1, 1) mesh, and (b) dryrun_opt's train_4k cells of LM_DRYRUN_OPT_ARCHS
    on the single-pod (16, 16) mesh (deepseek: the expert-parallel branch
    under remat full). (a) holds the dry run's FLOPs equal to
    FlopCounterMode's on the card's step, its collective counts to the
    card's and the contract checker's LM_MESH_BUDGET, and its peak within
    LM_DRYRUN_PEAK_REL of the card's; (b) prints each record's per-rank
    FLOPs, peak and split beside LM_DRYRUN_WHOLE_LEAF's, fit, bottleneck
    and mfu_bound (predictions from the H100 SXM's data-sheet constants);
    (c) the repo's kernels launched 0 times.
    Returns the phase's seconds."""
    log("== lm_dryrun: the dry run on meta in a fake world, against the card")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    with tempfile.TemporaryDirectory() as tmp:
        cmds = {
            "card": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", LM_ARCH, "--shape", "train_4k",
                     "--mesh-shape", "1,1", "--global-batch", str(LM_TRAIN_BATCH), "--n-micro",
                     str(LM_TRAIN_MICRO), "--out", os.path.join(tmp, "card.jsonl")],
            "opt": [sys.executable, "-m", "repro_torch.launch.dryrun_opt", "--arch", *LM_DRYRUN_OPT_ARCHS,
                    "--shape", "train_4k", "--single-pod", "--out", os.path.join(tmp, "opt.jsonl")],
        }
        logs = {k: open(os.path.join(tmp, f"{k}.log"), "w") for k in cmds}
        procs = {k: subprocess.Popen(c, env=env, cwd=tmp, stdout=logs[k], stderr=subprocess.STDOUT)
                 for k, c in cmds.items()}
        try:
            card = lm_dryrun_card_step()
            rcs = {k: p.wait(LM_DRYRUN_TIMEOUT_S) for k, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait(10)
            for f in logs.values():
                f.close()
        for k, rc in rcs.items():
            if rc:
                log(open(os.path.join(tmp, f"{k}.log")).read()[-4000:])
        assert not any(rcs.values()), rcs
        (pred,) = _dryrun_records(os.path.join(tmp, "card.jsonl"))
        prod = _dryrun_records(os.path.join(tmp, "opt.jsonl"))
    assert "error" not in pred, pred.get("traceback")
    gap = (pred["memory"]["peak_bytes"] - card["peak"]) / card["peak"]
    budget = lint_budgets.port_budget(LM_MESH_BUDGET)
    ok_a = (pred["flops_per_device"] == card["flops"] and pred["coll_counts"] == card["colls"] == budget
            and abs(gap) <= LM_DRYRUN_PEAK_REL)
    log(f"[lm_dryrun {elapsed():.1f}s] check (a) {LM_ARCH} {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens in "
        f"{LM_TRAIN_MICRO} microbatches on a (1, 1) mesh: FLOPs dry run {pred['flops_per_device']!r} vs card "
        f"FlopCounterMode {card['flops']!r} (equal {pred['flops_per_device'] == card['flops']}); collectives dry "
        f"run {json.dumps(pred['coll_counts'])} vs card {json.dumps(card['colls'])} vs budget {json.dumps(budget)}; "
        f"peak dry run "
        f"{pred['memory']['peak_bytes'] / 2**30:.3f} GiB vs card max_memory_allocated {card['peak'] / 2**30:.3f} GiB "
        f"(over what was allocated before; held at the step's start {card['held'] / 2**30:.3f} GiB vs arguments "
        f"{pred['memory']['argument_bytes'] / 2**30:.3f} GiB): gap {gap:+.4f} (bar {LM_DRYRUN_PEAK_REL}); split "
        f"{json.dumps({k: round(v / 2**30, 3) for k, v in pred['memory']['split'].items()})} GiB; dry run built in "
        f"{pred['build_s']}s, step {pred['step_s']}s; card step {card['s']:.3f}s under FlopCounterMode, loss "
        f"{card['loss']:.4f}: {'ok' if ok_a else 'FAILED'}; {smi}")
    ok_b = len(prod) == len(LM_DRYRUN_OPT_ARCHS)
    for rec in prod:
        ok_b = ok_b and "error" not in rec and math.isfinite(rec.get("mfu_bound") or float("nan"))
        if "error" in rec:
            log(f"[lm_dryrun {elapsed():.1f}s] check (b) {rec['arch']}: ERROR {rec['error']}\n{rec['traceback']}")
            continue
        log(f"[lm_dryrun {elapsed():.1f}s] check (b) {rec['arch']} train_4k on the single-pod {rec['mesh_shape']} "
            f"mesh, {json.dumps(rec['opt'])}, n_micro {rec['n_micro']}, {rec['rows_per_rank']} rows a rank: "
            f"flops_per_device {rec['flops_per_device']:.4e}, peak_bytes {rec['memory']['peak_bytes']:.4e} "
            f"(fits {rec['fits']}), coll {json.dumps(rec['coll_counts'])} {rec['coll_bytes_per_device']:.4e} B, "
            f"dot traffic {rec['dot_traffic_per_device']:.4e} B, bottleneck {rec['roofline']['bottleneck']}, "
            f"useful_flops_ratio {rec['useful_flops_ratio']:.4f}, mfu_bound {rec['mfu_bound']:.4f} (H100 SXM "
            f"data-sheet constants, predictions); built {rec['build_s']}s, step {rec['step_s']}s")
        if rec["profile"] == "tp" and rec["arch"] in LM_DRYRUN_UNSPLIT:
            was_flops, was_ratio = LM_DRYRUN_UNSPLIT[rec["arch"]]
            log(f"  tp split: flops_per_device {rec['flops_per_device']:.6e} (every block whole on every model rank "
                f"{was_flops:.6e}, x {was_flops / rec['flops_per_device']:.3f}), useful_flops_ratio "
                f"{rec['useful_flops_ratio']:.4f} (whole {was_ratio:.4f}); gathered projections "
                f"{rec['gathered_projections']}")
        was_peak, was_split = LM_DRYRUN_WHOLE_LEAF[rec["arch"]]
        log(f"  peak {rec['memory']['peak_bytes'] / 1e9:.1f} GB (whole-leaf gathering {was_peak / 1e9:.1f} GB); split "
            f"{json.dumps({k: round(v / 2**30, 3) for k, v in rec['memory']['split'].items()})} GiB (whole-leaf "
            f"gathering {json.dumps({k: round(v / 2**30, 3) for k, v in was_split.items()})} GiB); roofline "
            f"{json.dumps({k: v for k, v in rec['roofline'].items() if k != 'bottleneck'})}")
    counts = ops.launch_counts()
    log(f"[lm_dryrun {elapsed():.1f}s] check (c) launch counts of the repo's kernels {json.dumps(counts)} "
        "(the dry run's path runs none of the five)")
    assert not any(counts.values()), counts
    assert ok_a and ok_b, (ok_a, ok_b)
    return time.perf_counter() - t0


# --------------------------------------------------------------------------
# contracts: the port's contract checker, and host syncs measured on the card
# --------------------------------------------------------------------------

CONTRACTS_N = 50_000  # rows of the audited joins (the profiled joins' size)


def recorded_syncs(fn) -> tuple[object, list[tuple[str, int]]]:
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its result
    and the (file, line) of every synchronizing CUDA call it made (the
    innermost Python frame of each warning). The mode is reset in a
    finally."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [(os.path.realpath(w.filename), w.lineno) for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]


def decode_syncs(model, prompts: torch.Tensor) -> dict:
    """Syncs of one ``decode_step`` of a served model, after a warm-up step
    (the serving step's greedy argmax included)."""
    step = ts.make_serve_step(model.cfg)
    B, T = prompts.shape
    state = model.init_state(B, T + 2)
    tok, _, state = step(model, prompts[:, -1:], state, T)
    _, sites = recorded_syncs(lambda: step(model, tok, state, T + 1))
    torch.cuda.synchronize()
    return {"syncs": len(sites), "sites": sorted(set(sites))}


def phase_contracts(smi: str, dec: dict) -> float:
    """The contract checker's AST layer over the port (exit 0), then the host
    syncs of a mask and a compact join of CONTRACTS_N rows per verify tile
    against the tile loop's stream-tier budget, and those of one decode step
    (``dec``, lm_serve's :func:`decode_syncs`) against the step tier's.
    Returns the phase's seconds."""
    log("== contracts: the port's contract checker; host syncs per tile and per decode step")
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.join(ROOT, "tools"), os.path.join(ROOT, "src")])}
    lint = subprocess.run([sys.executable, "-m", "spjoin_lint_torch", os.path.join(ROOT, "src", "repro_torch")],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    log(f"[contracts] spjoin_lint_torch over src/repro_torch: exit {lint.returncode}; "
        f"{lint.stdout.strip().splitlines()[-1] if lint.stdout.strip() else lint.stderr[-2000:]}")
    assert lint.returncode == 0, lint.stdout[-4000:] + lint.stderr[-2000:]
    rel, scope = lint_config.TILE_LOOP
    verify_py = os.path.realpath(verify.__file__)
    assert verify_py.endswith(rel), (verify_py, rel)
    budget = lint_config.STREAM_SCOPES[rel][scope]
    static = lint_ast.sync_sites(Path(verify_py))[scope]
    counted = set(static["sites"])

    def in_loop(line: int) -> bool:
        return any(lo <= line <= hi for lo, hi in static["loops"])
    x = _mixture(CONTRACTS_N, 128, 13)
    torch.manual_seed(1)  # profile_join's δ
    delta = pick_delta(x, "l1", 10.0)
    ok = True
    for emit in ("mask", "compact"):
        cfg = spjoin.JoinConfig(delta=delta, emit=emit)
        run_join(x, cfg)  # warm
        res, sites = recorded_syncs(lambda: spjoin.join(x, cfg))
        torch.cuda.synchronize()
        tiles = res.verify_stats.n_tiles
        loop = [ln for f, ln in sites if f == verify_py and in_loop(ln)]
        per_tile = len(loop) / max(tiles, 1)
        lines = {ln: loop.count(ln) for ln in sorted(set(loop))}
        missed = sorted(set(loop) - counted)
        good = per_tile <= budget and not missed
        ok &= good
        log(f"[contracts] {emit} join N={CONTRACTS_N}: {tiles} tiles, {res.verify_stats.n_cells} cells; "
            f"{len(sites)} syncs in the join ({len(sites) / max(tiles, 1):.4f} per tile), {len(loop)} in the loops of "
            f"{scope} ({per_tile:.4f} per tile; budget {budget} sync sites, config.STREAM_SCOPES); by line "
            f"{json.dumps(lines)}; lines the checker does not count {missed}: {'ok' if good else 'FAILED'}")
    good = dec["syncs"] <= lint_config.STEP_SYNCS
    ok &= good
    log(f"[contracts] decode_step of {dec['arch']} (batch {dec['batch']}): {dec['syncs']} syncs per step "
        f"(budget {lint_config.STEP_SYNCS}, the step tier); sites {dec['sites']}: {'ok' if good else 'FAILED'}; {smi}")
    assert ok
    return time.perf_counter() - t0


def main() -> None:
    env = phase_environment()
    torch.manual_seed(0)  # the row samples that set δ
    log(env["smi"])
    ptx = phase_build()
    report = phase_kernels()
    log(f"[{elapsed():.1f}s] kernels checked")
    lm_s, dec_syncs = phase_lm_serve(env["smi"])
    log(f"[{elapsed():.1f}s] lm_serve done in {lm_s:.1f}s")
    train_s = phase_lm_train(env["smi"])
    log(f"[{elapsed():.1f}s] lm_train done in {train_s:.1f}s")
    mesh_s = phase_lm_mesh(env["smi"])
    log(f"[{elapsed():.1f}s] lm_mesh done in {mesh_s:.1f}s")
    dry_s = phase_lm_dryrun(env["smi"])
    log(f"[{elapsed():.1f}s] lm_dryrun done in {dry_s:.1f}s")
    contracts_s = phase_contracts(env["smi"], dec_syncs)
    log(f"[{elapsed():.1f}s] contracts done in {contracts_s:.1f}s")
    # The main path's rows, then fresh rows of the same mixture for the
    # serving phase's queries and insert.
    extra = SERVING_ROWS + int(INSERT_SHARE * N_ROWS)
    z = _mixture(N_ROWS + extra, 128, 12)
    mask_counts, compact_counts, x, delta, compact = phase_main_path(
        report, z, ptx, MAIN_SHARE_S - lm_s - train_s - mesh_s - dry_s - contracts_s)
    log(f"[{elapsed():.1f}s] main path done")
    profile_join(50_000, "mask")
    profile_join(50_000, "compact")
    log(f"[{elapsed():.1f}s] profiles done")
    idx, batches = phase_serving(z, delta)
    log(f"[{elapsed():.1f}s] serving done")
    dist_counts = phase_distributed(x, delta, compact, idx, batches)
    del z, x, idx, batches, compact
    log(f"[{elapsed():.1f}s] distributed done")
    none_counts = phase_exactness()
    log(f"[{elapsed():.1f}s] exactness done")
    phase_fig9()
    log(f"[{elapsed():.1f}s] comparison and dedup done")
    launches = {
        "pairdist": none_counts["pairdist"],
        "pairdist_filtered": mask_counts["pairdist_filtered"],
        "map_assign": mask_counts["map_assign"],
        "verify_compact": compact_counts["verify_compact"],
        "histogram": dist_counts["histogram"],
    }
    kernels = []
    for name, n in launches.items():
        kernels.append({**report[name], **ptxas_of(ptx, name), "launches": n})
    log(env["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["kind"], "count": env["count"]}}))


if __name__ == "__main__":
    main()
