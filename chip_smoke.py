"""Drive the PyTorch/CUDA port of SP-Join on one NVIDIA GPU and check it.

    python3 chip_smoke.py    # one card; takes no arguments

Phases, in order; any failure raises and exits non-zero (nothing is caught):
  1. environment — card name and power limit, torch/CUDA versions, TF32 off;
  2. build       — every CUDA kernel compiled from the sources in the
                   checkout with nvcc for sm_90a (timed);
  3. kernels     — each kernel against its plain PyTorch version on the card
                   at ragged shapes and at the main path's shapes, with times
                   (kernel, plain, library yardstick) and the roofline bound;
  4. main path   — the default-config l1 self-join over a 1M x 128 clustered
                   float32 set (the shape of the SIFT1M base set; halved, on a
                   "reduced" line, only if a probe predicts it will not fit
                   its share of the time limit), launch counts reset before
                   and read after; spot-checked against brute force for a
                   sample of rows; the map-assign kernel checked and timed in
                   both of its main-path modes at the main path's shapes;
                   then one 50,000-row join under torch.profiler (device busy
                   share, time by kernel);
  5. exactness   — at N = 50,000 the join (l1, l2; prune pivot and none; one
                   R x S) equals a brute-force join done in row chunks with
                   the plain version on the card: byte for byte, or differing
                   only in pairs that straddle delta between the kernel's and
                   the plain fp32 distance (l2's expansion form), each within
                   the stated per-pair tolerance (``dist_tol``).
The line before the last is the per-kernel JSON report; the last line is
{"ok": true, "device": {...}}. Needs torch built for CUDA and one card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import partition, spjoin  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402

EPS32 = float(torch.finfo(torch.float32).eps)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 peak outside the tensor cores
N_ROWS = 1_000_000  # the main path's rows before any "reduced" cut
MAIN_SHARE_S = 420.0  # the main path's share of the time limit
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


def phase_build() -> None:
    log("== phase 2: build")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.2f}s (per source {secs})")
    for name, text in _build.ptxas_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas[{name}] {line.strip()}")


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
    ms = cuda_ms(lambda: ops.pairdist_mask(x, y, delta, "l1", backend="cuda"))
    plain = cuda_ms(lambda: ref.pairdist_mask(x, y, delta, "l1"))
    lib = cuda_ms(lambda: torch.cdist(x, y, p=1.0) <= delta)
    bms, by = bound_ms(4 * (a + b) * m + a * b, 2.0 * a * b * m)
    report["pairdist"] = dict(
        name="pairdist", route="cuda", source="src/repro_torch/kernels/csrc/pairdist.cu",
        replaces="src/repro/kernels/pairdist.py:111", max_abs_err=worst, ms=ms,
        plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
    )
    log(f"pairdist l1 {a}x{b}x{m} mask: kernel {ms:.4f} ms plain {plain:.4f} ms cdist {lib:.4f} ms bound {bms:.4f} ms ({by})")

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
    surv = int(ref.bound_mask(px, py, delta, db).sum())
    ms = cuda_ms(lambda: ops.pairdist_mask_filtered(x, y, px, py, delta, "l1", delta_bound=db, backend="cuda"))
    plain = cuda_ms(lambda: ref.pairdist_mask_filtered(x, y, px, py, delta, "l1", db))
    bms, by = bound_ms(4 * (a + b) * (m + 8) + a * b, 2.0 * a * b * 8 + 2.0 * surv * m)
    report["pairdist_filtered"] = dict(
        name="pairdist_filtered", route="cuda", source="src/repro_torch/kernels/csrc/pairdist.cu",
        replaces="src/repro/kernels/pairdist.py:214", max_abs_err=worst, ms=ms,
        plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
    )
    log(f"pairdist_filtered l1 {a}x{b}x{m} (surviving pairs {surv}): kernel {ms:.4f} ms plain {plain:.4f} ms bound {bms:.4f} ms ({by})")

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
    return report


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
    near = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for i in range(0, x.shape[0], 1 << 16):
        xs, ts = xm_p[i : i + (1 << 16), None, :].double(), tol[i : i + (1 << 16), None, :]
        for edge in boxes:
            near[i : i + (1 << 16)] |= ((xs - edge[None].double()).abs() <= ts).any(-1).any(-1)
    cm = int(((cells != cells_p) & ~near).sum())
    bm = int(((bits != bits_p).any(1) & ~near).sum())
    return float(gap.max()), int((gap > tol).sum()), cm, bm, int(near.sum())


def check_and_time_map_assign(report: dict, x: torch.Tensor, cfg) -> None:
    """The map-assign kernel at the main path's shapes, in both of the
    modes the main path launches it: the metric mode over all rows with the
    plan's boxes (``want="cells"``), then the assign-only mode over the
    mapped rows with the tightened plan (``want="member"``). Each is checked
    against its plain version on the same inputs (coordinates within
    tolerance and cells equal off box edges; membership exact) and timed;
    the report row carries the sum of the two launches."""
    anchors, plan = main_path_plan(x, cfg)
    boxes = (plan.kernel_lo, plan.kernel_hi, plan.whole_lo, plan.whole_hi)
    n, m = x.shape
    na, p = anchors.shape[0], plan.p
    words = -(-p // ref.MEMBER_WORD)

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
    ms_m = cuda_ms(lambda: metric_mode("cuda"), reps=5)
    ms_a = cuda_ms(lambda: assign_mode("cuda"), reps=5)
    plain_m = cuda_ms(lambda: metric_mode("torch"), reps=2)
    plain_a = cuda_ms(lambda: assign_mode("torch"), reps=2)
    # Bytes: each input read once, each wanted output written once.
    n_bytes = 4 * (n * m + na * m + 4 * p * na + n * (na + 1))  # metric mode
    n_bytes += 4 * (n * na + 4 * p * na + n * words)  # assign-only mode
    n_ops = 2.0 * n * na * m + 2.0 * n * p * na + 2.0 * n * p * na
    bms, by = bound_ms(n_bytes, n_ops)
    report["map_assign"].update(ms=ms_m + ms_a, plain_ms=plain_m + plain_a, bound_ms=bms, bound_by=by)
    log(f"map_assign main-path pair of launches: kernel {ms_m:.4f} + {ms_a:.4f} ms, "
        f"plain {plain_m:.4f} + {plain_a:.4f} ms, bound {bms:.4f} ms ({by})")


def pick_delta(x: torch.Tensor, metric: str, mean_neighbours: float, y=None, sample: int = 2048) -> float:
    """δ with about ``mean_neighbours`` neighbours in ``y`` (default ``x``)
    per row of ``x``, from the distance quantile of a row sample."""
    self_join = y is None
    y = x if self_join else y
    q = x[torch.randperm(x.shape[0], device=x.device)[:sample]]
    d = torch.cat([ref.pairdist(q[i : i + 256], y, metric) for i in range(0, q.shape[0], 256)])
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


def phase_main_path(report: dict) -> tuple[dict, int]:
    log("== phase 4: main path (default JoinConfig, l1 self-join)")
    m = 128
    # Probe at n/16, run twice so the timed run is warm (the first pays the
    # one-time costs: kernel loads, allocator growth). The verify work grows
    # ~quadratically, so predict the full run and halve N until it fits
    # the phase's share.
    n = N_ROWS
    probe_n = max(n // 16, 20000)
    xp = _mixture(probe_n, m, 11)
    dp = pick_delta(xp, "l1", 10.0 * probe_n / n)
    run_join(xp, spjoin.JoinConfig(delta=dp))
    probe, t_probe = run_join(xp, spjoin.JoinConfig(delta=dp))
    del xp

    def predict(rows: int) -> float:  # sampling + map ~linear, verify ~quadratic
        r = rows / probe_n
        return (t_probe - probe.verify_time_s) * r + probe.verify_time_s * r * r

    log(f"probe: {probe_n} rows in {t_probe:.2f}s; predicted {predict(n):.1f}s at {n} rows")
    while n > probe_n and predict(n) > MAIN_SHARE_S:
        log(f"reduced: n_rows {n} -> {n // 2} (predicted {predict(n):.1f}s > {MAIN_SHARE_S:.0f}s)")
        n //= 2
    x = _mixture(n, m, 12)
    delta = pick_delta(x, "l1", 10.0)
    cfg = spjoin.JoinConfig(delta=delta)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res, wall = run_join(x, cfg)
    counts = ops.launch_counts()
    vs = res.verify_stats
    mean_nb = 2.0 * res.n_pairs / n
    log(f"N={n} m={m} delta={delta:.6f} n_pairs={res.n_pairs} mean_neighbours={mean_nb:.3f}")
    log(f"seconds: sample {res.sample_time_s:.3f} map {res.map_time_s:.3f} verify {res.verify_time_s:.3f} total {wall:.3f}")
    log("VerifyStats " + json.dumps({
        k: getattr(vs, k) for k in (
            "n_verifications", "n_padded", "n_dispatched", "n_tiles", "n_cells", "n_hits",
            "n_pruned", "n_tiles_pruned", "n_overflow_retries", "prune", "emit",
            "n_buckets", "occupancy", "n_exact", "prune_rate",
        )
    }))
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"launch counts (main path) {json.dumps(counts)}")
    assert counts["map_assign"] > 0 and counts["pairdist_filtered"] > 0, counts
    assert 1.0 <= mean_nb <= 100.0, mean_nb
    pairs = res.pairs
    assert pairs.dtype == np.int64 and pairs.shape[1] == 2 and (pairs[:, 0] < pairs[:, 1]).all()
    assert (np.diff(pairs[:, 0]) >= 0).all()
    # Spot check at full size: every partner of 256 sampled rows, by brute
    # force on the card, against the join's pairs (borderline band excused).
    rows = torch.randperm(n, device="cuda")[:256]
    d = ref.pairdist(x[rows], x, "l1")
    hit = d <= delta
    hit[torch.arange(256, device="cuda"), rows] = False
    pt = torch.as_tensor(pairs, device="cuda")
    got = torch.zeros_like(hit)
    for j, r in enumerate(rows.tolist()):
        partners = torch.cat([pt[pt[:, 0] == r, 1], pt[pt[:, 1] == r, 0]])
        got[j, partners] = True
    diff = (got != hit).nonzero()
    if diff.numel():
        d64 = (x[rows[diff[:, 0]]].double() - x[diff[:, 1]].double()).abs().sum(1)
        assert bool(((d64 - delta).abs() <= 1e-5 * max(1.0, delta)).all()), "join missed pairs"
    log(f"spot check: 256 rows, {int(hit.sum())} partners, {diff.shape[0]} borderline differences")
    check_and_time_map_assign(report, x, cfg)
    return counts, n


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


def profile_join(n: int) -> None:
    """Where the join's time goes on the device: one default-config join
    of n rows under torch.profiler; device busy time is the sum of the
    kernels' intervals (one stream, so they do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = _mixture(n, 128, 13)
    cfg = spjoin.JoinConfig(delta=pick_delta(x, "l1", 10.0))
    run_join(x, cfg)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res, wall = run_join(x, cfg)
    per_kernel: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(per_kernel.values())
    log(f"profile: N={n} join wall {wall * 1e3:.1f} ms (verify {res.verify_time_s * 1e3:.1f} ms, "
        f"{res.verify_stats.n_tiles} tiles) device busy {busy:.1f} ms = {busy / (wall * 1e3):.3f} of wall")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  device {ms:10.2f} ms  {name[:100]}")


def phase_exactness() -> dict:
    log("== phase 5: exactness on the card (N = 50,000)")
    n, m = 50_000, 128
    counts = {}
    for metric in ("l1", "l2"):
        x = _mixture(n, m, 21)
        delta = gap_delta(x, metric, 10.0)
        truth = spjoin.brute_force_pairs(x, delta, metric, device="cuda", chunk=BRUTE_CHUNK)
        pivot, t_pivot = run_join(x, spjoin.JoinConfig(delta=delta, metric=metric))
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
    r, s = synthetic.rs_mixture(20_000, 40_000, m, n_clusters=64, seed=22)
    r, s = torch.as_tensor(r).cuda(), torch.as_tensor(s).cuda()
    delta = gap_delta(r, "l1", 10.0, s=s)
    truth = spjoin.brute_force_pairs(r, delta, "l1", s=s, device="cuda", chunk=BRUTE_CHUNK)
    res, t = run_join(r, spjoin.JoinConfig(delta=delta), s=s)
    verdict = check_exact(res.pairs, truth, r, s, "l1", delta)
    log(f"R x S l1: |R|={r.shape[0]} |S|={s.shape[0]} delta {delta:.6f} pairs {res.n_pairs} brute force {len(truth)}: {verdict} ({t:.2f}s)")
    return counts


def main() -> None:
    env = phase_environment()
    torch.manual_seed(0)  # the row samples that set δ
    log(env["smi"])
    phase_build()
    report = phase_kernels()
    log(f"[{elapsed():.1f}s] kernels checked")
    main_counts, n = phase_main_path(report)
    log(f"[{elapsed():.1f}s] main path done at N={n}")
    profile_join(50_000)
    log(f"[{elapsed():.1f}s] profile done")
    none_counts = phase_exactness()
    log(f"[{elapsed():.1f}s] exactness done")
    kernels = []
    for name in ("pairdist", "pairdist_filtered", "map_assign"):
        row = dict(report[name])
        row["launches"] = none_counts[name] if name == "pairdist" else main_counts[name]
        kernels.append(row)
    log(env["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["kind"], "count": env["count"]}}))


if __name__ == "__main__":
    main()
