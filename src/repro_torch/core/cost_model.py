"""Partition cost model (paper §5.1, Eqs. 28/33) + capacity prediction.

The paper's cost G(A) = 𝟙ᵀ·A·Aᵀ·𝟙 counts pairwise co-residencies; rewritten
over KERNEL/WHOLE partitions (Eq. 33):

    G = Σ_h |V_h|²                      (inner verification cost)
      + Σ_h |V_h| · (|W_h| − |V_h|)     (outer verification cost)

Minimizing G under the correctness constraint A·Aᵀ ≥ B is NP-hard (Theorem 4),
hence the two heuristics in repro.core.partition.

TPU adaptation: on a static-shape machine, skew doesn't cost straggler time —
it costs *capacity padding* in the all_to_all dispatch. This module converts
sample-based partition-size estimates into the static per-cell capacity the
distributed executor compiles with, and exposes the skew/balance metrics that
EXPERIMENTS.md reports (Table 3 and Fig. 12 analogues).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PartitionCost:
    inner: float  # Σ |V_h|²
    outer: float  # Σ |V_h|·(|W_h|−|V_h|)
    total: float  # G(A)
    max_cell: float  # max_h |V_h|·|W_h| — the "last reducer" load
    balance_std: float  # std of per-cell verification counts (Table 3 metric)
    duplication: float  # Σ|W_h| / N — shuffle volume amplification


def partition_cost(v_sizes: np.ndarray, w_sizes: np.ndarray) -> PartitionCost:
    """Evaluate Eq. 33 given per-cell |V_h| and |W_h|."""
    v = np.asarray(v_sizes, np.float64)
    w = np.asarray(w_sizes, np.float64)
    inner = float((v * v).sum())
    outer = float((v * np.maximum(w - v, 0.0)).sum())
    per_cell = v * w
    n = max(v.sum(), 1.0)
    return PartitionCost(
        inner=inner,
        outer=outer,
        total=inner + outer,
        max_cell=float(per_cell.max(initial=0.0)),
        balance_std=float(per_cell.std()),
        duplication=float(w.sum() / n),
    )


def rs_partition_cost(
    v_sizes: np.ndarray, w_sizes: np.ndarray, n_s: int
) -> PartitionCost:
    """Eq. 33 instantiated for a two-set R×S join.

    ``v_sizes[h]`` = |V_h| (R rows whose kernel cell is h), ``w_sizes[h]`` =
    |W_h| (S rows whole-member of h). Every verification crosses the sets, so
    the "inner" (same-set) term vanishes and G = Σ_h |V_h|·|W_h| is all
    outer cost. ``duplication`` is the shuffle amplification of the S side,
    Σ_h |W_h| / |S| — how many copies of each S row cross the wire.
    """
    v = np.asarray(v_sizes, np.float64)
    w = np.asarray(w_sizes, np.float64)
    per_cell = v * w
    return PartitionCost(
        inner=0.0,
        outer=float(per_cell.sum()),
        total=float(per_cell.sum()),
        max_cell=float(per_cell.max(initial=0.0)),
        balance_std=float(per_cell.std()),
        duplication=float(w.sum() / max(float(n_s), 1.0)),
    )


def lower_bound_inner(n_total: int, p: int) -> float:
    """Eq. 34: Σ|V_h|² ≥ N²/p — the even-partition floor."""
    return float(n_total) ** 2 / max(p, 1)


def estimate_from_samples(
    sample_cells: np.ndarray,
    sample_membership: np.ndarray,
    n_total: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Scale sample-based cell statistics to the full dataset.

    sample_cells: (k,) kernel cell id per sampled pivot.
    sample_membership: (k, p) whole membership of the samples.
    Returns (v_est, w_est), each (p,), in object counts.

    This is where Theorem 3 earns its keep: the marginal-CDF error ε of the
    sample bounds the error of every box-count estimate (box counts are CDF
    differences), so |V̂_h/N − V_h/N| ≤ 2nε with probability ≥ 1 − 2m·e^{−2kε²}.
    """
    k, p = sample_membership.shape
    scale = n_total / max(k, 1)
    v_est = np.bincount(sample_cells, minlength=p).astype(np.float64) * scale
    w_est = sample_membership.sum(0).astype(np.float64) * scale
    return v_est, w_est


def predicted_cell_loads(
    v_est: np.ndarray, w_est: np.ndarray, survival: float = 1.0
) -> np.ndarray:
    """Per-cell predicted verification loads — the placement planner's input.

    Eq. 33's per-cell cost |V̂_h|·|Ŵ_h| from the sample-scaled estimates of
    :func:`estimate_from_samples`, times the pivot-filter ``survival``
    fraction (:func:`estimate_survival_rate`) so the loads model the exact
    evaluations a device will actually run, not the pre-filter candidate
    area. ``core.placement.plan_placement`` turns these into the cell→device
    assignment; docs/COST_MODEL.md walks a worked example.

    ``survival`` is floored at 1e-3: a sample estimate of exactly 0 is a
    small-sample artifact (any true hit survives the bound), and a scalar
    survival only rescales the loads — flooring preserves the per-cell
    structure the planner needs instead of erasing it.
    """
    return (
        np.asarray(v_est, np.float64)
        * np.asarray(w_est, np.float64)
        * float(np.clip(survival, 1e-3, 1.0))
    )


def load_drift(predicted: np.ndarray, observed: np.ndarray) -> float:
    """Scale-free drift between the cost model's predicted per-cell loads and
    the loads actually observed: the total-variation distance
    ``0.5 · Σ_h |p̂_h − ô_h|`` of the sum-normalized load vectors, in [0, 1].

    0 means the pivot sample still describes the data (the placement plan's
    relative cell weights are right even if the absolute scale grew with
    inserts); 1 means the observed mass sits entirely in cells the sample
    predicted empty. Normalizing first is what makes append-only growth
    drift-free when the distribution is stationary: doubling every cell's
    load changes nothing. The streaming layer compares this against the
    re-plan / re-sample thresholds (``core.placement.drift_action``,
    decision table in docs/STREAMING.md).
    """
    p = np.asarray(predicted, np.float64).reshape(-1)
    o = np.asarray(observed, np.float64).reshape(-1)
    if p.shape != o.shape:
        raise ValueError(
            f"predicted and observed loads must align per cell; got "
            f"{p.shape} vs {o.shape}"
        )
    ps, os_ = p.sum(), o.sum()
    if ps <= 0 and os_ <= 0:
        return 0.0
    if ps <= 0 or os_ <= 0:
        return 1.0
    return float(0.5 * np.abs(p / ps - o / os_).sum())


def predict_capacity(
    w_est: np.ndarray,
    n_shards: int,
    slack: float = 1.25,
    quantize: int = 8,
) -> int:
    """Static per-(cell, source-shard) dispatch capacity.

    Each source shard sends at most `cap` rows to each destination cell; the
    compiled buffer is (p, n_shards, cap). We provision the max estimated
    cell load, spread over shards, times a slack factor; `quantize` rounds up
    to keep re-compilations rare across epochs. Overflow is exact-handled by
    the residual pass — slack trades padding FLOPs against residual volume.
    """
    per_shard = float(np.max(w_est, initial=1.0)) / max(n_shards, 1)
    cap = int(np.ceil(per_shard * slack))
    cap = max(cap, 1)
    return int(np.ceil(cap / quantize) * quantize)


def verification_count(
    v_sizes: np.ndarray, w_sizes: np.ndarray, survival: float = 1.0
) -> float:
    """The paper's Fig. 12 metric: total pairwise verifications performed,
    Σ_h |V_h|·|W_h| (each kernel row is checked against every whole row).

    ``survival`` makes the estimate pruning-aware: with the pivot filter
    enabled only a ``survival`` fraction of candidate pairs reaches exact
    metric evaluation (estimate it with :func:`estimate_survival_rate`), so
    the expected exact-evaluation count is G·survival. The default 1.0 is
    the unpruned paper quantity.
    """
    g = float(
        (np.asarray(v_sizes, np.float64) * np.asarray(w_sizes, np.float64)).sum()
    )
    return g * float(np.clip(survival, 0.0, 1.0))


def estimate_survival_rate(
    piv_mapped: np.ndarray,
    delta: float,
    cells: np.ndarray | None = None,
    member: np.ndarray | None = None,
    chunk: int = 256,
) -> float:
    """Sample-based estimate of the pivot-filter survival fraction.

    ``piv_mapped``: (k, n) mapped coordinates of the sampled pivots — the
    same sample that sizes the partitions. The estimate is the fraction of
    off-diagonal pivot pairs whose L∞ lower bound is ≤ δ; 1 − survival is
    the predicted pruning rate, and G·survival (see
    :func:`verification_count`) the expected exact-evaluation count. Same
    Theorem-3 reasoning as the box-count estimates: the bound is a function
    of the marginal coordinate distributions the sample approximates.

    ``cells``/``member`` (the pivots' kernel assignment and whole
    membership, as produced for :func:`estimate_from_samples`) restrict the
    estimate to CANDIDATE pairs — pivot j whole-member of pivot i's kernel
    cell, the V×W structure the verify phase actually enumerates. Without
    them the estimate averages over all pairs, which skews low: candidate
    pairs are co-partitioned, hence closer than random pairs and more likely
    to survive the bound.

    Row-chunked so the (k, k, n) broadcast never materializes (k can be the
    full pivot budget, ~10³–10⁴).
    """
    x = np.asarray(piv_mapped, np.float32)
    k = x.shape[0]
    if k < 2:
        return 1.0
    restrict = cells is not None and member is not None
    if restrict:
        cells = np.asarray(cells)
        member = np.asarray(member, bool)
    surviving = 0
    total = 0
    for i0 in range(0, k, chunk):
        xi = x[i0 : i0 + chunk]
        c = xi.shape[0]
        bound = np.abs(xi[:, None, :] - x[None, :, :]).max(-1)  # (c, k)
        if restrict:
            cand = member[:, cells[i0 : i0 + c]].T  # (c, k) — V×W structure
        else:
            cand = np.ones_like(bound, bool)
        cand[np.arange(c), i0 + np.arange(c)] = False  # drop the diagonal
        surviving += int((cand & (bound <= delta)).sum())
        total += int(cand.sum())
    if total == 0:
        return 1.0
    return float(surviving / total)
