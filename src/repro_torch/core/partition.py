"""Partition strategies (paper §5.2 Alg. 5 — iterative, §5.3 Alg. 6 — learning).

Both strategies recursively bisect the target space (the ℝⁿ image of the
space mapping) at the ⌈p/2⌉-fractile of a chosen dimension until p leaf
boxes exist: ``iterative`` picks the dimension at random, ``learning`` by the
regularized information-gain ratio of the pivots' cluster labels
(Eqs. 35–37).

Leaves are the split constraints' half-space boxes (they tile ℝⁿ, so every
object has exactly one KERNEL cell); ``tighten`` shrinks them to the MBB of
the objects actually assigned before the δ-expansion into WHOLE boxes.
Both satisfy Lemma 4.

Tree construction is control plane over the k pivots and runs on host
numpy (verbatim from the reference); assignment of the data is data plane
on the device, through the map-assign kernel when a backend is given.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Tensor = torch.Tensor

BIG = kref.BIG  # stand-in for ±inf that stays finite in fp32 (one owner)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """p leaf boxes of the split tree in target space.

    kernel_lo/hi: (p, n) — half-open boxes [lo, hi) tiling ℝⁿ.
    whole_lo/hi:  (p, n) — kernel boxes expanded by δ (after optional
                  tightening; the join widens them to its fp guard band,
                  :func:`widen`). WHOLE membership is closed: [lo − δ, hi + δ].
    delta:        the join threshold.
    """

    kernel_lo: Tensor
    kernel_hi: Tensor
    whole_lo: Tensor
    whole_hi: Tensor
    delta: float

    @property
    def p(self) -> int:
        return self.kernel_lo.shape[0]

    @property
    def n_dims(self) -> int:
        return self.kernel_lo.shape[1]


def single_linkage_labels(dist_matrix: np.ndarray, n_clusters: int) -> np.ndarray:
    """Single-linkage agglomerative clustering via the MST equivalence:
    build the minimum spanning tree (Prim, O(k²)) and delete the
    (n_clusters − 1) heaviest edges; connected components are the clusters.

    dist_matrix: (k, k) origin-space pivot distances. Returns int labels (k,).
    """
    k = dist_matrix.shape[0]
    n_clusters = int(min(max(n_clusters, 1), k))
    if n_clusters == 1:
        return np.zeros((k,), np.int64)

    in_tree = np.zeros(k, bool)
    in_tree[0] = True
    best = dist_matrix[0].copy()
    parent = np.zeros(k, np.int64)
    edges = []  # (weight, a, b)
    for _ in range(k - 1):
        best_masked = np.where(in_tree, np.inf, best)
        j = int(np.argmin(best_masked))
        edges.append((best[j], parent[j], j))
        in_tree[j] = True
        closer = dist_matrix[j] < best
        parent = np.where(closer, j, parent)
        best = np.minimum(best, dist_matrix[j])

    edges.sort(key=lambda e: e[0])
    keep = edges[: k - n_clusters]  # drop the n_clusters−1 heaviest

    uf = np.arange(k)

    def find(a: int) -> int:
        while uf[a] != a:
            uf[a] = uf[uf[a]]
            a = uf[a]
        return a

    for _, a, b in keep:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            uf[ra] = rb
    roots = np.array([find(i) for i in range(k)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def _entropy(labels: np.ndarray) -> float:
    """Eq. 35: label entropy."""
    if labels.size == 0:
        return 0.0
    _, counts = np.unique(labels, return_counts=True)
    f = counts / labels.size
    return float(-(f * np.log(np.maximum(f, 1e-12))).sum())


def gain_ratio(labels: np.ndarray, left_mask: np.ndarray) -> float:
    """Eq. 37: F_d = C_d / split_info, with C_d the entropy reduction (Eq. 36)
    and split_info = −Σ |K|/|S| log |K|/|S| the regularizer."""
    n = labels.size
    nl = int(left_mask.sum())
    nr = n - nl
    if nl == 0 or nr == 0:
        return -np.inf
    h = _entropy(labels)
    hl = _entropy(labels[left_mask])
    hr = _entropy(labels[~left_mask])
    gain = h - (nl / n) * hl - (nr / n) * hr
    fl, fr = nl / n, nr / n
    split_info = -(fl * np.log(fl) + fr * np.log(fr))
    return float(gain / max(split_info, 1e-12))


def build_partition(
    pivots_mapped: np.ndarray,
    p: int,
    delta: float,
    strategy: str = "learning",
    labels: np.ndarray | None = None,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> PartitionPlan:
    """Recursively split the mapped pivots into p leaf boxes.

    pivots_mapped: (k, n) target-space pivot coordinates (numpy).
    labels: required for strategy="learning" (origin-space cluster labels).
    The plan's boxes are float32 tensors on ``device`` (the card unless the
    caller asks for the CPU).
    """
    device = kops.resolve_device(device)
    pivots_mapped = np.asarray(pivots_mapped, np.float64)
    k, n = pivots_mapped.shape
    if strategy == "learning" and labels is None:
        raise ValueError("learning strategy requires pivot labels")
    if p < 1:
        raise ValueError("p must be ≥ 1")
    rng = np.random.default_rng(seed)

    boxes: list[tuple[np.ndarray, np.ndarray]] = []

    def recurse(idx: np.ndarray, p_want: int, lo: np.ndarray, hi: np.ndarray) -> None:
        if p_want == 1:
            boxes.append((lo.copy(), hi.copy()))
            return
        pts = pivots_mapped[idx]
        lab = None if labels is None else labels[idx]
        p_left = int(np.ceil(p_want / 2))
        frac = p_left / p_want  # Alg. 5 line 5: the ⌈p/2⌉/p fractile

        if strategy == "iterative":
            spans = pts.max(0) - pts.min(0) if pts.size else np.ones(n)
            candidates = np.flatnonzero(spans > 0)
            d = int(rng.choice(candidates)) if candidates.size else int(rng.integers(n))
        elif strategy == "learning":
            best_d, best_gain = 0, -np.inf
            for d_try in range(n):
                cut_try = np.quantile(pts[:, d_try], frac) if pts.size else 0.0
                left = pts[:, d_try] < cut_try
                g = gain_ratio(lab, left) if lab is not None else -np.inf
                if g > best_gain:
                    best_gain, best_d = g, d_try
            d = best_d
        else:
            raise ValueError(f"unknown strategy {strategy!r}")

        cut = float(np.quantile(pts[:, d], frac)) if pts.size else float(0.5 * (lo[d] + hi[d]))
        # Guard: a cut at the box edge would create an empty child box.
        cut = float(np.clip(cut, lo[d] + 1e-9 if lo[d] > -BIG else -BIG / 2, hi[d]))

        left_sel = pts[:, d] < cut if pts.size else np.zeros(0, bool)
        hi_l = hi.copy()
        hi_l[d] = cut
        lo_r = lo.copy()
        lo_r[d] = cut
        recurse(idx[left_sel], p_left, lo, hi_l)
        recurse(idx[~left_sel], p_want - p_left, lo_r, hi)

    lo0 = np.full((n,), -BIG)
    hi0 = np.full((n,), BIG)
    recurse(np.arange(k), p, lo0, hi0)
    assert len(boxes) == p, (len(boxes), p)

    kl = np.stack([b[0] for b in boxes]).astype(np.float32)
    kh = np.stack([b[1] for b in boxes]).astype(np.float32)

    def dev(a: np.ndarray) -> Tensor:
        return torch.as_tensor(a, device=device)

    return PartitionPlan(
        kernel_lo=dev(kl),
        kernel_hi=dev(kh),
        whole_lo=dev(kl - delta),
        whole_hi=dev(kh + delta),
        delta=float(delta),
    )


def assign_kernel(plan: PartitionPlan, x_mapped: Tensor, backend: str | None = None) -> Tensor:
    """KERNEL cell id per object: the unique half-open leaf box containing
    it (V_h = {o : cell(o) = h}). ``backend``: None keeps the inline
    broadcast; "torch" | "cuda" | "auto" routes through
    ``kernels.ops.assign_membership`` (identical cells by construction)."""
    if backend is not None:
        cells, _ = kops.assign_membership(
            x_mapped, plan.kernel_lo, plan.kernel_hi, plan.whole_lo, plan.whole_hi,
            backend=backend, want="cells",
        )
        return cells
    return kref.assign_kernel_cells(x_mapped, plan.kernel_lo, plan.kernel_hi)


def whole_membership(
    plan: PartitionPlan, x_mapped: Tensor, backend: str | None = None
) -> Tensor:
    """(N, p) bool — WHOLE partition membership (δ-expanded, closed boxes):
    W_h = {o : o within the δ-expanded box of cell h} ⊇ V_h. ``backend`` as
    in :func:`assign_kernel` (the packed words are unpacked here)."""
    if backend is not None:
        _, bits = kops.assign_membership(
            x_mapped, plan.kernel_lo, plan.kernel_hi, plan.whole_lo, plan.whole_hi,
            backend=backend, want="member",
        )
        return kops.unpack_membership(bits, plan.p)
    xm = x_mapped.float()
    inside = (xm[:, None, :] >= plan.whole_lo[None]) & (xm[:, None, :] <= plan.whole_hi[None])
    return inside.all(-1)


def member_boxes(x_mapped: Tensor, cell_ids: Tensor, p: int) -> tuple[Tensor, Tensor]:
    """(p, n) MBB of each cell's assigned objects (segment min/max); empty
    cells collapse to the inverted (BIG, -BIG) box, which no radius can
    route into."""
    n = x_mapped.shape[1]
    xm = x_mapped.float()
    idx = cell_ids.to(torch.int64)[:, None].expand(-1, n)
    zeros = torch.zeros((p, n), dtype=torch.float32, device=xm.device)
    seg_min = zeros.scatter_reduce(0, idx, xm, "amin", include_self=False)
    seg_max = zeros.scatter_reduce(0, idx, xm, "amax", include_self=False)
    empty = torch.bincount(cell_ids.to(torch.int64), minlength=p)[:p] == 0
    lo = torch.where(empty[:, None], BIG, seg_min)
    hi = torch.where(empty[:, None], -BIG, seg_max)
    return lo, hi


def tighten(
    plan: PartitionPlan, x_mapped: Tensor, cell_ids: Tensor, band: float | None = None
) -> PartitionPlan:
    """Shrink each kernel box to the MBB of its assigned objects, then
    re-expand by ``band`` (default δ; see :func:`widen`). Empty cells
    collapse to an inverted box (no members ⇒ no verifications). Preserves
    Lemma 4."""
    band = plan.delta if band is None else float(band)
    lo, hi = member_boxes(x_mapped, cell_ids, plan.p)
    return PartitionPlan(
        kernel_lo=plan.kernel_lo,
        kernel_hi=plan.kernel_hi,
        whole_lo=lo - band,
        whole_hi=hi + band,
        delta=plan.delta,
    )


def widen(plan: PartitionPlan, band: float) -> PartitionPlan:
    """The kernel boxes re-expanded by ``band`` >= δ into the whole boxes.

    Lemma 4 holds for exact coordinates; computed ones carry fp32 rounding,
    so a δ-neighbour of a row on a box face can land a few ulps outside the
    box expanded by exactly δ, and its pair is then never verified (seen on
    integer q-gram profiles at l1 δ = 4, where many pairs sit at exactly δ
    and the triangle inequality is tight along an anchor). The join expands
    by the pivot filter's guard band (``verify.prune_band``) instead: a
    wider box only adds candidates, which the exact verify then decides."""
    return dataclasses.replace(
        plan, whole_lo=plan.kernel_lo - float(band), whole_hi=plan.kernel_hi + float(band)
    )


def partition_stats(cell_ids: np.ndarray, membership: np.ndarray) -> dict:
    """Per-cell sizes ``{"v_sizes": (p,), "w_sizes": (p,)}``: |V_h| kernel
    rows and |W_h| whole rows — the inputs of Eq. 33."""
    p = membership.shape[1]
    v = np.bincount(np.asarray(cell_ids), minlength=p).astype(np.int64)
    w = np.asarray(membership).sum(0).astype(np.int64)
    return {"v_sizes": v, "w_sizes": w}
