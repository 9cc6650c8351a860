"""Plain PyTorch versions of every CUDA kernel in this package.

These are the semantic ground truth on the port's side: each kernel is
checked against the function of the same name here, on the card by
``chip_smoke.py`` and on the CPU by the tests (which also hold these against
the JAX package's oracles). They are written in the most obvious form (no
tiling, no fusion); the only concession is that ``l1``/``linf`` loop over
row chunks so the (a, b, m) broadcast stays bounded.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

METRICS = ("l1", "l2", "linf", "cosine", "dot")

# Elements of one (rows, cols, m) broadcast block in the l1/linf forms: 16 MiB
# of float32, so on a GPU the intermediate lives in the L2 cache.
_BROADCAST_ELEMS = 1 << 22
_BROADCAST_COLS = 2048


def _normalize(x: Tensor) -> Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)


def _absdiff_reduce(x: Tensor, y: Tensor, op: str) -> Tensor:
    """(..., a, m) against (..., b, m) -> (..., a, b): the sum or max of
    |x - y| over features, in (batch, row, column) blocks of at most
    ``_BROADCAST_ELEMS`` broadcast elements."""
    lead = x.shape[:-2]
    a, b, m = x.shape[-2], y.shape[-2], x.shape[-1]
    n = math.prod(lead)
    x3 = x.reshape(n, a, m)
    y3 = y.reshape(n, b, m)
    out = torch.empty((n, a, b), dtype=torch.float32, device=x.device)
    if n == 0 or a == 0 or b == 0:
        return out.reshape(*lead, a, b)
    cols = min(b, _BROADCAST_COLS)
    rows = max(1, _BROADCAST_ELEMS // (cols * max(m, 1)))
    batch = max(1, _BROADCAST_ELEMS // (min(rows, a) * cols * max(m, 1)))
    for t0 in range(0, n, batch):
        for i0 in range(0, a, rows):
            for j0 in range(0, b, cols):
                diff = (
                    x3[t0 : t0 + batch, i0 : i0 + rows, None, :]
                    - y3[t0 : t0 + batch, None, j0 : j0 + cols, :]
                ).abs_()
                blk = diff.sum(-1) if op == "sum" else diff.amax(-1)
                out[t0 : t0 + batch, i0 : i0 + rows, j0 : j0 + cols] = blk
    return out.reshape(*lead, a, b)


def pairdist(x: Tensor, y: Tensor, metric: str = "l2") -> Tensor:
    """All-pairs distances, x: (..., a, m), y: (..., b, m) -> (..., a, b)
    float32 (leading dimensions are a batch of independent tiles)."""
    x = x.float()
    y = y.float()
    if metric == "l1":
        return _absdiff_reduce(x, y, "sum")
    if metric == "linf":
        if x.shape[-1] == 0:
            return torch.zeros((*x.shape[:-1], y.shape[-2]), device=x.device)
        return _absdiff_reduce(x, y, "max")
    if metric == "l2":
        sq = (
            (x * x).sum(-1)[..., :, None]
            + (y * y).sum(-1)[..., None, :]
            - 2.0 * (x @ y.transpose(-1, -2))
        )
        return torch.sqrt(torch.clamp(sq, min=0.0))
    if metric == "cosine":
        return 1.0 - _normalize(x) @ _normalize(y).transpose(-1, -2)
    if metric == "dot":
        return x @ y.transpose(-1, -2)
    raise ValueError(f"unknown metric {metric!r}")


def pairdist_mask(x: Tensor, y: Tensor, delta: float, metric: str = "l2") -> Tensor:
    """Thresholded join mask: (a, b) bool, True where D(x_i, y_j) <= delta."""
    return pairdist(x, y, metric) <= delta


def pairdist_count(x: Tensor, y: Tensor, delta: float, metric: str = "l2") -> Tensor:
    """Per-row join fan-out: (a,) int32 — |{j : D(x_i, y_j) <= delta}|."""
    return pairdist_mask(x, y, delta, metric).sum(-1).to(torch.int32)


_EPS32 = float(torch.finfo(torch.float32).eps)


def prune_delta(
    delta: float, metric: str = "l1", x_abs: float = 0.0, n_feat: int = 0
) -> float:
    """The pivot filter's fp guard band — the threshold the L-inf lower
    bound is pruned against.

    Mathematically the bound over mapped coordinates never exceeds the true
    distance (each coordinate is 1-Lipschitz), but both sides are computed
    in fp32, and the DISTANCE side is the worse-conditioned one: l2's
    dot-expansion ``sqrt(|x|^2 + |y|^2 - 2xy)`` carries an absolute error
    ~ X^2·eps/delta near the threshold (X = coordinate magnitude), and
    l1/linf accumulate ~ m·X·eps — so a pair whose computed distance is
    <= delta can see a (well-conditioned) computed bound above delta when
    the data sits far from the origin. Pruning against a SCALE-AWARE
    slackened threshold restores fp soundness: callers pass ``x_abs``
    (max |payload coordinate|) and ``n_feat`` (payload dims), and the slack
    covers the worst-case rounding of the distance path, the bound path
    (coordinates are distances, <= the m·X-ish diameter), and the threshold
    compare. This is what the byte-identity invariant (prune="pivot" ==
    prune="none") relies on; the slack only admits extra candidates for
    exact evaluation, it never changes emitted pairs. The band is derived
    for fp32 eps: TF32 arithmetic would void it, which is why the port
    switches TF32 off.

    With the scale left at 0 (unknown), only the fixed band remains —
    sound for data of modest magnitude (|x| up to ~1e2 at delta ~1e-2+),
    which is why every internal caller threads the real scale through.
    """
    d = float(delta)
    x = float(x_abs)
    m = float(max(n_feat, 1))
    if metric == "l2":
        # dot-expansion: |d̂² − d²| ≲ c·m·eps·X² (each of the ~2m+4 terms
        # rounds at ulp(X²)). Through the sqrt the worst DISTANCE violation
        # is sqrt of that (when d̂² collapses toward 0) plus the first-order
        # term near the threshold; the coordinates are l2 distances with the
        # same error profile, hence the 3x on the sqrt term (x-side, y-side,
        # bound-side). Empirically ~2x above the measured worst case.
        e2 = 8.0 * m * _EPS32
        slack = 3.0 * (e2 ** 0.5) * x + e2 * x * x / (2.0 * max(d, _EPS32))
    elif metric in ("l1", "linf"):
        # Same-sign close subtractions are exact (Sterbenz); what is left is
        # accumulation rounding of the coordinate distances themselves,
        # whose magnitudes reach the ~m·X diameter — hence m²·X·eps.
        slack = 4.0 * m * (m + 1.0) * _EPS32 * x
    else:
        # Bounded-output metrics (angular, jaccard_minhash, cosine): the
        # distance and the coordinates live in [0, 1]-ish ranges.
        slack = 16.0 * _EPS32
    return d * (1.0 + 1e-4) + 1e-6 + slack


def bound_mask(
    px: Tensor, py: Tensor, delta: float, delta_bound: float | None = None
) -> Tensor:
    """Pivot-filter survivor mask: (a, b) bool over mapped coordinates —
    True where the L-inf lower bound max_p |px_i[p] - py_j[p]| is within the
    slackened threshold (the pair must be exactly evaluated)."""
    if delta_bound is None:
        delta_bound = prune_delta(delta)
    return pairdist(px, py, "linf") <= delta_bound


def pairdist_mask_filtered(
    x: Tensor,
    y: Tensor,
    px: Tensor,
    py: Tensor,
    delta: float,
    metric: str = "l2",
    delta_bound: float | None = None,
) -> Tensor:
    """Fused pivot-filter + thresholded join mask (a, b) bool:
    ``pairdist_mask & bound_mask`` — identical to the unfiltered mask, since
    the bound (plus the guard band of :func:`prune_delta`) never prunes a
    true hit."""
    return pairdist_mask(x, y, delta, metric) & bound_mask(px, py, delta, delta_bound)


def emit_keep(
    vid: Tensor, wid: Tensor, wcell: Tensor | None, cell_id: int, cross: bool = False
) -> Tensor:
    """The emission rule on broadcastable id tensors — single owner.

    Padding validity (id = -1 rows are never emitted) plus the min-cell
    de-dup rule of the reduce phase: a hit (v, w) with kernel cells
    (g = ``cell_id``, h = ``wcell``) is emitted by cell min(g, h) only;
    within one cell both orders are present, so keep id_v < id_w. R×S mode
    (``cross=True``): validity alone suffices (``wcell`` unused).
    """
    valid = (vid >= 0) & (wid >= 0)
    if cross:
        return valid
    return valid & ((wcell > cell_id) | ((wcell == cell_id) & (vid < wid)))


def emit_mask(
    vids: Tensor, wids: Tensor, wcells: Tensor | None, cell_id: int, cross: bool = False
) -> Tensor:
    """(a, b) bool — pairs this cell is allowed to emit (pre-distance):
    :func:`emit_keep` over every (v, w) of a tile."""
    return emit_keep(
        vids[:, None], wids[None, :], None if cross else wcells[None, :], cell_id, cross
    )


def compact_mask(
    mask: Tensor, vids: Tensor, wids: Tensor, capacity: int
) -> tuple[Tensor, Tensor]:
    """Compaction of an (a, b) hit mask into a fixed-capacity pair buffer.

    Returns ``(pairs, count)``: ``pairs`` is (capacity, 2) int32 holding
    ``(vids[i], wids[j])`` for the True cells of ``mask`` in row-major
    (``nonzero``) order, padded with -1; ``count`` is a 0-d int32 tensor
    equal to the TRUE number of hits — ``count > capacity`` signals
    overflow, and the buffer then holds the first ``capacity`` hits (the
    CUDA kernel fills it in another order; callers treat it as unspecified
    and retry at a larger capacity).
    """
    pairs = torch.full((capacity, 2), -1, dtype=torch.int32, device=mask.device)
    b = mask.shape[1]
    flat = torch.nonzero(mask.reshape(-1), as_tuple=True)[0]
    count = torch.tensor(flat.numel(), dtype=torch.int32, device=mask.device)
    pos = flat[:capacity]
    k = pos.numel()
    if k:
        pairs[:k, 0] = vids.to(torch.int32)[pos // b]
        pairs[:k, 1] = wids.to(torch.int32)[pos % b]
    return pairs, count


def verify_compact(
    x: Tensor,
    y: Tensor,
    vids: Tensor,
    wids: Tensor,
    wcells: Tensor | None,
    cell_id: int,
    *,
    delta: float,
    metric: str,
    capacity: int,
    cross: bool = False,
    px: Tensor | None = None,
    py: Tensor | None = None,
    delta_bound: float | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Fused verify + pair compaction, the plain version of the
    ``verify_compact`` kernel.

    One tile's reduce step: (optional) pivot-filter bound, exact distance,
    ``<= delta``, validity + min-cell de-dup (:func:`emit_mask`), then
    :func:`compact_mask` into a (capacity, 2) int32 id-pair buffer. Returns
    ``(pairs, count, n_cand)``: ``count`` the TRUE hit total, ``n_cand`` the
    valid pairs that survive the bound (all valid pairs without ``px``) —
    the quantity the mask path's candidate pre-pass counts, so the pruning
    telemetry does not depend on the emission mode.
    """
    valid = (vids[:, None] >= 0) & (wids[None, :] >= 0)
    hits = pairdist_mask(x, y, delta, metric)
    if px is not None:
        assert py is not None
        bound = bound_mask(px, py, delta, delta_bound)
        n_cand = (bound & valid).sum().to(torch.int32)
        hits = hits & bound
    else:
        n_cand = valid.sum().to(torch.int32)
    hits = hits & emit_mask(vids, wids, wcells, cell_id, cross)
    pairs, count = compact_mask(hits, vids, wids, capacity)
    return pairs, count, n_cand


MEMBER_WORD = 32  # whole-membership bits per packed 32-bit word
BIG = 3.0e38  # finite ±inf stand-in for box edges (fp32-representable);
#   core.partition aliases this — one owner for the sentinel


def pack_membership(member: Tensor) -> Tensor:
    """Pack an (N, p) bool membership mask 32 partitions per word:
    (N, ⌈p/32⌉) int32 holding the uint32 bit pattern (bit 31 included), bit
    ``j % 32`` of word ``j // 32`` set iff ``member[:, j]``. Trailing pad
    bits of the last word are 0."""
    n, p = member.shape
    pad = (-p) % MEMBER_WORD
    words = (p + pad) // MEMBER_WORD
    m = torch.nn.functional.pad(member.to(torch.int64), (0, pad))
    m = m.reshape(n, words, MEMBER_WORD)
    shift = torch.arange(MEMBER_WORD, dtype=torch.int64, device=member.device)
    w = (m << shift).sum(-1)  # in [0, 2**32): the uint32 value
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_membership(bits: Tensor, p: int) -> Tensor:
    """Inverse of :func:`pack_membership`: (N, ⌈p/32⌉) int32 → (N, p) bool.
    ``(w >> k) & 1`` is exact for bit 31 too (the arithmetic shift of a
    negative word keeps 1 in the low bit)."""
    shift = torch.arange(MEMBER_WORD, dtype=torch.int32, device=bits.device)
    b = (bits.to(torch.int32)[:, :, None] >> shift) & 1
    n, words = bits.shape
    return b.reshape(n, words * MEMBER_WORD)[:, :p].bool()


def assign_kernel_cells(xm: Tensor, kernel_lo: Tensor, kernel_hi: Tensor) -> Tensor:
    """(N,) int32 kernel cell ids — the first half-open [lo, hi) box that
    contains the row; a row no box contains gets cell 0."""
    xm = xm.float()
    inside = ((xm[:, None, :] >= kernel_lo[None]) & (xm[:, None, :] < kernel_hi[None]))
    inside = inside.all(-1)
    if inside.shape[1] == 0:
        return torch.zeros((xm.shape[0],), dtype=torch.int32, device=xm.device)
    # argmax of a bool row: the first True (0 when none) — int8 keeps it
    # well defined on every backend.
    return inside.to(torch.int8).argmax(1).to(torch.int32)


def membership_bits(xm: Tensor, whole_lo: Tensor, whole_hi: Tensor) -> Tensor:
    """(N, ⌈p/32⌉) int32 packed whole membership — closed [lo, hi] boxes."""
    xm = xm.float()
    inside = (xm[:, None, :] >= whole_lo[None]) & (xm[:, None, :] <= whole_hi[None])
    return pack_membership(inside.all(-1))


def assign_membership(
    xm: Tensor,
    kernel_lo: Tensor,
    kernel_hi: Tensor,
    whole_lo: Tensor,
    whole_hi: Tensor,
) -> tuple[Tensor, Tensor]:
    """Kernel cell id + packed whole membership from mapped coordinates:
    kernel boxes half-open [lo, hi), whole boxes closed [lo, hi]. Returns
    (cells (N,) int32, bits (N, ⌈p/32⌉) int32)."""
    return (
        assign_kernel_cells(xm, kernel_lo, kernel_hi),
        membership_bits(xm, whole_lo, whole_hi),
    )


def map_assign(
    x: Tensor,
    anchors: Tensor,
    kernel_lo: Tensor,
    kernel_hi: Tensor,
    whole_lo: Tensor,
    whole_hi: Tensor,
    metric: str = "l2",
) -> tuple[Tensor, Tensor, Tensor]:
    """Full map phase unfused: ``xm = pairdist(x, anchors)`` then
    :func:`assign_membership`. Returns (xm, cells, bits)."""
    xm = pairdist(x, anchors, metric)
    cells, bits = assign_membership(xm, kernel_lo, kernel_hi, whole_lo, whole_hi)
    return xm, cells, bits


def histogram_cells(u: Tensor, t: int) -> Tensor:
    """(n, m) int64 cell ``clip(trunc(u·t), 0, t − 1)`` of each value, the
    product in fp32. The clip is taken on the float product, which is the
    reference's cell for every input (an out-of-range float-to-int cast is
    undefined in torch): below 0 → 0, at or above t → t − 1, NaN → 0."""
    v = torch.nan_to_num(u.float() * t, nan=0.0)
    return torch.clamp(v, 0.0, float(t - 1)).to(torch.int64)


def histogram(u: Tensor, t: int, weights: Tensor | None = None) -> Tensor:
    """Per-dimension equal-width histogram of u in [0, 1): (n, m) -> (m, t)
    float32 — the GoF cell counts (paper Eq. 9). ``weights``: optional (n,)
    validity/padding mask; each row adds its weight to its cell. One pass
    per cell over (n, m), no (n, m, t) one-hot."""
    n, m = u.shape
    cell = histogram_cells(u, t)
    w = (
        torch.ones((n, 1), dtype=torch.float32, device=u.device)
        if weights is None
        else weights.reshape(n, 1).float()
    )
    out = torch.zeros((m, t), dtype=torch.float32, device=u.device)
    for c in range(t):
        out[:, c] = ((cell == c) * w).sum(0)
    return out
