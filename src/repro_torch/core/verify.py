"""Streaming tiled verify engine — the reduce phase of SP-Join, on the device.

The reduce phase (paper §5) checks every kernel-partition row V_h against
every whole-partition row W_h: Σ_h |V_h|·|W_h| distance evaluations. Each
cell's |V_h| × |W_h| rectangle is cut into tiles of at most
``tile_v × tile_w`` and streamed, so the working set is O(tile).

Port of ``repro.core.verify`` with the same schedule and the same counters:

  * Tiles are accounted at the reference's quarter-power-of-two *bucket*
    shapes (``bucket_size``), so ``VerifyStats.n_padded`` / ``occupancy`` /
    ``bucket_shapes`` are the reference's. The kernels mask their own
    ragged edges, so no tile is padded on the device (the batched window
    dispatch of the plain path pads, as the reference's vmap does).
  * Data, mapped coordinates and tiles stay on the device: each cell's V and
    W rows are gathered once with index tensors (in window order under
    pruning) and every tile is a contiguous slice of those buffers. Only
    the hits come back, and they stay on the device until the final
    sort/unique.
  * The control plane — cell index lists, the per-cell sort dimension, the
    ``± delta_bound`` windows and the bounding-box tile skips — runs on host
    numpy over one host copy of the coordinates, exactly as the reference
    does, so every decision and counter is the reference's.

Prune modes (``EngineConfig.prune``): "none"; "pivot" — windows, bbox
skips and the per-pair L∞ bound (the mask path runs the bound as a plain
candidate pre-pass per tile, whose count is read back as the whole-tile
skip decision, and the fused filtered pairdist kernel; the compact path
runs the bound inside its kernel and reads the survivor count back in-band);
"window" — windows and bbox skips only, the tile runs the plain pairdist
kernel (one launch per tile on "cuda"; on "torch" the tiles are deferred
and verified in same-bucket batches, ``_flush_window_batch``).

Emission (``EngineConfig.emit``): "mask" — the tile's hit mask is compacted
on the device with ``nonzero`` and the emission rule applied to the hit
list; "compact" — the fused ``verify_compact`` tile (the CUDA kernel, or its
plain version) returns a (capacity, 2) pair buffer plus ``[count, n_cand]``,
and the counters are the tile's one read. The capacity comes from a
survival-rate prior on the quarter-pow2 ladder; ``count > capacity`` is the
overflow sentinel, answered by a retry at the bucket of the exact count
(at most ``_MAX_OVERFLOW_RETRIES``), then by the mask path (the reference's
algorithm, counted in ``n_overflow_retries``). The rule of which tiles carry
the buffer is the reference's: ``buffered = emit == "compact" and (backend
== "cuda" or prune == "pivot")``; otherwise compact lowers to the mask
dispatch (same pairs, same counters).

De-dup rule: a hit (i, j) with cell(i) = g, cell(j) = h is emitted by cell
min(g, h) only; within one cell keep id_i < id_j (``ref.emit_mask``). R×S
(``data_w`` given): V rows from R's kernel cells, W rows from S's whole
membership; validity alone, pairs are (i ∈ R, j ∈ S).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import cost_model, distances
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs for the streaming engine.

    ``backend``: "torch" | "cuda" | "auto" (see ``kernels.ops``). Metrics
    without a kernel (angular, jaccard_minhash) always take the plain path.
    ``tile_v`` / ``tile_w``: streaming tile capacity (rows per side).
    ``min_bucket``: smallest bucket side in the tile accounting.
    ``prune``: "none" | "pivot" | "window" — pivot-filter pruning (L∞ lower
    bound over mapped coordinates; module docstring); metrics without the
    triangle inequality resolve back to "none".
    ``emit``: "mask" | "compact" — how a tile's hits come back (module
    docstring); metrics without a kernel resolve compact back to "mask".
    """

    backend: str = "auto"
    tile_v: int = 1024
    tile_w: int = 4096
    min_bucket: int = 8
    prune: str = "none"
    emit: str = "mask"


@dataclasses.dataclass
class VerifyStats:
    """What the engine actually did (same fields and meaning as the
    reference's ``VerifyStats``).

    ``n_verifications`` is Σ_h |V_h|·|W_h| (the candidate pair area);
    ``n_exact`` the subset that reached exact evaluation after the filter.
    """

    n_verifications: int = 0  # Σ_h |V_h|·|W_h| (valid pair area)
    n_padded: int = 0  # Σ bucket tile area dispatched to exact evaluation
    n_dispatched: int = 0  # valid pair area of tiles that ran exact evaluation
    n_tiles: int = 0  # tiles that ran exact evaluation
    n_cells: int = 0  # non-empty cells
    n_hits: int = 0  # emitted (de-duplicated) hits
    n_pruned: int = 0  # valid pairs eliminated by the pivot filter / windows
    n_tiles_pruned: int = 0  # tiles skipped outright (every pair pruned)
    n_overflow_retries: int = 0  # compact-emission re-dispatches (overflow sentinel)
    prune: str = "none"  # resolved prune mode the engine actually ran
    emit: str = "mask"  # resolved emission path the engine actually ran
    bucket_shapes: set = dataclasses.field(default_factory=set)

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_shapes)

    @property
    def occupancy(self) -> float:
        """Valid / bucket-padded ratio of the exact-evaluation dispatch."""
        return self.n_dispatched / max(self.n_padded, 1)

    @property
    def n_exact(self) -> int:
        """Pairs that reached exact metric evaluation (post-filter)."""
        return self.n_verifications - self.n_pruned

    @property
    def prune_rate(self) -> float:
        """Fraction of candidate pairs the pivot filter eliminated."""
        return self.n_pruned / max(self.n_verifications, 1)


def apply_dedup(
    hits: Tensor, vids: Tensor, wids: Tensor, wcells: Tensor | None, cell_id: int,
    cross: bool = False,
) -> Tensor:
    """Mask a raw hit matrix down to the pairs this cell emits (the rule of
    ``ref.emit_mask``: min-cell + id order, or validity alone in R×S)."""
    return hits & ref.emit_mask(vids, wids, wcells, cell_id, cross=cross)


def pair_validity(vids: Tensor, wids: Tensor) -> Tensor:
    """(a, b) bool — True where both sides are real rows (padding id = -1)."""
    return (vids[:, None] >= 0) & (wids[None, :] >= 0)


def candidate_mask(
    pv: Tensor,
    pw: Tensor,
    vids: Tensor,
    wids: Tensor,
    delta: float,
    delta_bound: float | None = None,
) -> Tensor:
    """(a, b) bool — pivot-filter SURVIVORS among valid pairs: the L∞ lower
    bound over mapped coordinates within the (fp-slackened) threshold, and
    neither side padding. Hits are a subset of this mask when the caller
    passes the same ``delta_bound`` here and to the verify call."""
    return ref.bound_mask(pv, pw, delta, delta_bound) & pair_validity(vids, wids)


def plain_hits(x: Tensor, y: Tensor, delta: float, metric: str) -> Tensor:
    """``D <= delta`` by the plain path, for one tile (a, m) x (b, m) or a
    batch of tiles (B, a, m) x (B, b, m)."""
    if metric in ref.METRICS:
        return ref.pairdist_mask(x, y, delta, metric)
    return distances.pairwise(x, y, metric) <= delta


def tile_hits(
    xv: Tensor,
    xw: Tensor,
    *,
    delta: float,
    metric: str,
    backend: str,
    pv: Tensor | None = None,
    pw: Tensor | None = None,
    prune: str = "none",
    premask: Tensor | None = None,
    delta_bound: float | None = None,
) -> Tensor:
    """One tile's raw hit mask (a, b): (filter,) distances and threshold,
    before validity and de-dup.

    ``backend``/``prune`` must be resolved ("window" tiles pass "none").
    With ``prune="pivot"`` the hits are ANDed with the L∞ bound survivor
    mask — identical output (the bound never prunes a hit); the kernel
    recomputes the bound per block to skip exact work, the plain path
    reuses ``premask`` when given.
    """
    if prune == "pivot":
        assert pv is not None and pw is not None, 'prune="pivot" without coords'
        if backend == "cuda":
            return kops.pairdist_mask_filtered(
                xv, xw, pv, pw, delta, metric, delta_bound=delta_bound, backend="cuda"
            )
        bound = premask if premask is not None else ref.bound_mask(pv, pw, delta, delta_bound)
        return plain_hits(xv, xw, delta, metric) & bound
    if backend == "cuda":
        return kops.pairdist_mask(xv, xw, delta, metric, backend="cuda")
    return plain_hits(xv, xw, delta, metric)


def verify_tile(
    xv: Tensor,
    xw: Tensor,
    vids: Tensor,
    wids: Tensor,
    wcells: Tensor | None,
    cell_id: int,
    *,
    delta: float,
    metric: str,
    backend: str,
    cross: bool = False,
    pv: Tensor | None = None,
    pw: Tensor | None = None,
    prune: str = "none",
    premask: Tensor | None = None,
    delta_bound: float | None = None,
) -> Tensor:
    """One tile's verify as an (a, b) emission mask (reference
    ``verify_tile``): the raw hits of :func:`tile_hits` (``backend`` and
    ``prune`` resolved, "torch" | "cuda" for the reference's "numpy" |
    "pallas") after validity and the min-cell rule (:func:`apply_dedup`)."""
    hits = tile_hits(
        xv, xw, delta=delta, metric=metric, backend=backend, pv=pv, pw=pw,
        prune=prune, premask=premask, delta_bound=delta_bound,
    )
    return apply_dedup(hits, vids, wids, wcells, cell_id, cross=cross)


def verify_tile_compact(
    xv: Tensor,
    xw: Tensor,
    vids: Tensor,
    wids: Tensor,
    wcells: Tensor | None,
    cell_id: int,
    *,
    delta: float,
    metric: str,
    backend: str,
    capacity: int,
    cross: bool = False,
    pv: Tensor | None = None,
    pw: Tensor | None = None,
    prune: str = "none",
    delta_bound: float | None = None,
) -> tuple[Tensor, Tensor]:
    """One tile's fused verify + pair compaction (reference
    ``verify_tile_compact``): the verify side of :func:`tile_hits` plus
    validity and the min-cell rule, compacted into a (capacity, 2) int32
    buffer of GLOBAL id pairs padded with -1 (order unspecified). Returns
    ``(pairs, counts)`` with ``counts`` (2,) int32 = ``[count, n_cand]``:
    the TRUE number of emitted pairs (``count > capacity`` is the overflow
    sentinel) and the pivot-filter survivors (valid pairs when unpruned) —
    read back together, the tile's one read."""
    if prune == "pivot":
        assert pv is not None and pw is not None, 'prune="pivot" without coords'
    else:
        pv = pw = None
    pairs, count, n_cand = kops.verify_compact(
        xv, xw, vids, wids, wcells, cell_id, pv, pw, delta=delta, metric=metric,
        capacity=capacity, cross=cross, delta_bound=delta_bound, backend=backend,
    )
    return pairs, torch.stack([count, n_cand])


def resolve_engine_backend(backend: str, metric: str, x: Tensor) -> str:
    """Kernel-less metrics take the plain path even under an explicit
    "cuda" request (capability, not error)."""
    if not kops.supports_kernel(metric):
        return "torch"
    return kops.resolve_backend(backend, metric, x)


def prune_supported(metric: str) -> bool:
    """True when the pivot filter is sound for ``metric`` (a TRUE metric)."""
    m = distances.METRICS.get(metric)
    return m is not None and m.true_metric


def resolve_prune(prune: str, metric: str, have_coords: bool) -> str:
    """Resolve a prune request to "none" | "pivot" | "window"; an unsound
    metric falls back to "none", pruning without coordinates raises."""
    if prune not in ("none", "pivot", "window"):
        raise ValueError(
            f'unknown prune mode {prune!r}; expected "none" | "pivot" | "window"'
        )
    if prune != "none" and not have_coords:
        raise ValueError(
            f'prune={prune!r} requires the mapped coordinates (coords / coords_w)'
        )
    if prune != "none" and not prune_supported(metric):
        return "none"
    return prune


def resolve_emit(emit: str, metric: str) -> str:
    """Resolve an emission request to "mask" | "compact"; metrics without a
    kernel resolve compact back to "mask" (capability, not error)."""
    if emit not in ("mask", "compact"):
        raise ValueError(f'unknown emit mode {emit!r}; expected "mask" | "compact"')
    if emit == "compact" and metric not in ref.METRICS:
        return "mask"
    return emit


def prune_band(delta: float, metric: str, *arrays: Tensor | None) -> float:
    """The scale-aware prune threshold for a join over ``arrays``: one value
    per join (one device->host read), shared by every mask."""
    live = [a for a in arrays if a is not None and a.shape[0] > 0]
    if not live:
        return ref.prune_delta(delta, metric, 0.0, 0)
    x_abs = float(torch.stack([a.abs().max() for a in live]).max())
    n_feat = max(int(a.shape[1]) for a in live)
    return ref.prune_delta(delta, metric, x_abs, n_feat)


def bucket_size(n: int, cap: int, floor: int = 8) -> int:
    """Quantize a tile side to a bucket capacity: quarter-power-of-two steps
    (≤ 33% padding per axis, at most 4 shapes per octave)."""
    n = max(int(n), 1)
    if n >= cap:
        return cap
    octave = 1 << max(n - 1, 0).bit_length()  # smallest pow2 >= n
    quantum = max(octave // 4, floor)
    return min(cap, -(-n // quantum) * quantum)


# --- Compact-emission capacity sizing (the reference's knobs) --------------
#
# The pair buffer's capacity rides the quarter-pow2 bucket ladder. It is
# seeded from the cost model's bound-survival estimate (an overestimate of
# the hit rate, hence a conservative buffer), padded by a slack factor,
# floored, and grown online from observed per-tile counts. Module-level on
# purpose: tests monkeypatch them to force the overflow ladder.

DEFAULT_EMIT_RATE = 0.05  # prior hit fraction when no coordinate sample exists
EMIT_SLACK = 2.0  # capacity head-room multiplier over the estimated rate
_EMIT_FLOOR = 32  # minimum pre-bucket capacity, absorbs tiny-tile noise
_EMIT_SAMPLE = 256  # rows fed to the survival estimate (O(sample^2) pairs)
_MAX_OVERFLOW_RETRIES = 3  # capacity doublings before the mask-path fallback

# --- Batched window dispatch (plain path) ----------------------------------
#
# prune="window" cuts tiles small by design, so the plain path defers its
# tiles and verifies every same-bucket batch in one batched call (the
# reference's jit(vmap), written out as a batch dimension): one dispatch
# and one nonzero per bucket shape per flush. The area cap bounds resident
# mask memory; emission order does not matter (the final sort+unique
# canonicalizes), so flushing early is always safe.

_BATCH_FLUSH_AREA = 1 << 24  # max summed mask elements resident per flush


def _estimate_emit_rate(coords, delta: float) -> float:
    """Survival-rate prior for compact capacity sizing: the cost model's
    pivot-pair bound-survival fraction over a deterministic row subsample
    (an OVERestimate of the hit rate — the L∞ bound admits every hit)."""
    n = coords.shape[0]
    k = min(n, _EMIT_SAMPLE)
    if k < 2:
        return 1.0
    idx = np.linspace(0, n - 1, k).astype(np.int64)
    if isinstance(coords, Tensor):
        sample = coords[torch.as_tensor(idx, device=coords.device)].cpu().numpy()
    else:
        sample = np.asarray(coords)[idx]
    rate = cost_model.estimate_survival_rate(sample.astype(np.float32), delta)
    return float(min(max(rate, 1.0 / (k * k)), 1.0))


def _pad0(t: Tensor, cap: int, value) -> Tensor:
    """``t`` padded along dim 0 to ``cap`` rows of ``value``."""
    if t.shape[0] == cap:
        return t
    fill = torch.full((cap - t.shape[0], *t.shape[1:]), value, dtype=t.dtype, device=t.device)
    return torch.cat([t, fill])


def _flush_window_batch(
    pending: list[tuple],
    delta: float,
    metric: str,
    cross: bool,
    stats: VerifyStats,
    chunks: list[Tensor],
    return_pairs: bool,
) -> None:
    """Verify the deferred window tiles: stack the same-bucket tiles padded
    to their bucket shape (ids -1), one batched plain verify per bucket
    shape, one ``nonzero``, then the emission rule on the hit list."""
    groups: dict[tuple[int, int], list[tuple]] = {}
    for t in pending:
        groups.setdefault((t[6], t[7]), []).append(t)
    for (cap_v, cap_w), tiles in groups.items():
        xv = torch.stack([_pad0(t[0], cap_v, 0.0) for t in tiles])
        xw = torch.stack([_pad0(t[1], cap_w, 0.0) for t in tiles])
        vids = torch.stack([_pad0(t[2], cap_v, -1) for t in tiles])
        wids = torch.stack([_pad0(t[3], cap_w, -1) for t in tiles])
        hs = torch.as_tensor([t[5] for t in tiles], device=xv.device)
        bi, vi, wi = torch.nonzero(plain_hits(xv, xw, delta, metric), as_tuple=True)
        vh, wh = vids[bi, vi], wids[bi, wi]
        wch = None if cross else torch.stack([_pad0(t[4], cap_w, -1) for t in tiles])[bi, wi]
        keep = ref.emit_keep(vh, wh, wch, hs[bi], cross)
        vh, wh = vh[keep], wh[keep]
        stats.n_hits += int(vh.numel())
        if return_pairs and vh.numel():
            chunks.append(torch.stack([vh, wh], dim=1))
    pending.clear()


def _as_rows(x, device: torch.device | None = None) -> Tensor:
    t = x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device if device is not None else t.device, dtype=torch.float32)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def verify_cell_lists(
    data,
    cells_of,
    v_lists: Sequence[np.ndarray],
    w_lists: Sequence[np.ndarray],
    delta: float,
    metric: str,
    *,
    config: EngineConfig = EngineConfig(),
    return_pairs: bool = True,
    data_w=None,
    coords=None,
    coords_w=None,
    ids=None,
    ids_w=None,
    cell_ids: Sequence[int] | None = None,
    delta_bound: float | None = None,
) -> tuple[np.ndarray, VerifyStats]:
    """Run the full reduce phase over explicit per-cell index sets.

    ``data``: (N, m) objects (tensor; its device is where the engine runs);
    ``cells_of``: (N,) kernel cell per object (read only in a self-join);
    ``v_lists[h]`` / ``w_lists[h]``: row indices of V_h / W_h (host
    arrays). Returns (pairs (n_pairs, 2) int64 sorted unique, stats).
    ``data_w`` switches to R×S (``w_lists`` then index ``data_w``).
    ``coords`` / ``coords_w``: the mapped coordinates, required for
    ``prune`` "pivot" | "window".

    A row's index is its id unless ``ids`` (N,) / ``ids_w`` (rows of
    ``data_w``) give the global ids: the de-dup order and the emitted pairs
    then use those (the distributed executor verifies received slots whose
    rows are not in id order). ``cell_ids[h]``: the cell id list h is
    verified as (default h). ``delta_bound``: the pivot filter's band for
    the whole join (default: from these rows, ``prune_band``).
    """
    data_t = _as_rows(data)
    device = data_t.device
    cross = data_w is not None
    data_w_t = _as_rows(data_w, device) if cross else data_t
    backend = resolve_engine_backend(config.backend, metric, data_t)
    have_coords = coords is not None and (not cross or coords_w is not None)
    prune = resolve_prune(config.prune, metric, have_coords)
    emit = resolve_emit(config.emit, metric)
    if prune == "none":
        delta_bound = None  # no filter runs: the emission prior reads delta
    else:
        coords_t = _as_rows(coords, device)
        coords_w_t = _as_rows(coords_w, device) if cross else coords_t
        # One host copy of the coordinates for the control plane.
        coords_np = _host(coords_t)
        coords_w_np = _host(coords_w_t) if cross else coords_np
        if delta_bound is None:
            delta_bound = prune_band(delta, metric, data_t, data_w_t if cross else None)
    # Which tiles carry the on-device pair buffer (the reference's rule with
    # "cuda" for "pallas"): the kernel backend always; the plain path only
    # under "pivot", where the buffer's counters carry the survivor count.
    # Everything else lowers compact emission to the mask dispatch.
    buffered = emit == "compact" and (backend == "cuda" or prune == "pivot")
    # Batched window dispatch on the plain path (_flush_window_batch); the
    # kernel path launches per tile.
    batch_w = prune == "window" and backend != "cuda"
    pending: list[tuple] = []
    pending_area = 0
    emit_rate = DEFAULT_EMIT_RATE
    id_t = None if ids is None else torch.as_tensor(ids).to(device=device, dtype=torch.int64)
    id_w_t = id_t if not cross else (
        None if ids_w is None else torch.as_tensor(ids_w).to(device=device, dtype=torch.int64)
    )
    if buffered:
        if max(data_t.shape[0], data_w_t.shape[0]) >= 2**31 or any(
            t is not None and t.numel() and int(t.max()) >= 2**31 for t in (id_t, id_w_t)
        ):
            raise ValueError('emit="compact" carries int32 ids: at most 2**31 - 1 rows')
        if coords is not None:
            emit_rate = _estimate_emit_rate(
                coords, float(delta_bound if delta_bound is not None else delta)
            )
    cells_t = None
    if not cross:
        cells_t = cells_of if isinstance(cells_of, Tensor) else torch.from_numpy(np.array(cells_of))
        cells_t = cells_t.to(device=device, dtype=torch.int64)
    stats = VerifyStats(prune=prune, emit=emit)
    chunks: list[Tensor] = []

    for i_cell, (v_idx, w_idx) in enumerate(zip(v_lists, w_lists)):
        h = i_cell if cell_ids is None else int(cell_ids[i_cell])
        v_idx = np.asarray(v_idx, np.int64)
        w_idx = np.asarray(w_idx, np.int64)
        if v_idx.size == 0 or w_idx.size == 0:
            continue
        stats.n_cells += 1
        stats.n_verifications += int(v_idx.size) * int(w_idx.size)
        if prune != "none":
            # Order both sides by the mapped coordinate this cell's W rows
            # spread widest on: V tiles become coordinate bands and the
            # searchsorted below cuts each one's W range to its window.
            wc_all = coords_w_np[w_idx]
            sort_dim = int((wc_all.max(axis=0) - wc_all.min(axis=0)).argmax())
            v_idx = v_idx[np.argsort(coords_np[v_idx, sort_dim], kind="stable")]
            word = np.argsort(wc_all[:, sort_dim], kind="stable")
            w_idx = w_idx[word]
            w_coords_cell = wc_all[word]
            w_coord0 = w_coords_cell[:, sort_dim]
            v_coords_cell = coords_np[v_idx]
        # One gather per cell on the device; every tile is a slice.
        v_pos = torch.as_tensor(v_idx, device=device)
        w_pos = torch.as_tensor(w_idx, device=device)
        v_rows = data_t.index_select(0, v_pos)
        w_rows = data_w_t.index_select(0, w_pos)
        w_cells = None if cross else cells_t.index_select(0, w_pos)
        v_ids = v_pos if id_t is None else id_t.index_select(0, v_pos)
        w_ids = w_pos if id_w_t is None else id_w_t.index_select(0, w_pos)
        if buffered:  # the kernel's int32 ids (checked above: all < 2**31)
            v_ids, w_ids = v_ids.to(torch.int32), w_ids.to(torch.int32)
            w_cells = None if cross else w_cells.to(torch.int32)
        if prune == "pivot":
            v_pc = coords_t.index_select(0, v_pos)
            w_pc = coords_w_t.index_select(0, w_pos)
        w_tiles = None
        if prune == "none":
            w_tiles = [
                (w0, min(w0 + config.tile_w, w_idx.size), None)
                for w0 in range(0, w_idx.size, config.tile_w)
            ]
        for v0 in range(0, v_idx.size, config.tile_v):
            v1 = min(v0 + config.tile_v, v_idx.size)
            nv = v1 - v0
            cap_v = bucket_size(nv, config.tile_v, config.min_bucket)
            v_box = None
            if prune != "none":
                v_coords = v_coords_cell[v0:v1]
                v_box = (v_coords.min(axis=0), v_coords.max(axis=0))
                vc = v_coords[:, sort_dim]
                lo = int(np.searchsorted(w_coord0, vc.min() - delta_bound, "left"))
                hi = int(np.searchsorted(w_coord0, vc.max() + delta_bound, "right"))
                # W rows outside [lo, hi) exceed delta_bound on one
                # 1-Lipschitz coordinate: pruned with no gather, no launch.
                stats.n_pruned += nv * int(w_idx.size - (hi - lo))
                if lo == hi:
                    continue
                w_tiles = []
                for w0 in range(lo, hi, config.tile_w):
                    w1 = min(w0 + config.tile_w, hi)
                    cw = w_coords_cell[w0:w1]
                    w_tiles.append((w0, w1, (cw.min(axis=0), cw.max(axis=0))))
            for w0, w1, w_box in w_tiles:
                nw = w1 - w0
                cap_w = bucket_size(nw, config.tile_w, config.min_bucket)
                n_valid = nv * nw
                if v_box is not None and w_box is not None:
                    # Bounding-box tile skip: the gap between the boxes
                    # lower-bounds every pair's L∞ bound.
                    gap = np.maximum(w_box[0] - v_box[1], v_box[0] - w_box[1]).max()
                    if gap > delta_bound:
                        stats.n_pruned += n_valid
                        stats.n_tiles_pruned += 1
                        continue
                vids = v_ids[v0:v1]
                wids = w_ids[w0:w1]
                wcs = None if cross else w_cells[w0:w1]
                pv = pw = premask = None
                if prune == "pivot":
                    pv, pw = v_pc[v0:v1], w_pc[w0:w1]
                if emit == "mask" and prune == "pivot":
                    # Candidate pre-pass (every row of these tiles is real, so
                    # the candidates are the bound survivors): one broadcast
                    # over the few mapped dimensions. Compact emission skips
                    # it — its filter runs in the tile and the survivor count
                    # comes back in-band.
                    cand = (pv[:, None, :] - pw[None, :, :]).abs_().amax(-1) <= delta_bound
                    # The whole-tile skip decision is a device->host read.
                    n_cand = int(cand.sum())
                    stats.n_pruned += n_valid - n_cand
                    if n_cand == 0:
                        stats.n_tiles_pruned += 1
                        continue
                    if backend != "cuda":
                        premask = cand  # the plain path reuses the bound
                stats.n_tiles += 1
                stats.n_padded += cap_v * cap_w
                stats.n_dispatched += n_valid
                stats.bucket_shapes.add((cap_v, cap_w))
                if batch_w:
                    pending.append((v_rows[v0:v1], w_rows[w0:w1], vids, wids, wcs, h, cap_v, cap_w))
                    pending_area += cap_v * cap_w
                    if pending_area >= _BATCH_FLUSH_AREA:
                        _flush_window_batch(
                            pending, float(delta), metric, cross, stats, chunks, return_pairs
                        )
                        pending_area = 0
                    continue
                # "window" prunes on the host (above); its tile runs the
                # plain verify — no per-pair bound.
                tile_prune = "pivot" if prune == "pivot" else "none"
                tile_band = delta_bound if tile_prune == "pivot" else None
                mode = "compact" if buffered else "mask"
                cap_pairs = 0
                if mode == "compact":
                    cap_pairs = bucket_size(
                        int(n_valid * min(emit_rate * EMIT_SLACK, 1.0)) + _EMIT_FLOOR,
                        cap_v * cap_w,
                    )
                tile_counts = None
                for attempt in range(_MAX_OVERFLOW_RETRIES + 2):
                    if mode != "compact":
                        hits = tile_hits(
                            v_rows[v0:v1], w_rows[w0:w1],
                            delta=float(delta), metric=metric, backend=backend,
                            pv=pv, pw=pw, prune=tile_prune, premask=premask,
                            delta_bound=tile_band,
                        )
                        break
                    pairs_dev, counts_dev = verify_tile_compact(
                        v_rows[v0:v1], w_rows[w0:w1], vids, wids, wcs, h,
                        delta=float(delta), metric=metric, backend=backend,
                        capacity=cap_pairs, cross=cross, pv=pv, pw=pw,
                        prune=tile_prune, delta_bound=tile_band,
                    )
                    tile_counts = tuple(counts_dev.tolist())  # the tile's one read
                    if tile_counts[0] <= cap_pairs:
                        break
                    # Overflow sentinel: the buffer is unspecified but the
                    # count is the TRUE total, so the retry bucket is sized
                    # in one step. Bounded retries, then the mask path.
                    stats.n_overflow_retries += 1
                    if attempt >= _MAX_OVERFLOW_RETRIES:
                        mode = "mask"
                    else:
                        cap_pairs = bucket_size(max(tile_counts[0], 2 * cap_pairs), cap_v * cap_w)
                if mode == "compact":
                    count, n_cand = tile_counts
                    if prune == "pivot":
                        stats.n_pruned += n_valid - n_cand
                    # Grow the prior from observed hit rates so one hot tile
                    # does not turn into a retry per tile downstream.
                    emit_rate = max(emit_rate, count / max(n_valid, 1))
                    stats.n_hits += count
                    if return_pairs and count:
                        chunks.append(pairs_dev[:count].to(torch.int64))
                    continue
                if tile_counts is not None and prune == "pivot":
                    # Overflow fallback: the last compact launch already
                    # reported the survivor count.
                    stats.n_pruned += n_valid - tile_counts[1]
                # Hits are sparse: compact first (the one readback of the
                # tile), then apply the emission rule to the hit list only.
                vi, wi = torch.nonzero(hits, as_tuple=True)
                vh, wh = vids[vi].long(), wids[wi].long()
                keep = ref.emit_keep(vh, wh, None if cross else wcs[wi], h, cross)
                vh, wh = vh[keep], wh[keep]
                stats.n_hits += int(vh.numel())
                if return_pairs and vh.numel():
                    chunks.append(torch.stack([vh, wh], dim=1))

    if pending:
        _flush_window_batch(pending, float(delta), metric, cross, stats, chunks, return_pairs)
    if not chunks:
        return np.zeros((0, 2), np.int64), stats
    # Each pair is emitted once; sort+unique canonicalizes the order (and
    # is the reference's invariant). Cross pairs index different sets.
    pairs = torch.cat(chunks)
    if not cross:
        pairs = torch.sort(pairs, dim=1).values
    pairs = torch.unique(pairs, dim=0)
    return pairs.cpu().numpy().astype(np.int64), stats


def verify_resident(
    data,
    cells_of,
    v_lists: Sequence[np.ndarray],
    member_w,
    delta: float,
    metric: str,
    *,
    config: EngineConfig = EngineConfig(),
    data_w,
    coords=None,
    coords_w=None,
) -> tuple[np.ndarray, VerifyStats]:
    """Delta-vs-resident cross verify: W rows come from a whole-membership
    matrix (|W|, p) over ``data_w`` (a routed query batch or an insertion
    delta), V rows from the RESIDENT per-cell index lists — the one tile
    path both ``MetricIndex.query_batch`` and ``insert_batch`` stream
    through. Pairs come back as (i ∈ resident, j ∈ delta), R×S semantics.
    """
    member_np = _host(member_w).astype(bool)
    w_lists = [np.flatnonzero(member_np[:, h]) for h in range(len(v_lists))]
    return verify_cell_lists(
        data, cells_of, v_lists, w_lists, delta, metric,
        config=config, data_w=data_w, coords=coords, coords_w=coords_w,
    )


def verify_pairs(
    data,
    cells,
    member,
    delta: float,
    metric: str,
    *,
    config: EngineConfig = EngineConfig(),
    return_pairs: bool = True,
    data_w=None,
    coords=None,
    coords_w=None,
    delta_bound: float | None = None,
) -> tuple[np.ndarray, VerifyStats]:
    """Reduce phase from a kernel-cell assignment + whole-membership matrix.

    Self-join: ``cells`` (N,) cell id of ``data``; ``member`` (N, p) bool
    whole membership of the same rows. R×S: ``data``/``cells`` describe R;
    ``data_w`` is S and ``member`` S's whole membership. Derives the
    per-cell index sets on the host and streams them through
    :func:`verify_cell_lists` (``delta_bound`` as there).
    """
    cells_np = _host(cells)
    member_np = _host(member)
    p = member_np.shape[1]
    order = np.argsort(cells_np, kind="stable")
    bounds = np.searchsorted(cells_np[order], np.arange(p + 1))
    v_lists = [order[bounds[h] : bounds[h + 1]] for h in range(p)]
    w_lists = [np.flatnonzero(member_np[:, h]) for h in range(p)]
    return verify_cell_lists(
        data, cells_np, v_lists, w_lists, delta, metric,
        config=config, return_pairs=return_pairs, data_w=data_w,
        coords=coords, coords_w=coords_w, delta_bound=delta_bound,
    )


def reference_verify(
    data,
    cells,
    member,
    delta: float,
    metric: str,
    *,
    return_pairs: bool = True,
) -> tuple[np.ndarray, int]:
    """The seed's dense per-cell reduce loop (reference
    ``reference_verify``), kept as the oracle: one plain pairwise matrix
    per cell on ``data``'s device, no tiling, no filter. Returns (pairs
    (n_pairs, 2) int64 sorted unique, n_verifications)."""
    allx = data if isinstance(data, Tensor) else torch.as_tensor(np.asarray(data))
    cells_np = _host(cells)
    member_np = _host(member)
    metric_fn = distances.get_metric(metric)
    n_verif = 0
    chunks: list[np.ndarray] = []
    for h in range(member_np.shape[1]):
        v_idx = np.flatnonzero(cells_np == h)
        w_idx = np.flatnonzero(member_np[:, h])
        if v_idx.size == 0 or w_idx.size == 0:
            continue
        n_verif += int(v_idx.size) * int(w_idx.size)
        rows_v = allx[torch.as_tensor(v_idx, device=allx.device)]
        rows_w = allx[torch.as_tensor(w_idx, device=allx.device)]
        hit_v, hit_w = np.nonzero(_host(metric_fn.pairwise(rows_v, rows_w) <= delta))
        gi = v_idx[hit_v]
        gj = w_idx[hit_w]
        cj = cells_np[gj]
        keep = ((cj == h) & (gi < gj)) | (cj > h)
        if return_pairs and keep.any():
            chunks.append(np.stack([gi[keep], gj[keep]], axis=1))
    if chunks:
        pairs = np.unique(np.sort(np.concatenate(chunks), axis=1), axis=0)
    else:
        pairs = np.zeros((0, 2), np.int64)
    return pairs.astype(np.int64), n_verif
