"""Streaming tiled verify engine — the reduce phase of SP-Join, on the device.

The reduce phase (paper §5) checks every kernel-partition row V_h against
every whole-partition row W_h: Σ_h |V_h|·|W_h| distance evaluations. Each
cell's |V_h| × |W_h| rectangle is cut into tiles of at most
``tile_v × tile_w`` and streamed, so the working set is O(tile).

Port of ``repro.core.verify`` with the same schedule and the same counters:

  * Tiles are accounted at the reference's quarter-power-of-two *bucket*
    shapes (``bucket_size``), so ``VerifyStats.n_padded`` / ``occupancy`` /
    ``bucket_shapes`` are the reference's. The kernels mask their own
    ragged edges, so no tile is actually padded on the device.
  * Data, mapped coordinates and tiles stay on the device: each cell's V and
    W rows are gathered once with index tensors (in window order under
    pruning) and every tile is a contiguous slice of those buffers. Only
    the hits come back: the per-tile mask is compacted on the device
    (``nonzero``) and the id pairs stay there until the final sort/unique.
  * The control plane — cell index lists, the per-cell sort dimension, the
    ``± delta_bound`` windows and the bounding-box tile skips — runs on host
    numpy over one host copy of the coordinates, exactly as the reference
    does, so every decision and counter is the reference's.
  * ``prune="pivot"`` (the default) runs the candidate pre-pass per tile
    (the L∞ bound over mapped coordinates, plain PyTorch on the device); its
    count is read back once per tile — the whole-tile skip decision — and a
    surviving tile runs the fused filtered pairdist kernel, which skips the
    exact work per 64x64 block the bound prunes. ``prune="none"`` runs the
    plain pairdist kernel.

De-dup rule: a hit (i, j) with cell(i) = g, cell(j) = h is emitted by cell
min(g, h) only; within one cell keep id_i < id_j (``ref.emit_mask``). R×S
(``data_w`` given): V rows from R's kernel cells, W rows from S's whole
membership; validity alone, pairs are (i ∈ R, j ∈ S).

Not yet ported (ROADMAP queue 1, the ``prune="window"`` / ``emit="compact"``
item): the host-only window mode and on-device pair compaction raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import distances
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref

Tensor = torch.Tensor

_NOT_PORTED = "is not ported yet (ROADMAP queue 1: window prune and compact emission)"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs for the streaming engine.

    ``backend``: "torch" | "cuda" | "auto" (see ``kernels.ops``). Metrics
    without a kernel (angular, jaccard_minhash) always take the plain path.
    ``tile_v`` / ``tile_w``: streaming tile capacity (rows per side).
    ``min_bucket``: smallest bucket side in the tile accounting.
    ``prune``: "none" | "pivot" — pivot-filter pruning (L∞ lower bound over
    mapped coordinates); metrics without the triangle inequality resolve
    back to "none". ``emit``: "mask" (host readback of the hits).
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
    n_overflow_retries: int = 0  # compact-emission re-dispatches (always 0 here)
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

    ``backend``/``prune`` must be resolved. With ``prune="pivot"`` the hits
    are ANDed with the L∞ bound survivor mask — identical output (the bound
    never prunes a hit); the kernel recomputes the bound per block to skip
    exact work, the plain path reuses ``premask`` when given.
    """
    if prune == "pivot":
        assert pv is not None and pw is not None, 'prune="pivot" without coords'
        if backend == "cuda":
            hits = kops.pairdist_mask_filtered(
                xv, xw, pv, pw, delta, metric, delta_bound=delta_bound, backend="cuda"
            )
        else:
            bound = premask if premask is not None else ref.bound_mask(pv, pw, delta, delta_bound)
            if metric in ref.METRICS:
                hits = ref.pairdist_mask(xv, xw, delta, metric) & bound
            else:
                hits = (distances.pairwise(xv, xw, metric) <= delta) & bound
    elif backend == "cuda":
        hits = kops.pairdist_mask(xv, xw, delta, metric, backend="cuda")
    elif metric in ref.METRICS:
        hits = ref.pairdist_mask(xv, xw, delta, metric)
    else:
        hits = distances.pairwise(xv, xw, metric) <= delta
    return hits


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
    """Resolve a prune request to "none" | "pivot"; an unsound metric falls
    back to "none", pruning without coordinates raises."""
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
    if prune == "window":
        raise NotImplementedError(f'prune="window" {_NOT_PORTED}')
    return prune


def resolve_emit(emit: str, metric: str) -> str:
    """Resolve an emission request; reference-only metrics resolve compact
    back to "mask" as in the reference, compact itself is not ported."""
    if emit not in ("mask", "compact"):
        raise ValueError(f'unknown emit mode {emit!r}; expected "mask" | "compact"')
    if emit == "compact" and metric not in ref.METRICS:
        return "mask"
    if emit == "compact":
        raise NotImplementedError(f'emit="compact" {_NOT_PORTED}')
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
) -> tuple[np.ndarray, VerifyStats]:
    """Run the full reduce phase over explicit per-cell index sets.

    ``data``: (N, m) objects (tensor; its device is where the engine runs);
    ``cells_of``: (N,) kernel cell per object; ``v_lists[h]`` /
    ``w_lists[h]``: global row indices of V_h / W_h (host arrays). Returns
    (pairs (n_pairs, 2) int64 sorted unique, stats). ``data_w`` switches to
    R×S (``w_lists`` then index ``data_w``). ``coords`` / ``coords_w``: the
    mapped coordinates, required for ``prune="pivot"``.
    """
    data_t = _as_rows(data)
    device = data_t.device
    cells_np = _host(cells_of)
    cross = data_w is not None
    data_w_t = _as_rows(data_w, device) if cross else data_t
    backend = resolve_engine_backend(config.backend, metric, data_t)
    have_coords = coords is not None and (not cross or coords_w is not None)
    prune = resolve_prune(config.prune, metric, have_coords)
    emit = resolve_emit(config.emit, metric)
    delta_bound = None
    if prune != "none":
        coords_t = _as_rows(coords, device)
        coords_w_t = _as_rows(coords_w, device) if cross else coords_t
        # One host copy of the coordinates for the control plane.
        coords_np = coords_t.cpu().numpy()
        coords_w_np = coords_w_t.cpu().numpy() if cross else coords_np
        delta_bound = prune_band(delta, metric, data_t, data_w_t if cross else None)
    cells_t = None if cross else torch.as_tensor(cells_np, device=device).to(torch.int64)
    stats = VerifyStats(prune=prune, emit=emit)
    chunks: list[Tensor] = []

    for h, (v_idx, w_idx) in enumerate(zip(v_lists, w_lists)):
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
        v_ids = torch.as_tensor(v_idx, device=device)
        w_ids = torch.as_tensor(w_idx, device=device)
        v_rows = data_t.index_select(0, v_ids)
        w_rows = data_w_t.index_select(0, w_ids)
        w_cells = None if cross else cells_t.index_select(0, w_ids)
        if prune == "pivot":
            v_pc = coords_t.index_select(0, v_ids)
            w_pc = coords_w_t.index_select(0, w_ids)
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
                pv = pw = premask = None
                if prune == "pivot":
                    pv, pw = v_pc[v0:v1], w_pc[w0:w1]
                    # Every row of these tiles is real (no padding), so the
                    # candidates are the bound survivors: one broadcast over
                    # the few mapped dimensions.
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
                hits = tile_hits(
                    v_rows[v0:v1], w_rows[w0:w1],
                    delta=float(delta), metric=metric, backend=backend,
                    pv=pv, pw=pw, prune=prune, premask=premask,
                    delta_bound=delta_bound if prune == "pivot" else None,
                )
                # Hits are sparse: compact first (the one readback of the
                # tile), then apply the emission rule to the hit list only.
                vi, wi = torch.nonzero(hits, as_tuple=True)
                vh, wh = vids[vi], wids[wi]
                keep = ref.emit_keep(vh, wh, None if cross else w_cells[w0:w1][wi], h, cross)
                vh, wh = vh[keep], wh[keep]
                stats.n_hits += int(vh.numel())
                if return_pairs and vh.numel():
                    chunks.append(torch.stack([vh, wh], dim=1))

    if not chunks:
        return np.zeros((0, 2), np.int64), stats
    # Each pair is emitted once; sort+unique canonicalizes the order (and
    # is the reference's invariant). Cross pairs index different sets.
    pairs = torch.cat(chunks)
    if not cross:
        pairs = torch.sort(pairs, dim=1).values
    pairs = torch.unique(pairs, dim=0)
    return pairs.cpu().numpy().astype(np.int64), stats


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
) -> tuple[np.ndarray, VerifyStats]:
    """Reduce phase from a kernel-cell assignment + whole-membership matrix.

    Self-join: ``cells`` (N,) cell id of ``data``; ``member`` (N, p) bool
    whole membership of the same rows. R×S: ``data``/``cells`` describe R;
    ``data_w`` is S and ``member`` S's whole membership. Derives the
    per-cell index sets on the host and streams them through
    :func:`verify_cell_lists`.
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
        coords=coords, coords_w=coords_w,
    )
