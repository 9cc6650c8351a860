"""Persistent metric index: build once, query many times (serving phase).

Port of ``repro.core.index`` (single host). ``build_index`` runs the
control plane once — sampling → anchors → kernel boxes → per-cell member
MBBs → cost-model placement plan — with the same helpers as
``spjoin.join``, and keeps R's rows, mapped coordinates and kernel cells.
``MetricIndex.query_batch`` routes a query batch through the fused
map-assign kernel (its anchor distances are both the routing coordinates
and the pivot-filter coordinates) and verifies it against the resident
cells in R×S mode through the tiled engine; no sampling, fitting or
partitioning happens at query time. ``insert_batch`` absorbs a delta the
same way (ΔR×R_old against the resident cells, ΔR×ΔR under the widened
member MBBs) and runs the drift monitor (re-plan or re-sample).

Where the state lives: ``data``, ``coords`` and ``cells`` are tensors on
the index's device (the card unless the caller asks for the CPU); the
control plane — pivots, anchors, boxes, the per-cell V lists and the
placement plan — is host numpy.

δ at query time: the index stores the PRE-expansion base boxes (the member
MBB of each cell, or the kernel box without tightening) and expands them by
the query radius, so any ``delta`` answers exactly.

On-disk format: the reference's own (``manifest.json`` + ``arrays.npz``,
``FORMAT_VERSION = 2``), so an index built by either package loads into the
other. ``backend`` is written in the reference's vocabulary ("numpy" |
"pallas") and translated on load ("torch" | "cuda"; a "cuda" index loaded
onto the CPU runs the plain path).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import cost_model, mapping, partition, spjoin
from repro_torch.core import placement as placement_lib
from repro_torch.core import verify as verify_lib
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor

FORMAT_NAME = "spjoin-metric-index"
# Version 2 carries the incremental-insert state: the manifest's
# "incremental" block (n_base / n_inserted / n_batches) and the observed_w
# drift telemetry array. Version-1 artifacts are refused.
FORMAT_VERSION = 2

# Arrays persisted bit-exact in arrays.npz (name -> MetricIndex attribute).
_ARRAYS = (
    "data", "coords", "cells", "pivots", "anchors",
    "kernel_lo", "kernel_hi", "box_lo", "box_hi", "observed_w",
)
_PLAN_ARRAYS = (
    "cell_loads", "cell_first_slot", "cell_n_slabs",
    "slot_cell", "slot_slab", "slot_load", "dispatch_of_slot",
)
# The manifest's backend words are the reference's.
_TO_REFERENCE = {"torch": "numpy", "cuda": "pallas"}
_FROM_REFERENCE = {v: k for k, v in _TO_REFERENCE.items()}


class IndexFormatError(ValueError):
    """The on-disk artifact is not a metric index this code can read."""


class IndexMismatchError(ValueError):
    """The manifest disagrees with the caller's expected query config."""


@dataclasses.dataclass
class QueryStats:
    """Telemetry of one ``query_batch`` call (embeds the engine's
    ``VerifyStats`` as ``verify``)."""

    n_queries: int = 0
    n_routed: int = 0  # Σ per-query owning-cell memberships (dispatch fan-out)
    n_cells_touched: int = 0  # cells that received ≥ 1 query
    route_s: float = 0.0  # map-assign + membership time
    verify_s: float = 0.0  # tiled engine time
    verify: verify_lib.VerifyStats | None = None

    @property
    def duplication(self) -> float:
        """Σ memberships / |Q| — the query-side routing amplification."""
        return self.n_routed / max(self.n_queries, 1)


@dataclasses.dataclass
class StreamStats:
    """Telemetry of one ``insert_batch`` call plus the drift monitor's
    decision trail (same fields and meaning as the reference's)."""

    n_delta: int = 0  # rows in this insertion batch
    n_resident: int = 0  # rows resident before the insert
    n_total: int = 0  # rows resident after the insert
    n_cross_pairs: int = 0  # ΔR×R_old pairs emitted
    n_self_pairs: int = 0  # ΔR×ΔR pairs emitted
    n_new_pairs: int = 0  # total pairs this batch contributed
    drift: float = 0.0
    replan_threshold: float = 0.0
    resample_threshold: float = 0.0
    action: str = "none"
    resample_due: bool = False
    balance_std_before: float = 0.0
    balance_std_after: float = 0.0
    route_s: float = 0.0  # fused delta map-assign time
    verify_s: float = 0.0  # cross + self verify time
    update_s: float = 0.0  # absorb + drift bookkeeping time
    cross_verify: verify_lib.VerifyStats | None = None
    self_verify: verify_lib.VerifyStats | None = None


def _rows(x, device: torch.device) -> Tensor:
    t = x if isinstance(x, Tensor) else torch.from_numpy(np.array(x, np.float32))
    return t.to(device=device, dtype=torch.float32)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def _member_matrix(
    coords: Tensor, wlo: np.ndarray, whi: np.ndarray, chunk: int = 65536
) -> Tensor:
    """(n, p) bool whole membership of mapped coordinates under the given
    closed boxes — the comparison the fused kernel packs into its bits,
    evaluated from CACHED coordinates (no re-map), in row chunks."""
    lo = torch.as_tensor(wlo, device=coords.device)
    hi = torch.as_tensor(whi, device=coords.device)
    out = torch.empty((coords.shape[0], lo.shape[0]), dtype=torch.bool, device=coords.device)
    for i0 in range(0, coords.shape[0], chunk):
        c = coords[i0 : i0 + chunk, None, :]
        out[i0 : i0 + chunk] = ((c >= lo[None]) & (c <= hi[None])).all(-1)
    return out


def _member_counts(coords: Tensor, wlo: np.ndarray, whi: np.ndarray) -> np.ndarray:
    """(p,) float64 per-cell whole-member counts (drift telemetry baseline)."""
    return _member_matrix(coords, wlo, whi).sum(0).cpu().numpy().astype(np.float64)


@dataclasses.dataclass
class MetricIndex:
    """Everything the query phase needs, with the build phase paid once."""

    # -- build config (the manifest scalars) --------------------------------
    metric: str
    delta: float  # build-time default query radius
    n_dims: int
    tighten: bool
    backend: str  # resolved backend ("torch" | "cuda") the build mapped with
    prune: str  # requested prune mode
    map_fused: bool
    tile_v: int
    tile_w: int
    seed: int
    placement_strategy: str
    n_devices: int  # devices the stored placement plan targets

    # -- build artifacts ----------------------------------------------------
    data: Tensor  # (N, m) the indexed set R, on the index's device
    coords: Tensor  # (N, n) R's mapped coordinates (pivot distances)
    cells: Tensor  # (N,) int32 kernel cell of each R row
    pivots: np.ndarray  # (k, m) sampled pivots
    anchors: np.ndarray  # (n, m) anchor pivots of the space map
    kernel_lo: np.ndarray  # (p, n) half-open kernel boxes
    kernel_hi: np.ndarray
    box_lo: np.ndarray  # (p, n) PRE-expansion whole-box base
    box_hi: np.ndarray
    placement: placement_lib.PlacementPlan
    build_s: float = 0.0
    node_confidences: np.ndarray | None = None

    # -- incremental-insert state (persisted, format v2) --------------------
    n_base: int = 0  # rows the initial build indexed
    n_inserted: int = 0  # rows appended by insert_batch since build/rebuild
    n_batches: int = 0  # insert_batch calls absorbed (survives rebuilds)
    observed_w: np.ndarray | None = None  # (p,) observed whole-member counts

    # -- derived host caches (never persisted) ------------------------------
    _v_lists: list[np.ndarray] | None = dataclasses.field(default=None, repr=False)

    # ------------------------------------------------------------------ api

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def n_rows(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.data.shape[1])

    @property
    def k(self) -> int:
        return int(self.pivots.shape[0])

    @property
    def p(self) -> int:
        return int(self.kernel_lo.shape[0])

    @property
    def space_map(self) -> mapping.SpaceMap:
        return mapping.SpaceMap(torch.as_tensor(self.anchors, device=self.device), self.metric)

    @property
    def v_lists(self) -> list[np.ndarray]:
        """Per-cell V row lists (global R indices), computed once per index."""
        if self._v_lists is None:
            cells = _np(self.cells)
            order = np.argsort(cells, kind="stable")
            bounds = np.searchsorted(cells[order], np.arange(self.p + 1))
            self._v_lists = [order[bounds[h] : bounds[h + 1]] for h in range(self.p)]
        return self._v_lists

    def _dev(self, a: np.ndarray) -> Tensor:
        return torch.as_tensor(a, device=self.device)

    def query_boxes(self, band: float) -> tuple[np.ndarray, np.ndarray]:
        """The whole boxes expanded by ``band``. With ``band`` = δ this is the
        expression the build would have produced for that δ, bit for bit
        (the drift telemetry's ``observed_w`` counts under it); every routing
        and membership test expands by :meth:`query_band` instead."""
        return (
            (self.box_lo - np.float32(band)).astype(np.float32),
            (self.box_hi + np.float32(band)).astype(np.float32),
        )

    def query_band(self, delta: float, batch: Tensor | None = None) -> float:
        """The band a routing or membership test expands the boxes by: the
        pivot filter's guard band over the resident rows and ``batch``.

        Lemma 4 holds for exact coordinates; computed ones are fp32 sums,
        and the card's kernel sums in another order than the plain path, so
        a δ-neighbour of a row on a box face can land a few ulps past a box
        expanded by exactly δ (``partition.widen``: the join's same repair).
        A wider box only adds candidates; the verify still tests the exact
        distance against δ."""
        return verify_lib.prune_band(delta, self.metric, self.data, batch)

    def route(self, q, delta: float, band: float | None = None) -> tuple[Tensor, Tensor]:
        """Map a query batch and route it to its owning cells. Returns
        ``(q_coords (B, n), member (B, p))`` on the index's device, through
        the same fused map-assign kernel (and fp algorithm) as the build.
        The boxes expand by ``band`` (default :meth:`query_band`)."""
        q = _rows(q, self.device)
        wlo, whi = self.query_boxes(self.query_band(delta, q) if band is None else band)
        if q.shape[0] == 0:
            return (
                torch.zeros((0, self.n_dims), dtype=torch.float32, device=self.device),
                torch.zeros((0, self.p), dtype=torch.bool, device=self.device),
            )
        if self.map_fused and kops.supports_kernel(self.metric):
            qm, _, bits = kops.map_assign(
                q, self._dev(self.anchors), self._dev(self.kernel_lo), self._dev(self.kernel_hi),
                self._dev(wlo), self._dev(whi), self.metric, backend=self.backend, want="member",
            )
            return qm, kops.unpack_membership(bits, self.p)
        qm = self.space_map(q)
        return qm, _member_matrix(qm, wlo, whi)

    def query_batch(self, q, delta: float | None = None, *, with_stats: bool = False):
        """Batched δ-range query: all pairs (i ∈ R, j ∈ Q) with
        D(r_i, q_j) ≤ δ, as an (n_pairs, 2) int64 array sorted unique
        (column 0 indexes the index, column 1 the batch). ``delta=None``
        uses the build-time default."""
        delta = self.delta if delta is None else float(delta)
        q = _rows(q, self.device)
        t0 = time.perf_counter()
        q_coords, member = self.route(q, delta)
        member_np = _np(member)
        t_route = time.perf_counter() - t0

        t0 = time.perf_counter()
        pairs, vstats = verify_lib.verify_resident(
            self.data, self.cells, self.v_lists, member_np, delta, self.metric,
            config=self._engine_config(), data_w=q,
            coords=self.coords, coords_w=q_coords,
        )
        t_verify = time.perf_counter() - t0
        if not with_stats:
            return pairs
        stats = QueryStats(
            n_queries=int(q.shape[0]),
            n_routed=int(member_np.sum()),
            n_cells_touched=int((member_np.sum(0) > 0).sum()),
            route_s=t_route,
            verify_s=t_verify,
            verify=vstats,
        )
        return pairs, stats

    def query(self, q, delta: float | None = None) -> np.ndarray:
        """Single-point δ-range query: sorted R row indices within δ of ``q``."""
        q = _np(q).astype(np.float32)
        if q.ndim != 1:
            raise ValueError(f"query() takes one point (m,); got shape {q.shape}")
        return np.sort(self.query_batch(q[None, :], delta)[:, 0])

    # ------------------------------------------------------------ streaming

    def _engine_config(self) -> verify_lib.EngineConfig:
        return verify_lib.EngineConfig(
            backend=self.backend, tile_v=self.tile_v, tile_w=self.tile_w,
            prune=verify_lib.resolve_prune(self.prune, self.metric, True),
        )

    def _ensure_stream_state(self) -> None:
        """Initialize the incremental counters on indexes that predate them."""
        if self.n_base == 0 and self.n_rows > self.n_inserted:
            self.n_base = self.n_rows - self.n_inserted
        if self.observed_w is None:
            self.observed_w = _member_counts(self.coords, *self.query_boxes(self.delta))

    @property
    def observed_loads(self) -> np.ndarray:
        """(p,) OBSERVED per-cell verification loads |V_h|·|W_h| — the
        drift monitor's second input."""
        self._ensure_stream_state()
        v_obs = torch.bincount(self.cells.long(), minlength=self.p).cpu().numpy()
        assert self.observed_w is not None
        return v_obs.astype(np.float64) * self.observed_w[: self.p]

    def self_pairs(self) -> np.ndarray:
        """Self-join pairs of the resident set through the index's own cached
        artifacts (coords, cells, band-expanded boxes)."""
        member = _member_matrix(self.coords, *self.query_boxes(self.query_band(self.delta)))
        pairs, _ = verify_lib.verify_pairs(
            self.data, self.cells, member, self.delta, self.metric,
            config=self._engine_config(), coords=self.coords,
        )
        return pairs

    def _delta_route(self, d: Tensor, band: float) -> tuple[Tensor, Tensor, Tensor]:
        """Map an insertion delta through the same fused map-assign pass as
        the build: mapped coordinates, kernel cells (int32) and whole
        membership under the CURRENT (pre-absorb) boxes expanded by ``band``."""
        wlo, whi = self.query_boxes(band)
        if self.map_fused and kops.supports_kernel(self.metric):
            dm, cells, bits = kops.map_assign(
                d, self._dev(self.anchors), self._dev(self.kernel_lo), self._dev(self.kernel_hi),
                self._dev(wlo), self._dev(whi), self.metric, backend=self.backend, want="both",
            )
            return dm, cells, kops.unpack_membership(bits, self.p)
        dm = self.space_map(d)
        pplan = partition.PartitionPlan(
            self._dev(self.kernel_lo), self._dev(self.kernel_hi),
            self._dev(wlo), self._dev(whi), self.delta,
        )
        cells = partition.assign_kernel(pplan, dm).to(torch.int32)
        return dm, cells, _member_matrix(dm, wlo, whi)

    def _delta_self_pairs(self, d: Tensor, d_coords: Tensor, d_cells: Tensor, band: float):
        """ΔR×ΔR self-join (DELTA-LOCAL ids) under the member MBBs extended
        with the delta's own coordinates and expanded by ``band``. Returns
        (pairs_local, stats, new_box_lo, new_box_hi, member_new), where
        ``member_new`` is the δ-expanded membership the drift telemetry
        counts."""
        new_lo = self.box_lo.copy()
        new_hi = self.box_hi.copy()
        cells_np, coords_np = _np(d_cells), _np(d_coords)
        np.minimum.at(new_lo, cells_np, coords_np)
        np.maximum.at(new_hi, cells_np, coords_np)

        def member(r: float) -> Tensor:
            lo = (new_lo - np.float32(r)).astype(np.float32)
            hi = (new_hi + np.float32(r)).astype(np.float32)
            return _member_matrix(d_coords, lo, hi)

        pairs, vstats = verify_lib.verify_pairs(
            d, d_cells, member(band), self.delta, self.metric,
            config=self._engine_config(), coords=d_coords,
        )
        return pairs, vstats, new_lo, new_hi, member(self.delta)

    def _absorb(self, d, d_coords, d_cells, member_new, new_lo, new_hi) -> None:
        """Append the delta to the resident tensors and every derived cache.
        The per-cell V lists are EXTENDED (delta ids are global-contiguous
        above the resident set), matching a from-scratch stable argsort."""
        n_old = self.n_rows
        assert self.observed_w is not None
        self.data = torch.cat([self.data, d])
        self.coords = torch.cat([self.coords, d_coords])
        self.cells = torch.cat([self.cells, d_cells.to(self.cells.dtype)])
        self.box_lo = new_lo
        self.box_hi = new_hi
        if self._v_lists is not None:
            cells_np = _np(d_cells)
            order = np.argsort(cells_np, kind="stable")
            bounds = np.searchsorted(cells_np[order], np.arange(self.p + 1))
            for h in range(self.p):
                extra = order[bounds[h] : bounds[h + 1]]
                if extra.size:
                    self._v_lists[h] = np.concatenate([self._v_lists[h], n_old + extra])
        self.observed_w = self.observed_w + _np(member_new.sum(0))
        self.n_inserted += int(d.shape[0])
        self.n_batches += 1

    def _rebuild(self, cfg) -> None:
        """Re-sample pivots and rebuild from the full accumulated data (the
        expensive drift action); the accumulated pair set is untouched."""
        n_batches = self.n_batches
        if self.n_rows < cfg.n_dims:
            cfg = dataclasses.replace(cfg, n_dims=max(1, self.n_rows))
        fresh = build_index(
            self.data, cfg, n_nodes=max(1, min(4, self.n_rows)),
            n_devices=self.n_devices, device=self.device,
        )
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(fresh, f.name))
        self.n_batches = n_batches

    def _drift_step(self, stats: StreamStats, replan_drift: float, resample_drift: float,
                    rebuild_cfg) -> None:
        """Measure drift against the plan in force and fire the cheap action
        (re-plan) before the expensive one (re-sample; needs ``rebuild_cfg``)."""
        observed = self.observed_loads
        stats.drift = cost_model.load_drift(self.placement.cell_loads, observed)
        stats.balance_std_before = float(
            placement_lib.device_loads_under(self.placement, observed).std()
        )
        action = placement_lib.drift_action(stats.drift, replan_drift, resample_drift)
        if action == "resample" and rebuild_cfg is None:
            stats.resample_due = True
            action = "replan"
        if action == "resample":
            self._rebuild(rebuild_cfg)
        elif action == "replan":
            self.placement = placement_lib.plan_placement(
                observed, self.placement.n_devices, strategy=self.placement_strategy,
            )
        stats.action = action
        stats.balance_std_after = float(
            placement_lib.device_loads_under(self.placement, self.observed_loads).std()
        )

    def insert_batch(
        self,
        new_rows,
        *,
        replan_drift: float | None = None,
        resample_drift: float | None = None,
        rebuild_cfg=None,
        _cross_pairs_fn=None,
    ) -> tuple[np.ndarray, StreamStats]:
        """Absorb an insertion batch and return the NEW pairs it creates:
        ΔR×R_old (the delta routed against the resident V lists through
        ``verify_resident``, as ``query_batch``) plus ΔR×ΔR under the
        widened member MBBs, with GLOBAL row ids (delta row j ↦ n_resident
        + j), i < j, sorted unique. Then the drift monitor: thresholds
        default to ``placement.REPLAN_DRIFT`` / ``RESAMPLE_DRIFT``;
        ``rebuild_cfg`` (a ``spjoin.JoinConfig``) arms the re-sample.
        ``_cross_pairs_fn(delta_rows)`` lets ``distributed.DistIndex`` answer
        ΔR×R_old through its serve stage under this same control flow."""
        self._ensure_stream_state()
        rt = placement_lib.REPLAN_DRIFT if replan_drift is None else float(replan_drift)
        rs = placement_lib.RESAMPLE_DRIFT if resample_drift is None else float(resample_drift)
        d = _rows(new_rows, self.device)
        if d.dim() != 2 or (d.shape[0] and d.shape[1] != self.n_features):
            raise ValueError(
                f"insert_batch expects (B, {self.n_features}) rows; got shape {tuple(d.shape)}"
            )
        stats = StreamStats(
            n_delta=int(d.shape[0]), n_resident=self.n_rows,
            n_total=self.n_rows + int(d.shape[0]),
            replan_threshold=rt, resample_threshold=rs,
        )
        if d.shape[0] == 0:
            stats.drift = cost_model.load_drift(self.placement.cell_loads, self.observed_loads)
            return np.zeros((0, 2), np.int64), stats

        n_old = self.n_rows
        t0 = time.perf_counter()
        band = self.query_band(self.delta, d)
        d_coords, d_cells, d_member_old = self._delta_route(d, band)
        stats.route_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        if _cross_pairs_fn is None:
            cross, stats.cross_verify = verify_lib.verify_resident(
                self.data, self.cells, self.v_lists, d_member_old, self.delta, self.metric,
                config=self._engine_config(), data_w=d, coords=self.coords, coords_w=d_coords,
            )
        else:
            cross = np.asarray(_cross_pairs_fn(d), np.int64).reshape(-1, 2)
        self_local, sstats, new_lo, new_hi, member_new = self._delta_self_pairs(
            d, d_coords, d_cells, band
        )
        stats.self_verify = sstats
        stats.verify_s = time.perf_counter() - t0
        stats.n_cross_pairs = int(cross.shape[0])
        stats.n_self_pairs = int(self_local.shape[0])

        # Globalize: cross pairs are (i ∈ resident, j ∈ delta); ΔΔ pairs
        # shift both columns above the resident set.
        chunks = []
        if cross.shape[0]:
            chunks.append(np.stack([cross[:, 0], n_old + cross[:, 1]], axis=1))
        if self_local.shape[0]:
            chunks.append(self_local + n_old)
        if chunks:
            pairs = np.unique(np.concatenate(chunks), axis=0).astype(np.int64)
        else:
            pairs = np.zeros((0, 2), np.int64)
        stats.n_new_pairs = int(pairs.shape[0])

        t0 = time.perf_counter()
        self._absorb(d, d_coords, d_cells, member_new, new_lo, new_hi)
        self._drift_step(stats, rt, rs, rebuild_cfg)
        stats.update_s = time.perf_counter() - t0
        return pairs, stats

    def to_distributed(self, group=None):
        """Pin the per-slot V buffers on the ranks of ``group`` (default: the
        initialised world) and serve query batches through the distributed
        serve stage (one W-side shuffle per batch, no R bytes moved after
        this call). Every rank calls it on its own copy of the index.
        Re-plans placement (a static permutation from the stored cost-model
        loads) when the world size differs from the plan's ``n_devices``;
        never re-samples or re-partitions."""
        from repro_torch.core import distributed as dist_lib  # deferred: import cycle

        return dist_lib.DistIndex.from_index(self, group)

    # ------------------------------------------------------------- save/load

    def manifest(self) -> dict:
        """The JSON manifest (format + config + shapes + placement summary),
        in the reference's vocabulary."""
        return {
            "format": FORMAT_NAME,
            "version": FORMAT_VERSION,
            "metric": self.metric,
            "delta": float(self.delta),
            "k": self.k,
            "p": self.p,
            "n_dims": self.n_dims,
            "n_rows": self.n_rows,
            "n_features": self.n_features,
            "tighten": bool(self.tighten),
            "backend": _TO_REFERENCE[self.backend],
            "prune": self.prune,
            "map_fused": bool(self.map_fused),
            "tile_v": self.tile_v,
            "tile_w": self.tile_w,
            "seed": self.seed,
            "build_s": float(self.build_s),
            "incremental": {
                "n_base": int(self.n_base),
                "n_inserted": int(self.n_inserted),
                "n_batches": int(self.n_batches),
            },
            "placement": {
                "strategy": self.placement.strategy,
                "n_devices": self.placement.n_devices,
                "n_slots": self.placement.n_slots,
                "certified_bound": float(self.placement.certified_bound),
            },
            "arrays": {name: list(getattr(self, name).shape) for name in _ARRAYS},
        }

    def save(self, path: str) -> str:
        """Write ``path/manifest.json`` + ``path/arrays.npz`` (all arrays
        bit-exact). Returns ``path``."""
        self._ensure_stream_state()
        os.makedirs(path, exist_ok=True)
        arrays = {name: _np(getattr(self, name)) for name in _ARRAYS}
        for name in _PLAN_ARRAYS:
            arrays[f"pl_{name}"] = np.asarray(getattr(self.placement, name))
        if self.node_confidences is not None:
            arrays["node_confidences"] = np.asarray(self.node_confidences)
        np.savez(os.path.join(path, "arrays.npz"), **arrays)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(self.manifest(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(
        cls,
        path: str,
        *,
        metric: str | None = None,
        delta: float | None = None,
        k: int | None = None,
        device: torch.device | str = "cuda",
    ) -> "MetricIndex":
        """Load an index onto ``device``, failing loudly instead of
        mis-answering: ``IndexFormatError`` for a missing/foreign manifest,
        an unsupported version or backend word, or arrays that disagree with
        the manifest; ``IndexMismatchError`` when the caller's ``metric`` /
        ``delta`` / pivot count ``k`` or the stream counters disagree."""
        dev = kops.resolve_device(device)
        mpath = os.path.join(path, "manifest.json")
        if not os.path.exists(mpath):
            raise IndexFormatError(f"no metric-index manifest at {mpath}")
        with open(mpath) as f:
            man = json.load(f)
        if man.get("format") != FORMAT_NAME:
            raise IndexFormatError(
                f"{mpath} is not a {FORMAT_NAME!r} artifact (format={man.get('format')!r})"
            )
        version = man.get("version")
        if version != FORMAT_VERSION:
            raise IndexFormatError(
                f"index format version {version!r} is not supported by this build "
                f"(speaks version {FORMAT_VERSION}); re-save the index with a "
                f"matching version of the code"
            )
        if man.get("backend") not in _FROM_REFERENCE:
            raise IndexFormatError(
                f"unknown backend {man.get('backend')!r} in {mpath}; "
                f"expected one of {sorted(_FROM_REFERENCE)}"
            )
        if metric is not None and metric != man["metric"]:
            raise IndexMismatchError(
                f"index was built for metric {man['metric']!r} but the query config "
                f"expects {metric!r} — distances would be silently wrong; rebuild "
                f"the index for {metric!r}"
            )
        if delta is not None and not np.isclose(delta, man["delta"]):
            raise IndexMismatchError(
                f"index default delta is {man['delta']} but the query config expects "
                f"{delta} — pass delta= per query_batch() call for a different "
                f"radius, or rebuild to change the default"
            )
        if k is not None and k != man["k"]:
            raise IndexMismatchError(
                f"index holds {man['k']} pivots but the query config expects k={k} "
                f"— the partition plan would not match; rebuild"
            )

        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {name: z[name] for name in z.files}
        missing = [n for n in _ARRAYS if n not in arrays]
        if missing:
            raise IndexFormatError(f"arrays.npz is missing {missing}")
        for name, shape in man["arrays"].items():
            got = list(arrays[name].shape)
            if got != shape:
                raise IndexFormatError(
                    f"manifest says {name} has shape {shape} but arrays.npz holds "
                    f"{got} — artifact is corrupt or mixed between saves"
                )
        if int(man["k"]) != arrays["pivots"].shape[0]:
            raise IndexFormatError(
                f"manifest pivot count k={man['k']} disagrees with the stored pivots "
                f"array ({arrays['pivots'].shape[0]} rows)"
            )
        inc = man.get("incremental")
        if not isinstance(inc, dict) or not {"n_base", "n_inserted", "n_batches"} <= set(inc):
            raise IndexFormatError(
                "version-2 manifest is missing the incremental block "
                "(n_base / n_inserted / n_batches) — artifact is corrupt"
            )
        if int(inc["n_base"]) + int(inc["n_inserted"]) != int(man["n_rows"]):
            raise IndexMismatchError(
                f"incremental counters disagree with the stored data: "
                f"n_base={inc['n_base']} + n_inserted={inc['n_inserted']} != "
                f"n_rows={man['n_rows']} — the appended-delta history does not "
                f"describe this artifact; refusing to resume the stream"
            )

        backend = _FROM_REFERENCE[man["backend"]]
        if backend == "cuda" and dev.type != "cuda":
            backend = "torch"  # the CPU runs the plain versions
        pman = man["placement"]
        plan = placement_lib.PlacementPlan(
            strategy=pman["strategy"],
            n_devices=int(pman["n_devices"]),
            p=int(man["p"]),
            n_slots=int(pman["n_slots"]),
            cell_loads=arrays["pl_cell_loads"],
            cell_first_slot=arrays["pl_cell_first_slot"],
            cell_n_slabs=arrays["pl_cell_n_slabs"],
            slot_cell=arrays["pl_slot_cell"],
            slot_slab=arrays["pl_slot_slab"],
            slot_load=arrays["pl_slot_load"],
            dispatch_of_slot=arrays["pl_dispatch_of_slot"],
            certified_bound=float(pman["certified_bound"]),
        )
        return cls(
            metric=man["metric"],
            delta=float(man["delta"]),
            n_dims=int(man["n_dims"]),
            tighten=bool(man["tighten"]),
            backend=backend,
            prune=man["prune"],
            map_fused=bool(man["map_fused"]),
            tile_v=int(man["tile_v"]),
            tile_w=int(man["tile_w"]),
            seed=int(man["seed"]),
            placement_strategy=pman["strategy"],
            n_devices=int(pman["n_devices"]),
            data=torch.from_numpy(arrays["data"]).to(dev),
            coords=torch.from_numpy(arrays["coords"]).to(dev),
            cells=torch.from_numpy(arrays["cells"]).to(dev),
            pivots=arrays["pivots"],
            anchors=arrays["anchors"],
            kernel_lo=arrays["kernel_lo"],
            kernel_hi=arrays["kernel_hi"],
            box_lo=arrays["box_lo"],
            box_hi=arrays["box_hi"],
            placement=plan,
            build_s=float(man.get("build_s", 0.0)),
            node_confidences=arrays.get("node_confidences"),
            n_base=int(inc["n_base"]),
            n_inserted=int(inc["n_inserted"]),
            n_batches=int(inc["n_batches"]),
            observed_w=arrays["observed_w"],
        )


# ---------------------------------------------------------------------------
# The build phase
# ---------------------------------------------------------------------------


def _base_boxes(
    plan: partition.PartitionPlan, x_mapped: Tensor, cells: Tensor, tighten: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Pre-expansion whole-box base: the member MBB of each cell (the
    expression ``partition.tighten`` uses, so expanding by the build δ
    reproduces the join's whole boxes bit for bit), or the kernel box when
    tightening is off."""
    if not tighten:
        return _np(plan.kernel_lo).astype(np.float32), _np(plan.kernel_hi).astype(np.float32)
    lo, hi = partition.member_boxes(x_mapped, cells, plan.p)
    return _np(lo).astype(np.float32), _np(hi).astype(np.float32)


def build_index(
    data,
    cfg: spjoin.JoinConfig,
    *,
    n_nodes: int = 4,
    n_devices: int | None = None,
    device: torch.device | str = "cuda",
) -> MetricIndex:
    """Run the build phase ONCE: sampling → anchors → partition boxes →
    member MBBs → LPT placement plan → cached coordinates and cells.

    ``data`` is the indexed set R (full array or per-node shard list, as for
    ``spjoin.join``); ``cfg`` carries the join's knobs (δ becomes the
    default query radius). The same seeded generators and control-plane
    helpers as ``spjoin.join`` run here, so a fixed seed gives the partition
    geometry the one-shot join uses. Runs on the card unless the caller
    passes ``device="cpu"``."""
    dev = kops.resolve_device(device)
    kops.strict_fp32()
    t_start = time.perf_counter()
    gen = torch.Generator().manual_seed(cfg.seed)
    gen_anchor = torch.Generator().manual_seed(cfg.seed + spjoin._ANCHOR_SEED_OFFSET)
    shards = spjoin._as_shards(data, n_nodes, dev)
    allx = torch.cat(shards) if shards else _rows(data, dev)

    # ---- sampling phase (once, at build) ---------------------------------
    node_stats = spjoin.fit_node_stats(shards, cfg.t_cells)
    pivots = spjoin.draw_pivots(gen, shards, node_stats, cfg)

    # ---- map-phase control plane (once, at build) ------------------------
    plan, smap = spjoin.build_plan(gen_anchor, pivots, cfg)
    fused = cfg.map_fused and kops.supports_kernel(cfg.metric)
    backend = (
        kops.resolve_backend(cfg.backend, cfg.metric, allx)
        if kops.supports_kernel(cfg.metric)
        else "torch"
    )
    if fused:
        x_mapped, cells, _ = kops.map_assign(
            allx, smap.anchors, plan.kernel_lo, plan.kernel_hi,
            plan.whole_lo, plan.whole_hi, cfg.metric, backend=backend, want="cells",
        )
    else:
        x_mapped = smap(allx)
        cells = partition.assign_kernel(plan, x_mapped)
    cells = cells.to(torch.int32)
    box_lo, box_hi = _base_boxes(plan, x_mapped, cells, cfg.tighten)
    wlo = (box_lo - np.float32(cfg.delta)).astype(np.float32)
    whi = (box_hi + np.float32(cfg.delta)).astype(np.float32)

    # ---- placement plan (cost-model loads from the pivots alone) ---------
    n_dev = int(n_devices or max(len(shards), 1))
    piv_mapped_t = smap(pivots)
    piv_plan = partition.PartitionPlan(
        plan.kernel_lo, plan.kernel_hi,
        torch.as_tensor(wlo, device=dev), torch.as_tensor(whi, device=dev), cfg.delta,
    )
    piv_cells = _np(partition.assign_kernel(piv_plan, piv_mapped_t))
    piv_member = _np(partition.whole_membership(piv_plan, piv_mapped_t))
    prune_active = verify_lib.resolve_prune(cfg.prune, cfg.metric, True) == "pivot"
    cell_loads, _, _, _ = placement_lib.planner_inputs(
        _np(piv_mapped_t).astype(np.float32), piv_cells, piv_member,
        int(allx.shape[0]), int(allx.shape[0]), cfg.delta, prune_active,
    )
    pl = placement_lib.plan_placement(cell_loads, n_dev, strategy=cfg.placement)

    idx = MetricIndex(
        metric=cfg.metric,
        delta=float(cfg.delta),
        n_dims=int(smap.n_dims),
        tighten=bool(cfg.tighten),
        backend=backend,
        prune=cfg.prune,
        map_fused=bool(fused),
        tile_v=cfg.tile_v,
        tile_w=cfg.tile_w,
        seed=cfg.seed,
        placement_strategy=cfg.placement,
        n_devices=n_dev,
        data=allx,
        coords=x_mapped.float(),
        cells=cells,
        pivots=_np(pivots).astype(np.float32),
        anchors=_np(smap.anchors).astype(np.float32),
        kernel_lo=_np(plan.kernel_lo).astype(np.float32),
        kernel_hi=_np(plan.kernel_hi).astype(np.float32),
        box_lo=box_lo,
        box_hi=box_hi,
        placement=pl,
        node_confidences=np.array([st.confidence for st in node_stats]),
        n_base=int(allx.shape[0]),
        observed_w=_member_counts(x_mapped.float(), wlo, whi),
    )
    idx.build_s = time.perf_counter() - t_start
    return idx


def brute_force_query(
    index_data, q, delta: float, metric: str, *, device: torch.device | str = "cuda"
) -> np.ndarray:
    """Oracle for tests and chip_smoke: (i ∈ R, j ∈ Q) pairs by the plain
    distance in row chunks — the parity target of ``query_batch``."""
    return spjoin.brute_force_pairs(index_data, delta, metric, s=q, device=device)
