"""Single-host end-to-end SP-Join on the device (port of ``repro.core.spjoin``).

Runs the three phases of Figure 1 on in-memory shards:

  sampling phase — per-node exponential-family fit + GoF confidence
                   (core.expfam / gof), then Random / Dist / Gen pivots
  map phase      — anchor selection, space mapping, partition tree
                   (Iter / Learn), kernel assignment + whole membership
                   through the fused map-assign kernel
  reduce phase   — per-cell V_h × W_h verification via the streaming tiled
                   engine (core.verify) on the pairdist kernels

``join`` runs on the card by default (``device="cuda"``) and raises when
CUDA is absent, unless the caller passes ``device="cpu"`` (the plain
versions then run). Randomness comes from ``torch.Generator``s seeded from
``cfg.seed``; the pivots therefore differ from the JAX package's, but the
join is exact for any pivots, so pair sets compare.

Pair de-duplication rule: a result pair (i, j), i's cell = g, j's cell = h,
is emitted by cell min(g, h) only; within one cell keep i < j.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import cost_model, distances, gof, mapping, partition, sampling
from repro_torch.core import placement as placement_lib
from repro_torch.core import verify as verify_lib
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor

_ANCHOR_SEED_OFFSET = 0x9E3779B9  # second generator stream of one cfg.seed


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    delta: float
    metric: str = "l1"
    sampler: str = "generative"  # random | distribution | generative
    partitioner: str = "learning"  # iterative | learning
    k: int = 1024  # sample (pivot) count
    p: int = 16  # number of partitions / reducers
    n_dims: int = 8  # target-space dimensionality n
    t_cells: int = 8  # GoF cells per dimension
    n_clusters: int | None = None  # labels for Learn (default: 2p)
    anchor_method: str = "fft"  # fft | random (paper)
    tighten: bool = True  # object-MBB tightening of whole boxes
    backend: str = "auto"  # kernels: torch | cuda | auto
    tile_v: int = 1024  # verify engine streaming tile (V side)
    tile_w: int = 4096  # verify engine streaming tile (W side)
    prune: str = "pivot"  # pivot-filter pruning: "pivot" | "window" | "none"
    emit: str = "mask"  # verify-engine emission path: "mask" | "compact"
    map_fused: bool = True  # single-pass map kernel (kernels.ops.map_assign);
    #   metrics without a kernel take the two-pass path (capability)
    placement: str = "lpt"  # reduce-placement plan to REPORT ("lpt" | "contiguous")
    seed: int = 0

    def engine_config(self) -> verify_lib.EngineConfig:
        return verify_lib.EngineConfig(
            backend=self.backend, tile_v=self.tile_v, tile_w=self.tile_w,
            prune=self.prune, emit=self.emit,
        )


@dataclasses.dataclass
class JoinResult:
    pairs: np.ndarray  # (n_pairs, 2) int64, unique; self-join: i < j —
    #   R×S: column 0 indexes R, column 1 indexes S
    n_verifications: int  # Σ_h |V_h|·|W_h|
    cost: cost_model.PartitionCost
    node_confidences: np.ndarray
    sample_time_s: float
    map_time_s: float
    verify_time_s: float
    verify_stats: verify_lib.VerifyStats | None = None
    per_cell_verified: np.ndarray | None = None  # (p,) |V_h|·|W_h|
    placement_plan: placement_lib.PlacementPlan | None = None
    device_loads: np.ndarray | None = None  # (n_nodes,) PREDICTED loads
    balance_std: float = 0.0
    makespan_ratio: float = 1.0
    capacity_saved_bytes: int = 0

    @property
    def n_pairs(self) -> int:
        return int(self.pairs.shape[0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_node_stats(shards: Sequence[Tensor], t_cells: int = 8) -> list[sampling.NodeStats]:
    """Sampling phase stages 1–2 (Alg. 1 lines 1–4) for every node."""
    out = []
    for shard in shards:
        params, res = gof.fit_best_family(shard, t=t_cells)
        out.append(
            sampling.NodeStats(
                family=params.family,
                params=params,
                confidence=float(res.confidence),
                count=int(shard.shape[0]),
            )
        )
    return out


def draw_pivots(
    gen: torch.Generator,
    shards: Sequence[Tensor],
    node_stats: list[sampling.NodeStats],
    cfg: JoinConfig,
) -> Tensor:
    if cfg.sampler == "random":
        return sampling.random_sample(gen, torch.cat(list(shards)), cfg.k)
    if cfg.sampler == "distribution":
        return sampling.distribution_aware_sample(gen, list(shards), node_stats, cfg.k)
    if cfg.sampler == "generative":
        if distances.get_metric(cfg.metric).discrete:
            # Generated pivots collide with no real MinHash signature: the
            # generative arm takes distribution-aware REAL samples instead.
            return sampling.distribution_aware_sample(gen, list(shards), node_stats, cfg.k)
        pivots, acc = sampling.generative_sample(gen, node_stats, cfg.k)
        if acc <= 0.0:
            warnings.warn(
                "gibbs chain accepted no draws (all node confidences ≈ 0); "
                "pivots fall back to raw chain draws", stacklevel=2,
            )
        return pivots
    raise ValueError(f"unknown sampler {cfg.sampler!r}")


def build_plan(
    gen: torch.Generator,
    pivots: Tensor,
    cfg: JoinConfig,
) -> tuple[partition.PartitionPlan, mapping.SpaceMap]:
    """Map phase control plane: anchors, mapping, labels, partition tree."""
    smap = mapping.select_anchors(gen, pivots, cfg.n_dims, cfg.metric, cfg.anchor_method)
    pivots_mapped = smap(pivots).cpu().numpy()
    labels = None
    if cfg.partitioner == "learning":
        d = distances.pairwise(pivots, pivots, cfg.metric).cpu().numpy()
        labels = partition.single_linkage_labels(d, cfg.n_clusters or 2 * cfg.p)
    plan = partition.build_partition(
        pivots_mapped, cfg.p, cfg.delta, strategy=cfg.partitioner, labels=labels,
        seed=cfg.seed, device=pivots.device,
    )
    return plan, smap


def _as_shards(x, n_nodes: int, device: torch.device) -> list[Tensor]:
    if isinstance(x, (list, tuple)):
        return [torch.as_tensor(v).to(device=device, dtype=torch.float32) for v in x]
    x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
    if x.shape[0] == 0:
        return []
    return list(torch.tensor_split(x, n_nodes))


def join(
    data,
    cfg: JoinConfig,
    return_pairs: bool = True,
    n_nodes: int = 4,
    *,
    s=None,
    device: torch.device | str = "cuda",
) -> JoinResult:
    """Metric similarity join.

    Self-join (``s=None``): all pairs (i, j), i < j, with D(o_i, o_j) ≤ δ.
    Two-set R×S join (``s`` given): all pairs (i ∈ R, j ∈ S) with
    D(r_i, s_j) ≤ δ; ``s is data`` routes to the self-join.

    ``data`` / ``s``: the full (N, m) array (numpy or tensor; split into
    ``n_nodes`` simulated nodes) or an explicit list of per-node shards.
    """
    dev = kops.resolve_device(device)
    kops.strict_fp32()
    if s is data:
        s = None  # R = S aliasing: the canonical semantics is the self-join
    cross = s is not None
    gen = torch.Generator().manual_seed(cfg.seed)
    gen_anchor = torch.Generator().manual_seed(cfg.seed + _ANCHOR_SEED_OFFSET)
    shards = _as_shards(data, n_nodes, dev)
    allx = (
        torch.cat(shards)
        if shards
        else torch.as_tensor(data).to(device=dev, dtype=torch.float32)
    )
    s_shards = _as_shards(s, n_nodes, dev) if cross else []
    s_all = (
        torch.cat(s_shards)
        if s_shards
        else torch.zeros((0, allx.shape[1]), dtype=torch.float32, device=dev)
    )

    # ---- sampling phase -------------------------------------------------
    t0 = time.perf_counter()
    fit_shards = [sh for sh in shards + s_shards if sh.shape[0] > 0] if cross else shards
    node_stats = fit_node_stats(fit_shards, cfg.t_cells)
    pivots = draw_pivots(gen, fit_shards, node_stats, cfg)
    _sync(dev)
    t_sample = time.perf_counter() - t0

    # ---- map phase -------------------------------------------------------
    t0 = time.perf_counter()
    plan, smap = build_plan(gen_anchor, pivots, cfg)
    # The whole boxes take the pivot filter's fp guard band instead of δ
    # (partition.widen: Lemma 4 on computed coordinates).
    band = verify_lib.prune_band(cfg.delta, cfg.metric, allx, s_all if cross else None)
    if not cfg.tighten:
        plan = partition.widen(plan, band)
    fused = cfg.map_fused and kops.supports_kernel(cfg.metric)
    assign_backend = cfg.backend if fused else None
    if fused:
        want = "both" if (not cfg.tighten and not cross) else "cells"
        x_mapped, cells, bits = kops.map_assign(
            allx, smap.anchors, plan.kernel_lo, plan.kernel_hi,
            plan.whole_lo, plan.whole_hi, cfg.metric, backend=cfg.backend, want=want,
        )
    else:
        x_mapped = smap(allx)
        cells = partition.assign_kernel(plan, x_mapped)
        bits = None
    if cfg.tighten:
        plan = partition.tighten(plan, x_mapped, cells, band)
    s_mapped = None
    if cross:
        if s_all.shape[0] == 0:
            s_mapped = torch.zeros((0, smap.n_dims), dtype=torch.float32, device=dev)
            member = torch.zeros((0, plan.p), dtype=torch.bool, device=dev)
        elif fused:
            s_mapped, _, s_bits = kops.map_assign(
                s_all, smap.anchors, plan.kernel_lo, plan.kernel_hi,
                plan.whole_lo, plan.whole_hi, cfg.metric, backend=cfg.backend,
                want="member",
            )
            member = kops.unpack_membership(s_bits, plan.p)
        else:
            s_mapped = smap(s_all)
            member = partition.whole_membership(plan, s_mapped)
    elif fused and not cfg.tighten:
        member = kops.unpack_membership(bits, plan.p)
    else:
        member = partition.whole_membership(plan, x_mapped, backend=assign_backend)
    cells_np = cells.cpu().numpy()
    member_np = member.cpu().numpy()
    _sync(dev)
    t_map = time.perf_counter() - t0

    # ---- reduce phase: streaming tiled verify engine ---------------------
    t0 = time.perf_counter()
    stats = partition.partition_stats(cells_np, member_np)
    pairs, vstats = verify_lib.verify_pairs(
        allx, cells_np, member_np, cfg.delta, cfg.metric,
        config=cfg.engine_config(), return_pairs=return_pairs,
        data_w=s_all if cross else None,
        coords=x_mapped, coords_w=s_mapped, delta_bound=band,
    )
    _sync(dev)
    t_verify = time.perf_counter() - t0

    if cross:
        cost = cost_model.rs_partition_cost(
            stats["v_sizes"], stats["w_sizes"], int(s_all.shape[0])
        )
    else:
        cost = cost_model.partition_cost(stats["v_sizes"], stats["w_sizes"])

    # ---- reduce-placement report (telemetry: single host) ---------------
    piv_mapped_t = smap(pivots)
    piv_mapped = piv_mapped_t.cpu().numpy().astype(np.float32)
    piv_cells = partition.assign_kernel(plan, piv_mapped_t).cpu().numpy()
    piv_member = partition.whole_membership(plan, piv_mapped_t).cpu().numpy()
    cell_loads, _, _, _ = placement_lib.planner_inputs(
        piv_mapped, piv_cells, piv_member,
        int(allx.shape[0]), int(s_all.shape[0]) if cross else int(allx.shape[0]),
        cfg.delta, vstats.prune == "pivot",
    )
    pl = placement_lib.plan_placement(cell_loads, max(len(shards), 1), strategy=cfg.placement)
    cap_saved = placement_lib.capacity_saved_bytes(
        pl, stats["v_sizes"][None, :], stats["w_sizes"][None, :],
        placement_lib.dispatch_row_bytes(
            int(allx.shape[1]), smap.n_dims, vstats.prune == "pivot"
        ),
    )
    dev_loads = pl.device_loads

    return JoinResult(
        pairs=pairs,
        n_verifications=vstats.n_verifications,
        cost=cost,
        node_confidences=np.array([st.confidence for st in node_stats]),
        sample_time_s=t_sample,
        map_time_s=t_map,
        verify_time_s=t_verify,
        verify_stats=vstats,
        per_cell_verified=(stats["v_sizes"] * stats["w_sizes"]).astype(np.int64),
        placement_plan=pl,
        device_loads=dev_loads,
        balance_std=float(dev_loads.std()),
        makespan_ratio=float(dev_loads.max(initial=0.0) / max(dev_loads.mean(), 1e-9)),
        capacity_saved_bytes=int(cap_saved),
    )


class IncrementalJoin:
    """Streaming self-join session: feed insertion batches, accumulate the
    canonical pair set (sorted unique (i, j) int64, i < j, GLOBAL ids in
    arrival order).

    Batch 0 runs the one-time build (``index.build_index`` — the only time
    sampling / anchor selection / partitioning run) and emits its
    self-join pairs through the index's cached artifacts; every later batch
    goes through ``MetricIndex.insert_batch`` — only the delta is mapped,
    ΔR×R_old streams against the resident V lists and ΔR×ΔR self-joins
    under the updated member MBBs. A re-sample-worthy drift rebuilds with
    this session's own ``cfg``.

    Exactness: for a fixed seed and ANY split of R into batches, ``pairs``
    after the last insert equals ``join(R, cfg).pairs`` over the
    concatenated rows (both are exact).
    """

    def __init__(
        self,
        cfg: JoinConfig,
        *,
        n_nodes: int = 4,
        n_devices: int | None = None,
        replan_drift: float | None = None,
        resample_drift: float | None = None,
        device: torch.device | str = "cuda",
    ):
        self.cfg = cfg
        self.n_nodes = n_nodes
        self.n_devices = n_devices
        self.replan_drift = replan_drift
        self.resample_drift = resample_drift
        self.device = kops.resolve_device(device)
        self.index = None  # built lazily on the first non-empty batch
        self.stats: list = []  # one StreamStats per insert() call
        self._pairs = np.zeros((0, 2), np.int64)

    @property
    def pairs(self) -> np.ndarray:
        """Accumulated canonical pair set (sorted unique, global ids)."""
        return self._pairs

    @property
    def n_rows(self) -> int:
        return 0 if self.index is None else self.index.n_rows

    def insert(self, new_rows):
        """Absorb one insertion batch; returns (new_pairs, StreamStats)."""
        from repro_torch.core import index as index_lib  # deferred: import cycle

        n_new = int(new_rows.shape[0])
        if self.index is None:
            if n_new == 0:
                # Nothing to build from yet — stay lazy, report a no-op.
                stats = index_lib.StreamStats(action="none")
                self.stats.append(stats)
                return np.zeros((0, 2), np.int64), stats
            bcfg = self.cfg
            if n_new < bcfg.n_dims:
                # A tiny first batch can yield fewer distinct pivots than
                # mapped dimensions; exactness holds under any plan, and a
                # re-sample later rebuilds with the full config.
                bcfg = dataclasses.replace(bcfg, n_dims=max(1, n_new))
            self.index = index_lib.build_index(
                new_rows, bcfg, n_nodes=max(1, min(self.n_nodes, n_new)),
                n_devices=self.n_devices, device=self.device,
            )
            new_pairs = self.index.self_pairs()
            stats = index_lib.StreamStats(
                n_delta=n_new, n_resident=0, n_total=n_new,
                n_self_pairs=int(new_pairs.shape[0]),
                n_new_pairs=int(new_pairs.shape[0]),
                action="build",
            )
        else:
            new_pairs, stats = self.index.insert_batch(
                new_rows,
                replan_drift=self.replan_drift,
                resample_drift=self.resample_drift,
                rebuild_cfg=self.cfg,
            )
        if new_pairs.shape[0]:
            self._pairs = np.unique(np.concatenate([self._pairs, new_pairs]), axis=0)
        self.stats.append(stats)
        return new_pairs, stats


def join_incremental(
    batches,
    cfg: JoinConfig,
    *,
    n_nodes: int = 4,
    n_devices: int | None = None,
    replan_drift: float | None = None,
    resample_drift: float | None = None,
    device: torch.device | str = "cuda",
) -> IncrementalJoin:
    """Run the streaming layer over an iterable of insertion batches and
    return the finished session (``.pairs`` the accumulated canonical set,
    ``.stats`` the per-batch trail, ``.index`` the live ``MetricIndex``)."""
    session = IncrementalJoin(
        cfg, n_nodes=n_nodes, n_devices=n_devices,
        replan_drift=replan_drift, resample_drift=resample_drift, device=device,
    )
    for b in batches:
        session.insert(b)
    return session


def brute_force_pairs(
    data,
    delta: float,
    metric: str = "l1",
    s=None,
    *,
    device: torch.device | str = "cuda",
    chunk: int = 2048,
) -> np.ndarray:
    """Ground-truth pair list (quadratic), in row chunks with the plain
    distance on ``device`` (the card unless the caller asks for the CPU).

    ``s=None``: self-join pairs (i, j), i < j. With ``s``: cross R×S pairs,
    column 0 indexing ``data`` (R), column 1 indexing ``s`` (S). Sorted
    lexicographically, int64."""
    dev = kops.resolve_device(device)
    x = torch.as_tensor(data).to(device=dev, dtype=torch.float32)
    y = x if s is None else torch.as_tensor(s).to(device=dev, dtype=torch.float32)
    out = []
    for i0 in range(0, x.shape[0], chunk):
        hit = distances.pairwise(x[i0 : i0 + chunk], y, metric) <= delta
        if s is None:
            rows = torch.arange(i0, i0 + hit.shape[0], device=dev)[:, None]
            hit &= torch.arange(y.shape[0], device=dev)[None, :] > rows
        i, j = torch.nonzero(hit, as_tuple=True)
        out.append(torch.stack([i + i0, j], dim=1))
    if not out:
        return np.zeros((0, 2), np.int64)
    return torch.cat(out).cpu().numpy().astype(np.int64)
