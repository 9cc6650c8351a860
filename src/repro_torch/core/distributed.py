"""Distributed SP-Join on ``torch.distributed`` (port of ``repro.core.distributed``).

The reference runs its three phases as jitted ``shard_map`` stages over the
``data`` axis of a JAX mesh. Here a stage is a plain function that every
rank of a process group calls on its own shard (SPMD, as the reference's
``per_shard`` closures are): the reference's ``mesh, axis`` become
``group=`` (default: the world), M is the group's size, and NCCL carries
CUDA tensors, gloo CPU tensors (nothing is staged through the host to
reach a backend).

  stage_stats    sampling phase stages 1–2: per-shard exponential-family MLE
                 for every family + chi-square GoF, whose cell counts come
                 from the histogram kernel (``kernels.ops.histogram``, three
                 launches per shard per set), then three ``all_gather``s of
                 the best family's (2m+1)-float packet, its confidence and
                 the shard's row count.

  control plane  the Gibbs chain runs identically on every rank from the
                 gathered packets with an explicitly seeded
                 ``torch.Generator`` (zero sample bytes on the wire);
                 anchors and the partition tree are built from the pivots,
                 replicated deterministic work.

  stage_counts   the fused map-assign kernel per shard, then four
                 ``all_gather``s: per-(shard, cell) |V| and |W| counts and
                 the per-cell mapped-coordinate MBBs (whole-box tightening).

  stage_verify   map-assign, capacity-bounded (slot, rank) dispatch buffers,
                 the shuffle (``all_to_all_single`` with equal splits of the
                 (spd, cap, ...) buffers — three buffers per side, six in
                 all), then each received slot through the port's streaming
                 tiled engine (``core.verify.verify_cell_lists``) with the
                 slot's ORIGINAL cell id for the min-cell de-dup rule.

  serve          ``DistIndex``: V slots pinned per rank once; a query batch
                 is map-assigned, W-dispatched, shuffled (three
                 ``all_to_all``s) and verified R×S against the pinned slots.

Differences from the reference, by design:

* The reference verifies a slot as ONE dense (M·cap_v) × (M·cap_w) tile.
  At 1,000,000 rows and p = 16 one slot is ~62,500 × ~800,000 pairs, so
  the port hands each slot's valid rows to the tiled engine instead: the
  filtered kernel for ``emit="mask"``, verify-compact for ``"compact"``.
  The counters keep the reference's meaning: ``verified`` = Σ valid
  |V|·|W|, ``candidates`` = pairs inside the L∞ bound, ``hits``,
  ``per_cell_verified`` and ``overflow``.
* W rows are scattered slot by slot into the buffer (``index_select`` into
  the slot's rows), never through an (n_loc, n_slots, m) broadcast.
* Compact emission's overflow ladder is the engine's per tile
  (``VerifyStats.n_overflow_retries``); there is no static per-slot pair
  buffer, so ``VerifyConfig`` has no ``pair_cap``.
* The reference reads its axis-sharded outputs on the host; here that read
  is an explicit gather of the per-rank results (``_gather_results``),
  counted apart from the stages' collectives as ``result.all_gather``.
* torch cannot replay ``jax.random``: the pivots differ from the
  reference's, the join is exact for any pivots, and ``convert.join_plan``
  injects the reference's plan where a test needs stage parity.

Collective budgets (``tools/spjoin_lint/contracts_baseline.json``), one
stage call each: stats 3 ``all_gather``, counts 4 ``all_gather``, verify 6
``all_to_all`` (self and R×S), serve 3 ``all_to_all``. Every collective
goes through :func:`_all_gather` or the exchange of :func:`_make_exchange`,
which count it under its stage (:func:`collective_counts`).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import cost_model, distances, expfam, gof, mapping, partition, sampling
from repro_torch.core import placement as placement_lib
from repro_torch.core import verify as verify_lib
from repro_torch.core.spjoin import _ANCHOR_SEED_OFFSET, _sync
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Collectives, counted per stage
# ---------------------------------------------------------------------------

_COLLECTIVES: dict[str, int] = {}


def collective_counts() -> dict[str, int]:
    """Collectives issued since :func:`reset_collective_counts`, keyed
    ``"<stage>.<op>"`` (stages stats, counts, verify, serve; ``result`` is
    the gather of per-rank results)."""
    return dict(_COLLECTIVES)


def reset_collective_counts() -> None:
    _COLLECTIVES.clear()


def _count(stage: str, op: str) -> None:
    key = f"{stage}.{op}"
    _COLLECTIVES[key] = _COLLECTIVES.get(key, 0) + 1


def _all_gather(t: Tensor, group, stage: str) -> Tensor:
    """One ``all_gather`` of ``t`` over ``group``: (M, *t.shape)."""
    _count(stage, "all_gather")
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Stage 1: per-shard stats + gather (sampling phase stages 1-2)
# ---------------------------------------------------------------------------


def _fit_all_families(x: Tensor, valid: Tensor, t_cells: int, backend: str):
    """Fit every candidate family on one shard; return (packed (F, 2m+1),
    conf (F,)). Families whose support excludes the data self-eliminate."""
    stats = expfam.suff_stats(x, valid)
    w = valid.float()
    nonneg = ((x >= 0) | ~valid.bool()[:, None]).all()
    n_eff = w.sum()
    m = x.shape[-1]
    packed, confs = [], []
    for fam in expfam.FAMILIES:
        params = expfam.fit(fam, stats)
        u = expfam.cdf(params, x.float())
        nu = kops.histogram(u, t_cells, w, backend=backend)
        expected = torch.clamp(n_eff / t_cells, min=1e-9)
        k_star = (((nu - expected) ** 2) / expected).sum()
        dof = max(float(m * (t_cells - params.n_params - 1)), 1.0)
        conf = gof.chi2_sf(k_star, dof)
        if fam in ("exponential", "gamma"):
            conf = torch.where(nonneg, conf, torch.zeros_like(conf))
        packed.append(expfam.pack(params))
        confs.append(conf)
    return torch.stack(packed), torch.stack(confs)


def make_stage_stats(group=None, t_cells: int = 8, backend: str = "auto"):
    """The stats stage. Each rank calls the returned function on its shard
    (x (n_loc, m), valid (n_loc,)); every rank gets the replicated per-node
    packets (M, 2m+1), confidences (M,) and valid-row counts (M,)."""

    def per_shard(x: Tensor, valid: Tensor):
        packed, confs = _fit_all_families(x, valid, t_cells, backend)
        best = int(torch.argmax(confs))
        my_count = valid.float().sum()
        packets = _all_gather(packed[best], group, "stats")  # (M, 2m+1)
        conf_all = _all_gather(confs[best].reshape(1), group, "stats")[:, 0]  # (M,)
        count_all = _all_gather(my_count.reshape(1), group, "stats")[:, 0]  # (M,)
        return packets, conf_all, count_all

    return per_shard


# ---------------------------------------------------------------------------
# Control plane: replicated Gibbs + partition plan
# ---------------------------------------------------------------------------


def gibbs_from_packets(
    gen: torch.Generator, packets: Tensor, confs: Tensor, counts: Tensor, k: int, length: int
) -> tuple[Tensor, float]:
    """Alg. 4 as a fixed-length chain over gathered packets.

    Deterministic in (generator state, packets): every rank seeds the same
    generator and replays the identical chain, so pivots are replicated
    without communication. Acceptance runs on max-normalised confidences;
    weights are N_i (C=0) and N_i / c_i (C=1) with N_i ≥ 1. Each node's
    family is read from its packet (``expfam.unpack`` — the reference's
    traced family switch, ``_packed_node_sample``). Shortfall and
    zero-accept compaction is the single-host chain's
    (``sampling._compact_accepted``); an acceptance rate of 0.0 is the
    caller's cue to warn."""
    conf = torch.clamp(confs.detach().float().cpu(), 1e-6, 1.0)
    conf = torch.clamp(conf / conf.max(), 1e-3, 1.0)
    cnt = torch.clamp(counts.detach().double().cpu(), min=1.0)
    params = [expfam.unpack(packets[e]) for e in range(packets.shape[0])]
    return sampling._gibbs_draws(gen, cnt, conf, length, k, params)


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """Everything the counts, verify and serve stages need; replicated."""

    anchors: Tensor  # (n, m)
    metric: str
    kernel_lo: Tensor  # (p, n)
    kernel_hi: Tensor
    whole_lo: Tensor
    whole_hi: Tensor
    delta: float
    p: int

    def partition_plan(self) -> partition.PartitionPlan:
        return partition.PartitionPlan(
            self.kernel_lo, self.kernel_hi, self.whole_lo, self.whole_hi, self.delta
        )


def build_join_plan(
    gen: torch.Generator,
    pivots: Tensor,
    *,
    delta: float,
    metric: str = "l1",
    p: int = 16,
    n_dims: int = 8,
    partitioner: str = "learning",
    anchor_method: str = "fft",
    n_clusters: int | None = None,
    seed: int = 0,
) -> JoinPlan:
    """Anchors, mapping, labels and the partition tree from the pivots (the
    single-host ``spjoin.build_plan`` control plane)."""
    smap = mapping.select_anchors(gen, pivots, n_dims, metric, anchor_method)
    mapped = smap(pivots).cpu().numpy()
    labels = None
    if partitioner == "learning":
        d = distances.pairwise(pivots, pivots, metric).cpu().numpy()
        labels = partition.single_linkage_labels(d, n_clusters or 2 * p)
    plan = partition.build_partition(
        mapped, p, delta, strategy=partitioner, labels=labels, seed=seed, device=pivots.device
    )
    return JoinPlan(
        anchors=smap.anchors,
        metric=metric,
        kernel_lo=plan.kernel_lo,
        kernel_hi=plan.kernel_hi,
        whole_lo=plan.whole_lo,
        whole_hi=plan.whole_hi,
        delta=float(delta),
        p=int(p),
    )


def _map_assign(plan: JoinPlan, x: Tensor, valid: Tensor, backend: str, fused: bool = True):
    """Space-map a shard and compute kernel cell + whole membership.

    ``fused=True`` runs the map-assign kernel (one pass, packed membership);
    ``fused=False`` keeps the two-pass control (pairdist, then plain
    containment sweeps). Returns (cells (n,) int32, member (n, p) bool with
    invalid rows cleared, valid (n,) bool, xm (n, n_dims))."""
    if fused:
        xm, cells, bits = kops.map_assign(
            x, plan.anchors, plan.kernel_lo, plan.kernel_hi,
            plan.whole_lo, plan.whole_hi, plan.metric, backend=backend,
        )
        member = kops.unpack_membership(bits, plan.p)
    else:
        xm = kops.pairdist(x, plan.anchors, plan.metric, backend=backend)
        cells = kref.assign_kernel_cells(xm, plan.kernel_lo, plan.kernel_hi)
        member = (
            (xm[:, None, :] >= plan.whole_lo[None]) & (xm[:, None, :] <= plan.whole_hi[None])
        ).all(-1)
    v = valid.bool()
    return cells, member & v[:, None], v, xm


# ---------------------------------------------------------------------------
# Stage 2: counting pass (exact-fit capacity planning)
# ---------------------------------------------------------------------------


def make_stage_counts(plan: JoinPlan, group=None, backend: str = "auto", fused: bool = True):
    """The counting stage: (x, valid) on each rank -> replicated
    (v_counts (M, p), w_counts (M, p), cell_lo (M, p, n), cell_hi (M, p, n)).
    The per-cell mapped-coordinate MBBs ride along (segment min/max) for
    whole-box tightening; an empty cell's MBB is (BIG, -BIG)."""
    p = plan.p

    def per_shard(x: Tensor, valid: Tensor):
        cells, member, v, xm = _map_assign(plan, x, valid, backend, fused)
        cl = cells.long()
        v_cnt = torch.zeros((p,), dtype=torch.int32, device=x.device).index_add_(0, cl, v.int())
        w_cnt = member.sum(0).to(torch.int32)
        safe = torch.where(v, cl, p)[:, None].expand(-1, xm.shape[1])  # invalid -> dropped row p
        xm = xm.float()
        lo = torch.full((p + 1, xm.shape[1]), partition.BIG, device=x.device)
        hi = torch.full((p + 1, xm.shape[1]), -partition.BIG, device=x.device)
        lo = lo.scatter_reduce(0, safe, xm, "amin")[:p]
        hi = hi.scatter_reduce(0, safe, xm, "amax")[:p]
        return (
            _all_gather(v_cnt, group, "counts"),
            _all_gather(w_cnt, group, "counts"),
            _all_gather(lo, group, "counts"),
            _all_gather(hi, group, "counts"),
        )

    return per_shard


# ---------------------------------------------------------------------------
# Stage 3: dispatch (all_to_all) + tiled verify
# ---------------------------------------------------------------------------


def _rank_within(keys: Tensor, n_keys: int) -> Tensor:
    """For each element, how many EARLIER elements share its key (keys in
    [0, n_keys)): the intra-group rank in row order."""
    keys = keys.long()
    order = torch.argsort(keys, stable=True)
    cnt = torch.bincount(keys, minlength=n_keys)
    start = torch.cumsum(cnt, 0) - cnt
    rank = torch.empty_like(keys)
    rank[order] = torch.arange(keys.shape[0], device=keys.device) - start[keys[order]]
    return rank


def _fill_slots(rows: Tensor, ids: Tensor, own: Tensor, slot_rows: list[Tensor], cap: int):
    """Dispatch buffers from each slot's row indices (row order = intra-slot
    rank): (n_slots, cap, D) rows, (n_slots, cap) int32 ids and own cells
    (-1 padding), and the number of rows dropped past ``cap``. Each slot is
    one ``index_select`` straight into its rows of the buffer."""
    n_slots, dev = len(slot_rows), rows.device
    buf = torch.zeros((n_slots, cap, rows.shape[1]), dtype=rows.dtype, device=dev)
    buf_ids = torch.full((n_slots, cap), -1, dtype=torch.int32, device=dev)
    buf_own = torch.full((n_slots, cap), -1, dtype=torch.int32, device=dev)
    overflow = 0
    ids32, own32 = ids.to(torch.int32), own.to(torch.int32)
    for s, idx in enumerate(slot_rows):
        n = min(int(idx.numel()), cap)
        overflow += int(idx.numel()) - n
        if n:
            idx = idx[:n]
            torch.index_select(rows, 0, idx, out=buf[s, :n])
            torch.index_select(ids32, 0, idx, out=buf_ids[s, :n])
            torch.index_select(own32, 0, idx, out=buf_own[s, :n])
    return buf, buf_ids, buf_own, overflow


@dataclasses.dataclass(frozen=True)
class _RoutingTables:
    """Static slot-routing tables of a placement plan (host numpy), shared
    by the join's verify stage and the serve stage so the two can never
    disagree on how a cell maps to dispatch slots."""

    p: int
    n_slots: int
    first_slot: np.ndarray  # (p,) first slot of each cell
    n_slabs: np.ndarray  # (p,) V-slab count per cell
    disp_of_slot: np.ndarray  # (n_slots,) slot -> dispatch permutation
    w_col_of_disp: np.ndarray  # (n_slots,) membership column per dispatch
    #   index (padding slots -> the always-False extra column p)
    cell_id_of_disp: np.ndarray  # (n_slots,) original cell id, -1 = padding


def _routing_tables(pl: placement_lib.PlacementPlan) -> _RoutingTables:
    cod = pl.cell_of_dispatch
    return _RoutingTables(
        p=pl.p,
        n_slots=pl.n_slots,
        first_slot=np.asarray(pl.cell_first_slot, np.int64),
        n_slabs=np.asarray(pl.cell_n_slabs, np.int64),
        disp_of_slot=np.asarray(pl.dispatch_of_slot, np.int64),
        w_col_of_disp=np.where(cod >= 0, cod, pl.p).astype(np.int64),
        cell_id_of_disp=np.asarray(cod, np.int64),
    )


def _make_v_dispatch(rt: _RoutingTables, cap_v: int):
    """Each valid row -> its kernel cell's dispatch slot (a heavy cell's rows
    are dealt round-robin over its slabs by intra-cell rank); invalid rows
    go to slot ``n_slots``, which no buffer has."""
    p, n_slots = rt.p, rt.n_slots

    def v_dispatch(x: Tensor, ids: Tensor, cells: Tensor, v: Tensor):
        dev = x.device
        v_cells = torch.where(v, cells.long(), p)
        safe = v_cells.clamp(0, p - 1)
        rank_in_cell = _rank_within(v_cells, p + 1)
        first = torch.as_tensor(rt.first_slot, device=dev)
        slabs = torch.as_tensor(rt.n_slabs, device=dev)
        disp = torch.as_tensor(rt.disp_of_slot, device=dev)
        slot = first[safe] + rank_in_cell % slabs[safe]
        dest = torch.where(v_cells < p, disp[slot], n_slots)
        slot_rows = [(dest == d).nonzero().squeeze(1) for d in range(n_slots)]
        return _fill_slots(x, ids, cells, slot_rows, cap_v)

    return v_dispatch


def _make_w_dispatch(rt: _RoutingTables, cap_w: int):
    """Each valid row -> every whole-member cell's slot(s), replicated into
    each slab of a split cell (ranked per dispatch slot)."""

    def w_dispatch(x: Tensor, ids: Tensor, cells: Tensor, member: Tensor):
        slot_rows = [
            member[:, c].nonzero().squeeze(1) if c < rt.p
            else torch.zeros((0,), dtype=torch.int64, device=x.device)
            for c in rt.w_col_of_disp.tolist()
        ]
        return _fill_slots(x, ids, cells, slot_rows, cap_w)

    return w_dispatch


def _make_exchange(group, M: int, spd: int, stage: str):
    """The shuffle: ONE ``all_to_all_single`` with equal splits per buffer,
    (n_slots, cap, ...) -> (M, spd, cap, ...) -> received from every source
    rank, plus the per-local-slot (spd, M·cap, ...) flattening."""

    def exchange(buf: Tensor) -> Tensor:
        _count(stage, "all_to_all")
        shaped = buf.reshape(M, spd, *buf.shape[1:]).contiguous()
        out = torch.empty_like(shaped)
        dist.all_to_all_single(out, shaped, group=group)
        return out

    def flat(r: Tensor) -> Tensor:
        return r.transpose(0, 1).reshape(spd, M * r.shape[2], *r.shape[3:])

    return exchange, flat


@dataclasses.dataclass(frozen=True)
class VerifyConfig:
    """Knobs of the verify stage.

    ``cap_v`` / ``cap_w``: per-(slot, source-rank) dispatch capacities (the
    shapes of the ``all_to_all`` buffers, exact-fit planned by the counting
    pass times ``capacity_slack``). ``prune``: "none" | "pivot" — with
    "pivot" each row's mapped coordinates ride the same shuffle as
    trailing payload columns and the engine prunes pairs whose L∞ bound
    exceeds ``delta_bound``; cosine and dot resolve back to "none".
    ``emit``: the engine's emission path when ``emit_pairs`` ("mask" |
    "compact").
    """

    cap_v: int
    cap_w: int
    emit_pairs: bool = False
    emit: str = "mask"
    backend: str = "auto"  # torch | cuda | auto (see kernels.ops)
    prune: str = "none"
    delta_bound: float | None = None
    map_fused: bool = True


def _payload(x: Tensor, xm: Tensor, prune: str) -> Tensor:
    """Dispatch rows: the features, plus — under the pivot filter — the
    mapped coordinates as trailing columns (same shuffle, no second one)."""
    if prune == "pivot":
        return torch.cat([x.float(), xm.float()], dim=1)
    return x.float()


def _valid_rows(ids: Tensor) -> Tensor:
    return (ids >= 0).nonzero().squeeze(1)


def _verify_slot(
    vx: Tensor, vids: Tensor, vown: Tensor, wx: Tensor, wids: Tensor, wown: Tensor,
    cell_id: int, *, plan_delta: float, metric: str, engine: verify_lib.EngineConfig,
    cross: bool, n_dims: int, delta_bound: float | None, return_pairs: bool,
):
    """One received slot's valid rows through the tiled engine: V rows
    against W rows as cell ``cell_id`` (the min-cell de-dup rule in a
    self-join, validity alone in R×S), global ids carried. Returns the
    engine's (pairs, VerifyStats)."""
    pivot = engine.prune == "pivot"

    def split(rows: Tensor):
        return (rows[:, :-n_dims], rows[:, -n_dims:]) if pivot else (rows, None)

    nv, nw = vx.shape[0], wx.shape[0]
    if cross:
        vr, vc = split(vx)
        wr, wc = split(wx)
        return verify_lib.verify_cell_lists(
            vr, None, [np.arange(nv)], [np.arange(nw)], plan_delta, metric,
            config=engine, return_pairs=return_pairs, data_w=wr, coords=vc, coords_w=wc,
            ids=vids, ids_w=wids, cell_ids=[cell_id], delta_bound=delta_bound,
        )
    rows, coords = split(torch.cat([vx, wx]))
    return verify_lib.verify_cell_lists(
        rows, torch.cat([vown, wown]), [np.arange(nv)], [np.arange(nv, nv + nw)],
        plan_delta, metric, config=engine, return_pairs=return_pairs, coords=coords,
        ids=torch.cat([vids, wids]), cell_ids=[cell_id], delta_bound=delta_bound,
    )


def _slots_verify(
    fv, fvi, fvo, fw, fwi, fwo, local_cells: np.ndarray, **kw
) -> dict:
    """Verify every local slot; returns the rank's local counters, per-slot
    valid areas and (when asked) its pairs (int64 numpy)."""
    spd = len(local_cells)
    per_slot = np.zeros(spd, np.int64)
    totals = dict(hits=0, verified=0, candidates=0, retries=0, tiles=0)
    chunks = []
    for j in range(spd):
        vpos, wpos = _valid_rows(fvi[j]), _valid_rows(fwi[j])
        nv, nw = int(vpos.numel()), int(wpos.numel())
        per_slot[j] = nv * nw
        if nv == 0 or nw == 0 or local_cells[j] < 0:
            continue
        pairs, st = _verify_slot(
            fv[j].index_select(0, vpos), fvi[j].index_select(0, vpos),
            None if fvo is None else fvo[j].index_select(0, vpos),
            fw[j].index_select(0, wpos), fwi[j].index_select(0, wpos),
            fwo[j].index_select(0, wpos), int(local_cells[j]), **kw,
        )
        totals["hits"] += st.n_hits
        totals["verified"] += st.n_verifications
        totals["candidates"] += st.n_exact if st.prune == "pivot" else st.n_verifications
        totals["retries"] += st.n_overflow_retries
        totals["tiles"] += st.n_tiles
        if pairs.shape[0]:
            chunks.append(pairs)
    pairs = np.concatenate(chunks) if chunks else np.zeros((0, 2), np.int64)
    return {**totals, "per_cell_verified": per_slot, "pairs": pairs}


def make_stage_verify(
    plan: JoinPlan,
    vcfg: VerifyConfig,
    group=None,
    cross: bool = False,
    pl: placement_lib.PlacementPlan | None = None,
):
    """The fused map + shuffle + reduce stage.

    Per rank: map-assign -> dispatch buffers keyed (dest slot, rank) -> the
    shuffle over ``group`` -> per-local-slot tiled verification.

    Cell -> rank follows ``pl`` (``core.placement``): dispatch slot
    ``d·spd + j`` lives on rank ``d``. ``pl=None`` is the contiguous layout
    (cell h on rank h // (p/M); needs p % M == 0). Under an LPT plan the
    scatter targets are permuted through ``pl.dispatch_of_slot`` and a
    heavy cell's V rows are dealt round-robin over its slabs (W rows
    replicated into each) — same buffers, same shuffle, identical pair sets
    (each candidate pair lands in exactly one slab, and every slab verifies
    under the cell's original id).

    ``cross=False``: V and W buffers both come from the one set; the stage
    takes (x, valid, ids). ``cross=True`` (R×S): (xr, valid_r, ids_r, xs,
    valid_s, ids_s) — V from R's kernel cells, W from S's whole membership.

    Returns a function every rank calls on its shards; it returns the
    rank's LOCAL results: ``hits``, ``verified``, ``candidates``,
    ``overflow``, ``retries`` (the engine's compact overflow re-dispatches),
    ``tiles``, ``per_cell_verified`` (spd,) per local dispatch slot, and
    ``pairs`` (global ids; empty unless ``vcfg.emit_pairs``).
    :func:`_gather_results` combines them across ranks.
    """
    M = dist.get_world_size(group)
    rank = dist.get_rank(group)
    p = plan.p
    if pl is None:
        pl = placement_lib.plan_placement(np.zeros(p, np.float64), M, strategy="contiguous")
    assert pl.p == p, f"placement planned for p={pl.p}, stage has p={p}"
    rt = _routing_tables(pl)
    assert rt.n_slots % M == 0, f"n_slots={rt.n_slots} must be a multiple of M={M}"
    spd = rt.n_slots // M
    if vcfg.prune == "window":
        raise ValueError('the distributed stage supports prune="none" | "pivot"')
    prune = verify_lib.resolve_prune(vcfg.prune, plan.metric, True)
    emit = verify_lib.resolve_emit(vcfg.emit, plan.metric) if vcfg.emit_pairs else "mask"
    engine = verify_lib.EngineConfig(backend=vcfg.backend, prune=prune, emit=emit)
    n_dims = plan.anchors.shape[0]
    local_cells = rt.cell_id_of_disp[rank * spd : (rank + 1) * spd]
    v_dispatch = _make_v_dispatch(rt, vcfg.cap_v)
    w_dispatch = _make_w_dispatch(rt, vcfg.cap_w)
    exchange, flat = _make_exchange(group, M, spd, "verify")
    kw = dict(
        plan_delta=plan.delta, metric=plan.metric, engine=engine, cross=cross,
        n_dims=n_dims, delta_bound=vcfg.delta_bound, return_pairs=vcfg.emit_pairs,
    )

    def shuffle_and_verify(v_parts: list, w_parts: list, overflow: int) -> dict:
        """Three all_to_all per side, then per-local-slot verification. The
        send buffers are released as soon as they are exchanged."""
        fv, fvi, fvo = [flat(exchange(b)) for b in v_parts]
        v_parts.clear()
        fw, fwi, fwo = [flat(exchange(b)) for b in w_parts]
        w_parts.clear()
        out = _slots_verify(fv, fvi, fvo, fw, fwi, fwo, local_cells, **kw)
        out["overflow"] = overflow
        return out

    def assign(x, valid):
        return _map_assign(plan, x, valid, vcfg.backend, vcfg.map_fused)

    if cross:
        def per_shard(xr, valid_r, ids_r, xs, valid_s, ids_s):
            cells_r, _, v_r, xm_r = assign(xr, valid_r)
            cells_s, member_s, _, xm_s = assign(xs, valid_s)
            *v_parts, ov = v_dispatch(_payload(xr, xm_r, prune), ids_r, cells_r, v_r)
            *w_parts, ow = w_dispatch(_payload(xs, xm_s, prune), ids_s, cells_s, member_s)
            return shuffle_and_verify(v_parts, w_parts, ov + ow)
    else:
        def per_shard(x, valid, ids):
            cells, member, v, xm = assign(x, valid)
            rows = _payload(x, xm, prune)
            *v_parts, ov = v_dispatch(rows, ids, cells, v)
            *w_parts, ow = w_dispatch(rows, ids, cells, member)
            del rows
            return shuffle_and_verify(v_parts, w_parts, ov + ow)

    return per_shard


_SCALARS = ("hits", "verified", "candidates", "overflow", "retries", "tiles")


def _gather_results(out: dict, group, device: torch.device) -> dict:
    """Gather every rank's local stage results (the read of the reference's
    axis-sharded outputs): one ``all_gather`` of the counters and per-slot
    areas, then one of the pairs padded to the largest rank's count.
    Returns the counters summed, ``per_slot`` (M·spd,) in dispatch order and
    ``pairs`` (all ranks' pairs, concatenated)."""
    pairs = out["pairs"]
    header = torch.as_tensor(
        [int(out[k]) for k in _SCALARS] + [int(pairs.shape[0])]
        + [int(v) for v in out["per_cell_verified"]],
        dtype=torch.int64, device=device,
    )
    allh = _all_gather(header, group, "result").cpu().numpy()
    res = {k: int(allh[:, i].sum()) for i, k in enumerate(_SCALARS)}
    n_pairs = allh[:, len(_SCALARS)]
    res["per_slot"] = allh[:, len(_SCALARS) + 1 :].reshape(-1)
    most = int(n_pairs.max(initial=0))
    if most == 0:
        res["pairs"] = np.zeros((0, 2), np.int64)
        return res
    padded = torch.full((most, 2), -1, dtype=torch.int64, device=device)
    padded[: pairs.shape[0]] = torch.as_tensor(pairs, device=device)
    allp = _all_gather(padded, group, "result").cpu().numpy()
    res["pairs"] = np.concatenate([allp[r, : n_pairs[r]] for r in range(allp.shape[0])])
    return res


def _sorted_unique_pairs(pr: np.ndarray) -> np.ndarray:
    """(n, 2) int64 pairs sorted lexicographically and de-duplicated, through
    one 1-D sort of the key i·(max j + 1) + j (ids are below 2**31)."""
    if pr.shape[0] == 0:
        return np.zeros((0, 2), np.int64)
    pr = pr.astype(np.int64)
    base = int(pr[:, 1].max()) + 1
    key = np.unique(pr[:, 0] * base + pr[:, 1])
    return np.stack([key // base, key % base], axis=1)


# ---------------------------------------------------------------------------
# Driver: the end-to-end distributed join
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistJoinResult:
    """Driver-level result + telemetry of one distributed join (the
    reference's fields, plus the port's stage seconds and tile count).

    ``n_verifications`` is Σ_slots |V|·|W| over the dispatched rows;
    ``n_candidates`` the pairs inside the pivot filter's L∞ bound (==
    n_verifications when pruning is off)."""

    n_hits: int
    n_verifications: int
    per_cell_verified: np.ndarray  # (p,)
    overflow: int
    capacity_padding: float  # Σ cap / Σ actual dispatched rows
    predicted_cap_w: int  # cost-model capacity (sample-scaled)
    exact_cap_w: int
    node_confidences: np.ndarray
    accept_rate: float
    pairs: np.ndarray | None = None  # (n_pairs, 2) int64 when emit_pairs;
    #   self-join (min, max) — R×S (i ∈ R, j ∈ S)
    duplication: float = 0.0  # Σ_slots |W_slot| / |S| (|S| = N for self)
    n_candidates: int = 0
    pruning_rate: float = 0.0  # 1 − n_candidates / n_verifications
    predicted_survival: float = 1.0
    prune: str = "none"
    placement: str = "contiguous"
    placement_plan: Any = None
    device_loads: np.ndarray | None = None  # (M,) measured verifications per rank
    balance_std: float = 0.0
    makespan_ratio: float = 1.0  # max / mean of the measured per-rank loads
    capacity_saved_bytes: int = 0
    emit: str = "mask"
    n_overflow_retries: int = 0  # the engine's compact overflow re-dispatches
    n_tiles: int = 0  # tiles the engines ran exact evaluation on, all ranks
    stats_time_s: float = 0.0  # stats stage(s)
    control_time_s: float = 0.0  # Gibbs chain + plan
    counts_time_s: float = 0.0  # counting pass(es) + placement plan
    verify_time_s: float = 0.0  # verify stage, result gather and pair sort


def _pad_shard_set(x: Tensor, M: int, rank: int) -> tuple[Tensor, Tensor, Tensor, int]:
    """Pad a set to a multiple of M rows (≥ M, so empty sets still shard),
    build validity + global-id vectors, and return THIS rank's shard of
    each: rows [rank·per, (rank+1)·per)."""
    n, m = x.shape
    pad = (-n) % M or (M if n == 0 else 0)
    if pad:
        x = torch.cat([x, torch.zeros((pad, m), dtype=x.dtype, device=x.device)])
    total = n + pad
    per = total // M
    sl = slice(rank * per, (rank + 1) * per)
    ar = torch.arange(total, device=x.device)
    valid = (ar < n).float()
    ids = ar.to(torch.int32)
    return x[sl], valid[sl], ids[sl], n


def distributed_join(
    data,
    *,
    group=None,
    delta: float,
    metric: str = "l1",
    k: int = 1024,
    p: int | None = None,
    n_dims: int = 8,
    sampler: str = "generative",
    partitioner: str = "learning",
    t_cells: int = 8,
    emit_pairs: bool = False,
    emit: str = "mask",
    backend: str = "auto",
    capacity_slack: float = 1.0,
    tighten: bool = True,
    prune: str = "pivot",
    map_fused: bool = True,
    placement: str = "lpt",
    seed: int = 0,
    s=None,
    device: torch.device | str = "cuda",
) -> DistJoinResult:
    """End-to-end distributed join of ``data`` (N, m) over ``group``.

    Every rank of the group calls it with the same arguments: it receives
    the global array and takes its shard (``_pad_shard_set``). Runs on the
    card unless ``device="cpu"`` (then the group must carry CPU tensors:
    gloo). Self-join by default; ``s`` (N_s, m) gives R×S (``data`` is R):
    both sets' node packets are pooled for the chain, V capacities come
    from R's kernel counts and W capacities from S's whole counts; pairs
    are (i ∈ R, j ∈ S). ``s is data`` routes to the self-join.

    ``sampler``: "generative" (default, Alg. 3/4 over the gathered
    packets) or "random" (pivots drawn uniformly from the global set on the
    replicated generator). ``prune``: "pivot" (default) | "none".
    ``emit``: the engine's emission path when ``emit_pairs`` ("mask" |
    "compact"); pair sets are byte-identical either way. ``placement``:
    "lpt" (default) | "contiguous" — the cell→rank plan of the reduce
    phase; pair sets are byte-identical under either.
    """
    if not kops.supports_kernel(metric):
        raise ValueError(
            f"distributed executor supports kernel metrics only ({kops.METRICS}); "
            f"got {metric!r} — use repro_torch.core.spjoin for reference-path metrics"
        )
    if prune == "window":
        raise ValueError('distributed_join supports prune="none" | "pivot"')
    if s is data:
        s = None  # R = S aliasing: the canonical semantics is the self-join
    cross = s is not None
    dev = kops.resolve_device(device)
    kops.strict_fp32()
    M, rank = dist.get_world_size(group), dist.get_rank(group)
    gen = torch.Generator().manual_seed(seed)
    gen_anchor = torch.Generator().manual_seed(seed + _ANCHOR_SEED_OFFSET)
    x_all = verify_lib._as_rows(data, dev)
    n, m = x_all.shape
    backend = kops.resolve_backend(backend, metric, x_all)
    x, valid, ids, _ = _pad_shard_set(x_all, M, rank)
    s_all = xs = valid_s = ids_s = None
    if cross:
        s_all = verify_lib._as_rows(s, dev)
        xs, valid_s, ids_s, n_s = _pad_shard_set(s_all, M, rank)
    else:
        n_s = n
    p = p or 2 * M
    p = int(np.ceil(p / M) * M)

    # ---- sampling phase -------------------------------------------------
    t0 = time.perf_counter()
    stats_fn = make_stage_stats(group, t_cells, backend)
    packets, confs, counts = stats_fn(x, valid)
    if cross:
        # S's shards are additional "local nodes": pool both sets' packets.
        pk_s, cf_s, ct_s = stats_fn(xs, valid_s)
        packets = torch.cat([packets, pk_s])
        confs = torch.cat([confs, cf_s])
        counts = torch.cat([counts, ct_s])
        keep = counts > 0  # all-padding shards carry no distribution
        packets, confs, counts = packets[keep], confs[keep], counts[keep]
    _sync(dev)
    t_stats = time.perf_counter() - t0

    t0 = time.perf_counter()
    accept_rate = 1.0
    confs_np = confs.cpu().numpy()
    if sampler == "generative":
        conf_n = np.clip(confs_np / max(float(confs_np.max()), 1e-6), 1e-3, 1.0)
        c_min = float(np.clip(conf_n.min(), 0.05, 1.0))
        length = int(np.ceil(k / c_min * 1.5)) + 8
        pivots, accept_rate = gibbs_from_packets(gen, packets, confs, counts, k, length)
        if accept_rate <= 0.0:
            warnings.warn(
                "gibbs_from_packets accepted no draws (all node confidences "
                "≈ 0); pivots fall back to raw chain draws", stacklevel=2,
            )
    elif sampler == "random":
        pool = torch.cat([x_all, s_all]) if cross else x_all
        idx = torch.randperm(pool.shape[0], generator=gen)[: min(k, pool.shape[0])]
        pivots = pool[idx.to(dev)]
    else:
        raise ValueError(f"distributed sampler must be generative|random, got {sampler!r}")
    plan = build_join_plan(
        gen_anchor, pivots, delta=delta, metric=metric, p=p, n_dims=n_dims,
        partitioner=partitioner, seed=seed,
    )
    # The whole boxes take the pivot filter's fp guard band instead of δ
    # (partition.widen: Lemma 4 on computed coordinates).
    band = verify_lib.prune_band(delta, metric, x_all, s_all if cross else None)
    if not tighten:
        plan = dataclasses.replace(
            plan, whole_lo=plan.kernel_lo - band, whole_hi=plan.kernel_hi + band
        )
    _sync(dev)
    t_control = time.perf_counter() - t0

    # ---- counting pass + capacity planning ------------------------------
    t0 = time.perf_counter()
    counts_fn = make_stage_counts(plan, group, backend, fused=map_fused)

    def host(ts):
        return [t.cpu().numpy() for t in ts]

    v_cnt, w_cnt, cell_lo, cell_hi = host(counts_fn(x, valid))  # (M, p[, n])
    if cross and not tighten:
        _, w_cnt, _, _ = host(counts_fn(xs, valid_s))
    if tighten:
        # Whole box := the MBB of the cell's R members, expanded by the
        # band (Lemma 4).
        glo = cell_lo.min(0)
        ghi = cell_hi.max(0)
        empty = glo > ghi
        glo = np.where(empty, partition.BIG, glo)
        ghi = np.where(empty, -partition.BIG, ghi)
        plan = dataclasses.replace(
            plan,
            whole_lo=torch.as_tensor((glo - band).astype(np.float32), device=dev),
            whole_hi=torch.as_tensor((ghi + band).astype(np.float32), device=dev),
        )
        counts_fn = make_stage_counts(plan, group, backend, fused=map_fused)
        if cross:
            _, w_cnt, _, _ = host(counts_fn(xs, valid_s))
        else:
            v_cnt, w_cnt, _, _ = host(counts_fn(x, valid))

    # Cost-model prediction from the pivots alone, and the placement plan.
    piv_mapped = kops.pairdist(pivots, plan.anchors, metric, backend=backend)
    pplan = plan.partition_plan()
    piv_cells = partition.assign_kernel(pplan, piv_mapped)
    piv_member = partition.whole_membership(pplan, piv_mapped)
    prune_resolved = verify_lib.resolve_prune(prune, metric, True)
    delta_bound = band if prune_resolved == "pivot" else None
    cell_loads, predicted_survival, _, w_est = placement_lib.planner_inputs(
        piv_mapped.cpu().numpy(), piv_cells.cpu().numpy(), piv_member.cpu().numpy(),
        n, n_s, delta, prune_resolved == "pivot",
    )
    predicted_cap_w = cost_model.predict_capacity(w_est, M, slack=1.25)
    pl = placement_lib.plan_placement(cell_loads, M, strategy=placement)
    v_slot, w_slot = placement_lib.slot_exact_counts(pl, v_cnt, w_cnt)
    exact_cap_v = max(int(v_slot.max(initial=0)), 1)
    exact_cap_w = max(int(w_slot.max(initial=0)), 1)
    cap_v = int(np.ceil(exact_cap_v * capacity_slack))
    cap_w = int(np.ceil(exact_cap_w * capacity_slack))
    cap_saved = placement_lib.capacity_saved_bytes(
        pl, v_cnt, w_cnt,
        placement_lib.dispatch_row_bytes(m, n_dims, prune_resolved == "pivot"),
        slack=capacity_slack,
    )
    _sync(dev)
    t_counts = time.perf_counter() - t0

    # ---- dispatch + verify ------------------------------------------------
    t0 = time.perf_counter()
    emit_resolved = verify_lib.resolve_emit(emit, metric) if emit_pairs else "mask"
    vcfg = VerifyConfig(
        cap_v=cap_v, cap_w=cap_w, emit_pairs=emit_pairs, emit=emit_resolved,
        backend=backend, prune=prune, delta_bound=delta_bound, map_fused=map_fused,
    )
    verify_fn = make_stage_verify(plan, vcfg, group, cross=cross, pl=pl)
    out = (
        verify_fn(x, valid, ids, xs, valid_s, ids_s) if cross else verify_fn(x, valid, ids)
    )
    res = _gather_results(out, group, dev)
    pairs = _sorted_unique_pairs(res["pairs"]) if emit_pairs else None
    t_verify = time.perf_counter() - t0

    # Per-slot telemetry (dispatch order) folds back to cells and ranks.
    per_slot = res["per_slot"]
    cod = pl.cell_of_dispatch
    per_cell = np.zeros(p, np.float32)
    np.add.at(per_cell, cod[cod >= 0], per_slot[cod >= 0])
    device_loads = per_slot.reshape(M, -1).sum(1).astype(np.float64)
    actual_v = int(v_slot.sum())
    actual_w = int(w_slot.sum())
    padding = (pl.n_slots * M * (cap_v + cap_w)) / max(actual_v + actual_w, 1)

    n_verifications = res["verified"]
    n_candidates = res["candidates"]
    return DistJoinResult(
        n_hits=res["hits"],
        n_verifications=n_verifications,
        per_cell_verified=per_cell,
        overflow=res["overflow"],
        capacity_padding=float(padding),
        predicted_cap_w=int(predicted_cap_w),
        exact_cap_w=exact_cap_w,
        node_confidences=confs_np,
        accept_rate=float(accept_rate),
        pairs=pairs,
        duplication=float(actual_w / max(n_s, 1)),
        n_candidates=n_candidates,
        pruning_rate=float(1.0 - n_candidates / max(n_verifications, 1)),
        predicted_survival=float(predicted_survival),
        prune=prune_resolved,
        placement=placement,
        placement_plan=pl,
        device_loads=device_loads,
        balance_std=float(device_loads.std()),
        makespan_ratio=float(device_loads.max() / max(device_loads.mean(), 1e-9)),
        capacity_saved_bytes=int(cap_saved),
        emit=vcfg.emit if emit_pairs else "mask",
        n_overflow_retries=res["retries"],
        n_tiles=res["tiles"],
        stats_time_s=t_stats,
        control_time_s=t_control,
        counts_time_s=t_counts,
        verify_time_s=t_verify,
    )


# ---------------------------------------------------------------------------
# Query serving: pinned V slots + W-side-only dispatch (core.index backend)
# ---------------------------------------------------------------------------


def make_stage_serve(
    qplan: JoinPlan,
    pl: placement_lib.PlacementPlan,
    *,
    group=None,
    cap_w: int,
    backend: str,
    prune: str,
    delta_bound: float | None = None,
    map_fused: bool = True,
    tile_v: int = 1024,
    tile_w: int = 4096,
):
    """The query phase of a persistent index: verify a query batch against
    V slots that are ALREADY RESIDENT on each rank (``DistIndex`` pins them
    once) — only the queries move.

    Per rank: the join's map-assign routes the local queries to their
    whole-member cells under the δ-expanded query boxes, the shared W
    dispatch scatters them (coordinates as trailing columns under the pivot
    filter), three ``all_to_all``s, then each local slot R×S through the
    tiled engine against the pinned V rows. The routing tables, W dispatch
    and exchange are the verify stage's own. Returns the rank's local
    results (as ``make_stage_verify``'s function does)."""
    M = dist.get_world_size(group)
    rank = dist.get_rank(group)
    rt = _routing_tables(pl)
    assert rt.n_slots % M == 0, f"n_slots={rt.n_slots} must be a multiple of M={M}"
    spd = rt.n_slots // M
    local_cells = rt.cell_id_of_disp[rank * spd : (rank + 1) * spd]
    w_dispatch = _make_w_dispatch(rt, cap_w)
    exchange, flat = _make_exchange(group, M, spd, "serve")
    engine = verify_lib.EngineConfig(backend=backend, tile_v=tile_v, tile_w=tile_w, prune=prune)
    kw = dict(
        plan_delta=qplan.delta, metric=qplan.metric, engine=engine, cross=True,
        n_dims=qplan.anchors.shape[0], delta_bound=delta_bound, return_pairs=True,
    )

    def per_shard(fv: Tensor, fvi: Tensor, q: Tensor, valid: Tensor, ids: Tensor) -> dict:
        # fv: (spd, cap_v, m[+n]) this rank's pinned V slots (dispatch
        # order); fvi: (spd, cap_v) their global R ids (pad = -1).
        cells_q, member_q, _, qm = _map_assign(qplan, q, valid, backend, map_fused)
        w_buf, w_ids, w_own, overflow = w_dispatch(_payload(q, qm, prune), ids, cells_q, member_q)
        fw, fwi, fwo = (flat(exchange(b)) for b in (w_buf, w_ids, w_own))
        out = _slots_verify(fv, fvi, None, fw, fwi, fwo, local_cells, **kw)
        out["overflow"] = overflow
        return out

    return per_shard


@dataclasses.dataclass
class DistIndex:
    """A ``core.index.MetricIndex`` pinned on the ranks of a process group.

    ``from_index`` lays the indexed rows out per placement slot (slabs deal
    V rows round-robin by intra-cell rank, like the join's V dispatch),
    keeps each rank's own slots on its device ONCE, and re-plans placement
    (a static permutation from the stored cost-model loads) when the world
    size differs from the plan the index was built for. Every
    ``query_batch`` after that moves only query bytes. Every rank holds the
    same host index and calls every method with the same arguments.
    """

    index: Any  # the MetricIndex (duck-typed; no import cycle)
    group: Any
    pl: placement_lib.PlacementPlan
    backend: str  # the index's resolved backend
    prune: str  # resolved prune mode
    cap_v: int
    fv: Tensor  # (spd, cap_v, m[+n]) this rank's pinned V payload, dispatch order
    fv_ids: Tensor  # (spd, cap_v) int32 global R ids, same layout (-1 = pad)
    _x_abs: float  # max |payload| of the indexed set (prune-band input)
    _stages: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_devices(self) -> int:
        return dist.get_world_size(self.group)

    @classmethod
    def from_index(cls, index: Any, group=None) -> "DistIndex":
        if not kops.supports_kernel(index.metric):
            raise ValueError(
                f"distributed serving supports kernel metrics only ({kops.METRICS}); "
                f"got {index.metric!r} — query the MetricIndex directly for "
                f"reference-path metrics"
            )
        if index.prune == "window":
            raise ValueError('distributed serving supports prune="none" | "pivot"')
        M, rank = dist.get_world_size(group), dist.get_rank(group)
        prune = verify_lib.resolve_prune(index.prune, index.metric, True)
        pl = index.placement
        if pl.n_devices != M:
            pl = placement_lib.plan_placement(pl.cell_loads, M, strategy=index.placement_strategy)
        payload = _payload(index.data, index.coords, prune)
        # Slot layout: slab j of cell h takes the cell's rows with
        # intra-cell rank ≡ j (mod n_slabs) — the V-dispatch deal.
        slot_rows = []
        for slot in range(pl.n_slots):
            cell = int(pl.slot_cell[slot])
            if cell < 0:
                slot_rows.append(np.zeros(0, np.int64))
                continue
            rows = index.v_lists[cell]
            slot_rows.append(rows[int(pl.slot_slab[slot]) :: int(pl.cell_n_slabs[cell])])
        cap_v = max(1, max(r.size for r in slot_rows))
        spd = pl.n_slots // M
        slot_of_disp = pl.slot_of_dispatch
        dev = index.data.device
        buf = torch.zeros((spd, cap_v, payload.shape[1]), dtype=torch.float32, device=dev)
        ids = torch.full((spd, cap_v), -1, dtype=torch.int32, device=dev)
        for j in range(spd):
            rows = slot_rows[int(slot_of_disp[rank * spd + j])]
            if rows.size:
                r = torch.as_tensor(rows, device=dev)
                torch.index_select(payload, 0, r, out=buf[j, : rows.size])
                ids[j, : rows.size] = r.to(torch.int32)
        return cls(
            index=index, group=group, pl=pl, backend=index.backend, prune=prune,
            cap_v=cap_v, fv=buf, fv_ids=ids,
            _x_abs=float(payload.abs().max()) if payload.numel() else 0.0,
        )

    def _stage(self, delta: float, cap_w: int, band: float, delta_bound: float | None):
        key = (float(delta), int(cap_w), band, delta_bound)
        fn = self._stages.get(key)
        if fn is None:
            idx = self.index
            qlo, qhi = idx.query_boxes(band)
            dev = idx.data.device
            qplan = JoinPlan(
                anchors=torch.as_tensor(idx.anchors, device=dev),
                metric=idx.metric,
                kernel_lo=torch.as_tensor(idx.kernel_lo, device=dev),
                kernel_hi=torch.as_tensor(idx.kernel_hi, device=dev),
                whole_lo=torch.as_tensor(qlo, device=dev),
                whole_hi=torch.as_tensor(qhi, device=dev),
                delta=float(delta),
                p=idx.p,
            )
            fn = make_stage_serve(
                qplan, self.pl, group=self.group, cap_w=cap_w, backend=self.backend,
                prune=self.prune, delta_bound=delta_bound, map_fused=idx.map_fused,
                tile_v=idx.tile_v, tile_w=idx.tile_w,
            )
            self._stages[key] = fn
        return fn

    def query_batch(self, q, delta: float | None = None) -> np.ndarray:
        """Batched δ-range query over the group: (i ∈ R, j ∈ Q) pairs with
        D ≤ δ, sorted unique int64, byte-identical to the host index's
        ``query_batch``. Only query bytes move."""
        idx = self.index
        delta = idx.delta if delta is None else float(delta)
        dev = idx.data.device
        q_t = verify_lib._as_rows(q, dev)
        if q_t.dim() != 2 or q_t.shape[0] == 0:
            return np.zeros((0, 2), np.int64)
        M, rank = self.n_devices, dist.get_rank(self.group)
        q_loc, valid, ids, _ = _pad_shard_set(q_t, M, rank)

        # Scale-aware fp band for the query boxes (``MetricIndex.query_band``)
        # and, under prune="pivot", the pivot filter; the query magnitude is
        # rounded up to a power of two so repeat batches share a stage.
        q_abs = float(q_t.abs().max())
        q_pow = float(2.0 ** np.ceil(np.log2(max(q_abs, 1e-9))))
        band = kref.prune_delta(delta, idx.metric, max(self._x_abs, q_pow), int(idx.data.shape[1]))
        delta_bound = band if self.prune == "pivot" else None

        # Exact-fit W capacity from a routing pass over the whole batch (the
        # stage's own map-assign path, so the counts cannot disagree),
        # rounded up to a power of two.
        _, member = idx.route(q_t, delta, band)
        per = q_loc.shape[0]
        mem_pad = np.zeros((per * M, idx.p), bool)
        mem_pad[: q_t.shape[0]] = member.cpu().numpy()
        w_cnt = mem_pad.reshape(M, per, idx.p).sum(1)  # (M, p)
        w_slot = w_cnt[:, np.clip(self.pl.slot_cell, 0, None)]
        w_slot[:, self.pl.slot_cell < 0] = 0
        exact = int(w_slot.max(initial=1))
        cap_w = 1 << max(exact - 1, 1).bit_length()

        out = self._stage(delta, cap_w, band, delta_bound)(self.fv, self.fv_ids, q_loc, valid, ids)
        res = _gather_results(out, self.group, dev)
        assert res["overflow"] == 0, "serve W overflow"
        return _sorted_unique_pairs(res["pairs"])

    def _repin(self) -> None:
        """Re-lay the index out after an absorb (or a drift-triggered
        re-plan / rebuild): fresh slots, fresh routing plan, and a cleared
        stage cache (the query boxes a stage was built with just grew)."""
        fresh = DistIndex.from_index(self.index, self.group)
        self.pl = fresh.pl
        self.backend = fresh.backend
        self.prune = fresh.prune
        self.cap_v = fresh.cap_v
        self.fv = fresh.fv
        self.fv_ids = fresh.fv_ids
        self._x_abs = fresh._x_abs
        self._stages.clear()

    def insert_batch(
        self,
        new_rows,
        *,
        replan_drift: float | None = None,
        resample_drift: float | None = None,
        rebuild_cfg=None,
    ):
        """Distributed mirror of ``MetricIndex.insert_batch``: the same
        control flow, drift monitor and pair set, but ΔR×R_old rides the
        serve stage (only delta bytes move). ΔR×ΔR and the index update run
        on every rank's host index (delta-sized work), then the grown index
        is re-pinned. Returns ``(new_pairs, StreamStats)``."""
        pairs, stats = self.index.insert_batch(
            new_rows,
            replan_drift=replan_drift,
            resample_drift=resample_drift,
            rebuild_cfg=rebuild_cfg,
            _cross_pairs_fn=self.query_batch,
        )
        self._repin()
        return pairs, stats
