"""Cost-model-guided reduce placement: the skew-aware cell→device planner.

The paper's second headline contribution is the cost model "as the guideline
to split the whole datasets into partitions in map and reduce phases" (§5.1);
optimal assignment is NP-hard (Theorem 4), so SP-Join ships heuristics with
*explainable* balance quality (Table 3). This module is the placement half of
that story for the distributed executor: given the cost model's per-cell
predicted verification loads (``cost_model.estimate_from_samples`` scaled by
``estimate_survival_rate`` — Eq. 33 costs from the sampled pivots alone), it
produces a cell→device assignment that minimizes the makespan (the "curse of
the last reducer"), instead of the historical ``cell h → device h // (p/D)``
contiguous layout that lets one hot cell straggle its device.

Two mechanisms, both static (planned on the host before the verify stage
compiles, so they ride the existing ``all_to_all`` — no new collectives):

* **Cardinality-constrained LPT** (longest-processing-time greedy): slots are
  sorted by descending predicted load and each is assigned to the least-loaded
  device that still has a free dispatch slot. The cardinality constraint
  (exactly ``n_slots / D`` slots per device) is what keeps the shuffle layout
  a pure *permutation* of the contiguous one — same buffer shapes, same single
  ``all_to_all``, only the scatter targets reorder.

* **Heavy-cell splitting**: a cell whose predicted load exceeds the per-device
  budget (mean device load) is split into V-side row *slabs* — V rows are
  dealt round-robin across the slabs by intra-cell rank while the W side is
  replicated into every slab. Each candidate pair (v, w) of the cell appears
  in exactly the slab holding v, and every slab carries the cell's original id
  for the min-cell de-dup rule, so the emitted pair set is unchanged (the
  "emission ownership is R's kernel cell" invariant — slabs only partition V).
  Splitting trades W-side duplication for a bounded max slot load.

Quality report (all a-posteriori, computed on the loads actually planned):

* ``lower_bound`` = max(Σloads / D, max slot load) — no schedule beats it.
* ``makespan_ratio`` = makespan / lower_bound (≥ 1; 1 = perfectly balanced).
* ``lpt_factor`` = 4/3 − 1/(3D) — Graham's guarantee for unconstrained LPT
  (LPT-makespan ≤ lpt_factor · OPT). The cardinality-constrained variant we
  run additionally certifies ``certified_bound`` per plan: when the critical
  device's last slot was placed while it was the globally least-loaded device
  (the common case), Graham's argument gives makespan ≤ Σ/D + (1 − 1/D)·x
  with x that slot's load; otherwise the trivial slots-per-device bound
  applies. ``makespan ≤ certified_bound`` always holds and is asserted by
  ``tests/test_placement.py``; docs/COST_MODEL.md walks the derivation.

Byte-identity contract: placement NEVER changes the emitted pair set — it only
permutes which device verifies which cell (and slabs only partition V rows).
``tests/test_placement.py`` enforces fixed-seed byte-identity placement on/off
on both executors, self-join and R×S.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import cost_model

STRATEGIES = ("contiguous", "lpt")

# Streaming drift thresholds (docs/STREAMING.md decision table). Measured as
# cost_model.load_drift (total-variation distance of normalized cell loads):
# past REPLAN_DRIFT the plan's relative weights are stale enough that a cheap
# re-plan (static permutation, pairs unchanged) pays for itself; past
# RESAMPLE_DRIFT the pivot sample itself no longer describes the data and
# only a re-sample + rebuild resets the predictions.
REPLAN_DRIFT = 0.15
RESAMPLE_DRIFT = 0.5

DRIFT_ACTIONS = ("none", "replan", "resample")


def drift_action(
    drift: float,
    replan_threshold: float = REPLAN_DRIFT,
    resample_threshold: float = RESAMPLE_DRIFT,
) -> str:
    """Map a measured drift to the action the streaming layer should fire:
    the cheap one ("replan" — re-run :func:`plan_placement` on the observed
    loads; a static permutation, the pair set cannot change) before the
    expensive one ("resample" — redraw pivots and rebuild the index). The
    thresholds are ordered: a drift past both fires "resample"."""
    if resample_threshold < replan_threshold:
        raise ValueError(
            f"resample threshold ({resample_threshold}) must be >= replan "
            f"threshold ({replan_threshold}) — the cheap action fires first"
        )
    if drift >= resample_threshold:
        return "resample"
    if drift >= replan_threshold:
        return "replan"
    return "none"


def device_loads_under(plan: "PlacementPlan", cell_loads: np.ndarray) -> np.ndarray:
    """(D,) per-device loads an EXISTING plan induces for a NEW per-cell load
    vector (each cell's load spread evenly over its slabs, padding slots 0).
    This is how the drift monitor scores the stale plan against observed
    loads — ``plan.device_loads`` always reflects the loads the plan was
    built from, not what the data has become."""
    loads = np.asarray(cell_loads, np.float64).reshape(-1)
    if loads.shape[0] != plan.p:
        raise ValueError(f"expected {plan.p} cell loads, got {loads.shape[0]}")
    real = plan.slot_cell >= 0
    cell = np.clip(plan.slot_cell, 0, None)
    slot_load = np.where(real, loads[cell] / plan.cell_n_slabs[cell], 0.0)
    out = np.zeros(plan.n_devices, np.float64)
    np.add.at(out, plan.device_of_slot, slot_load)
    return out


def planner_inputs(
    piv_mapped: np.ndarray,
    piv_cells: np.ndarray,
    piv_member: np.ndarray,
    n_v: int,
    n_w: int,
    delta: float,
    prune_active: bool,
) -> tuple[np.ndarray, float, np.ndarray, np.ndarray]:
    """The cost-model → planner pipeline, shared VERBATIM by both executors
    (their plan-parity contract is "same loads → same plan", so the loads
    must come from one code path).

    ``piv_mapped`` / ``piv_cells`` / ``piv_member``: the sampled pivots'
    mapped coordinates, kernel cells and whole membership under the final
    partition plan. ``n_v`` / ``n_w``: dataset sizes the V / W estimates
    scale to (equal for a self-join; |R| / |S| for R×S — the W side scales
    with S). ``prune_active``: pivot filter resolved on ⇒ survival-adjust
    the loads (:func:`cost_model.estimate_survival_rate`).

    Returns ``(cell_loads, predicted_survival, v_est, w_est)``.
    """
    piv_cells = np.asarray(piv_cells)
    piv_member = np.asarray(piv_member)
    piv_mapped = np.asarray(piv_mapped)
    v_est, w_est = cost_model.estimate_from_samples(piv_cells, piv_member, n_v)
    if n_w != n_v:
        _, w_est = cost_model.estimate_from_samples(piv_cells, piv_member, n_w)
    survival = (
        cost_model.estimate_survival_rate(
            piv_mapped, delta, cells=piv_cells, member=piv_member
        )
        if prune_active
        else 1.0
    )
    return (
        cost_model.predicted_cell_loads(v_est, w_est, survival),
        float(survival),
        v_est,
        w_est,
    )


def dispatch_row_bytes(m_features: int, n_coords: int, prune_active: bool) -> int:
    """Bytes of one dispatched row in the shuffle buffers: f32 payload
    (plus the mapped coordinates riding as trailing columns under the pivot
    filter) + the id and own-cell int32s. One formula for both executors'
    ``capacity_saved_bytes`` accounting."""
    return 4 * (m_features + (n_coords if prune_active else 0)) + 8


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """A static cell→device assignment plus its quality report.

    Slot space: each original cell h occupies ``cell_n_slabs[h]`` consecutive
    slots starting at ``cell_first_slot[h]``; padding slots (``slot_cell ==
    -1``, zero load) round ``n_slots`` up to a multiple of ``n_devices``.
    Dispatch space: ``dispatch_of_slot`` is the permutation the executor
    scatters through — dispatch index ``d·spd + j`` lives on device ``d``
    (``spd = n_slots // n_devices``), exactly like the historical contiguous
    layout, so the plan rides the existing ``all_to_all`` unchanged.
    """

    strategy: str  # "contiguous" | "lpt"
    n_devices: int
    p: int  # original cell count
    n_slots: int  # p + extra slabs + padding; multiple of n_devices
    cell_loads: np.ndarray  # (p,) predicted per-cell verification loads
    cell_first_slot: np.ndarray  # (p,) int32 — first slot of each cell
    cell_n_slabs: np.ndarray  # (p,) int32 ≥ 1 — V-slab count per cell
    slot_cell: np.ndarray  # (n_slots,) int32 — original cell, -1 = padding
    slot_slab: np.ndarray  # (n_slots,) int32 — slab index within the cell
    slot_load: np.ndarray  # (n_slots,) float64 — predicted load per slot
    dispatch_of_slot: np.ndarray  # (n_slots,) int32 permutation slot→dispatch
    certified_bound: float  # provable a-posteriori makespan bound (see module)

    # -- derived views -----------------------------------------------------

    @property
    def slots_per_device(self) -> int:
        return self.n_slots // self.n_devices

    @property
    def slot_of_dispatch(self) -> np.ndarray:
        """(n_slots,) inverse permutation: dispatch index → slot."""
        inv = np.empty(self.n_slots, np.int32)
        inv[self.dispatch_of_slot] = np.arange(self.n_slots, dtype=np.int32)
        return inv

    @property
    def cell_of_dispatch(self) -> np.ndarray:
        """(n_slots,) original cell id per dispatch index (-1 = padding).
        This is the array the verify stage uses as the per-slot de-dup cell
        id, and the driver uses to fold per-slot telemetry back to cells."""
        return self.slot_cell[self.slot_of_dispatch]

    @property
    def device_of_slot(self) -> np.ndarray:
        return (self.dispatch_of_slot // self.slots_per_device).astype(np.int32)

    @property
    def device_loads(self) -> np.ndarray:
        """(D,) predicted load per device under this plan."""
        out = np.zeros(self.n_devices, np.float64)
        np.add.at(out, self.device_of_slot, self.slot_load)
        return out

    @property
    def makespan(self) -> float:
        return float(self.device_loads.max(initial=0.0))

    @property
    def lower_bound(self) -> float:
        """max(mean device load, max slot load) — no schedule of these slots
        on D devices can finish sooner."""
        return float(
            max(
                self.slot_load.sum() / max(self.n_devices, 1),
                self.slot_load.max(initial=0.0),
            )
        )

    @property
    def makespan_ratio(self) -> float:
        """Makespan / lower bound (≥ 1); the Table-3-style balance headline."""
        return self.makespan / max(self.lower_bound, 1e-12)

    @property
    def balance_std(self) -> float:
        """Std of predicted per-device loads (Table 3 STDEV, device-level)."""
        return float(self.device_loads.std())

    @property
    def lpt_factor(self) -> float:
        """Graham's LPT guarantee vs the (unknown) optimum: 4/3 − 1/(3D)."""
        return 4.0 / 3.0 - 1.0 / (3.0 * max(self.n_devices, 1))

    @property
    def n_split_cells(self) -> int:
        return int((self.cell_n_slabs > 1).sum())


def _slot_tables(
    cell_loads: np.ndarray, n_slabs: np.ndarray, n_devices: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Lay cells out into slot space (cell-major, slabs consecutive) and pad
    ``n_slots`` up to a multiple of ``n_devices`` with zero-load -1 slots."""
    p = cell_loads.shape[0]
    first = np.zeros(p, np.int64)
    if p:
        first[1:] = np.cumsum(n_slabs)[:-1]
    n_real = int(n_slabs.sum())
    n_slots = -(-max(n_real, 1) // n_devices) * n_devices
    slot_cell = np.full(n_slots, -1, np.int32)
    slot_slab = np.zeros(n_slots, np.int32)
    slot_load = np.zeros(n_slots, np.float64)
    for h in range(p):
        s = int(n_slabs[h])
        sl = slice(int(first[h]), int(first[h]) + s)
        slot_cell[sl] = h
        slot_slab[sl] = np.arange(s)
        slot_load[sl] = cell_loads[h] / s  # V rows dealt evenly across slabs
    return first.astype(np.int32), slot_cell, slot_slab, slot_load


def plan_placement(
    cell_loads: np.ndarray,
    n_devices: int,
    strategy: str = "lpt",
    split: bool = True,
    max_slabs: int | None = None,
) -> PlacementPlan:
    """Plan the cell→device assignment for the reduce phase.

    ``cell_loads``: (p,) predicted per-cell verification loads — Eq. 33 cell
    costs |V̂_h|·|Ŵ_h| (survival-adjusted when the pivot filter is on), from
    ``cost_model.estimate_from_samples`` / ``estimate_survival_rate``.
    ``strategy``: "contiguous" reproduces the historical ``h → h // (p/D)``
    layout (identity permutation, no splitting — the control arm);
    "lpt" runs heavy-cell splitting + cardinality-constrained LPT.
    ``split``: disable heavy-cell splitting (LPT permutation only).
    ``max_slabs``: cap on slabs per cell (default: ``n_devices``).

    Deterministic: ties in the load sort break by slot id (stable sort), ties
    in device choice by lowest device id — same loads in, same plan out.
    """
    loads = np.asarray(cell_loads, np.float64).reshape(-1)
    if np.any(loads < 0) or not np.all(np.isfinite(loads)):
        raise ValueError("cell loads must be finite and non-negative")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown placement strategy {strategy!r}; expected {STRATEGIES}")
    p = loads.shape[0]
    d = max(int(n_devices), 1)

    # -- heavy-cell splitting (lpt only) ------------------------------------
    n_slabs = np.ones(p, np.int64)
    if strategy == "lpt" and split and d > 1 and p:
        budget = loads.sum() / d  # per-device budget = mean device load
        if budget > 0:
            cap = max_slabs if max_slabs is not None else d
            over = loads > budget
            n_slabs[over] = np.minimum(
                np.ceil(loads[over] / budget).astype(np.int64), max(int(cap), 1)
            )
    first, slot_cell, slot_slab, slot_load = _slot_tables(loads, n_slabs, d)
    n_slots = slot_cell.shape[0]
    spd = n_slots // d

    dispatch = np.arange(n_slots, dtype=np.int32)
    certified = float("inf")
    if strategy == "lpt":
        # Cardinality-constrained LPT: descending load (stable ⇒ slot-id tie
        # break), each slot to the least-loaded device with a free slot
        # (lowest device id on ties).
        order = np.argsort(-slot_load, kind="stable")
        dev_load = np.zeros(d, np.float64)
        dev_count = np.zeros(d, np.int64)
        dev_slots: list[list[int]] = [[] for _ in range(d)]
        # Per device: was its LAST assignment made while it was the globally
        # least-loaded device? (Graham's argument then applies a-posteriori.)
        last_unconstrained = np.zeros(d, bool)
        last_load = np.zeros(d, np.float64)
        for s in order:
            free = dev_count < spd
            cand = np.where(free, dev_load, np.inf)
            dd = int(np.argmin(cand))  # argmin takes the lowest id on ties
            if slot_load[s] > 0:  # zero-load slots never move the makespan
                last_unconstrained[dd] = dev_load[dd] <= dev_load.min()
                last_load[dd] = slot_load[s]
            dev_load[dd] += slot_load[s]
            dev_count[dd] += 1
            dev_slots[dd].append(int(s))
        for dd in range(d):
            for j, s in enumerate(dev_slots[dd]):
                dispatch[s] = dd * spd + j
        # A-posteriori certificate (see module docstring / docs/COST_MODEL.md):
        # Graham bound when the critical device's last slot was an
        # unconstrained (global-min) choice, else the trivial spd·max bound.
        crit = int(np.argmax(dev_load))
        max_slot = float(slot_load.max(initial=0.0))
        if last_unconstrained[crit]:
            certified = slot_load.sum() / d + (1.0 - 1.0 / d) * float(last_load[crit])
        else:
            certified = spd * max_slot
    else:
        # Contiguous: identity permutation; certificate is just the makespan.
        pass

    plan = PlacementPlan(
        strategy=strategy,
        n_devices=d,
        p=p,
        n_slots=n_slots,
        cell_loads=loads,
        cell_first_slot=first,
        cell_n_slabs=n_slabs.astype(np.int32),
        slot_cell=slot_cell,
        slot_slab=slot_slab,
        slot_load=slot_load,
        dispatch_of_slot=dispatch,
        certified_bound=0.0,  # patched below (needs the frozen plan's makespan)
    )
    if strategy != "lpt":
        certified = plan.makespan
    # fp guard: the certificate is exact in reals; allow accumulation slack.
    certified = float(max(certified, plan.makespan * (1.0 - 1e-12)))
    return dataclasses.replace(plan, certified_bound=certified)


def slot_exact_counts(
    plan: PlacementPlan, v_cnt: np.ndarray, w_cnt: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Exact per-(source-shard, slot) row counts under the plan.

    ``v_cnt`` / ``w_cnt``: (M, p) exact per-(shard, cell) counts from the
    counting pass. V rows of cell h are dealt to slab j by intra-cell rank
    (``rank % n_slabs``), so shard i's slab j receives
    ``(c + s − 1 − j) // s`` rows with ``c = v_cnt[i, h]`` — the slabs
    partition V exactly (Σ_j = c). W rows replicate into every slab.
    Returned in SLOT order (use ``plan.dispatch_of_slot`` to reorder);
    padding slots count 0. These size the static dispatch capacities.
    """
    v_cnt = np.asarray(v_cnt)
    w_cnt = np.asarray(w_cnt)
    real = plan.slot_cell >= 0
    cell = np.clip(plan.slot_cell, 0, None)
    s = plan.cell_n_slabs[cell].astype(np.int64)  # (n_slots,)
    j = plan.slot_slab.astype(np.int64)
    v_slot = (v_cnt[:, cell].astype(np.int64) + s - 1 - j) // s
    w_slot = w_cnt[:, cell].astype(np.int64)
    v_slot[:, ~real] = 0
    w_slot[:, ~real] = 0
    return v_slot, w_slot


def capacity_saved_bytes(
    plan: PlacementPlan,
    v_cnt: np.ndarray,
    w_cnt: np.ndarray,
    row_bytes: int,
    slack: float = 1.0,
) -> int:
    """Dispatch-buffer bytes the plan saves vs the contiguous global-max
    layout, across the whole mesh.

    The compiled buffers are (n_slots, cap, row) per source shard, per side;
    the contiguous baseline provisions every one of its p slots at the global
    worst-cell capacity, while the plan provisions ``n_slots`` slots at the
    post-split worst-SLOT capacity. Splitting a hot cell shrinks cap_v (the
    hot cell's rows spread over slabs) at the price of extra slots carrying
    replicated W rows — this metric reports the NET effect (negative = the
    plan spends more buffer than it saves; the planner only splits when the
    makespan says it's worth it).
    """
    v_slot, w_slot = slot_exact_counts(plan, v_cnt, w_cnt)
    m = v_cnt.shape[0]

    def cap(c: np.ndarray) -> int:
        return int(np.ceil(max(int(c.max(initial=1)), 1) * slack))

    base = plan.p * (cap(np.asarray(v_cnt)) + cap(np.asarray(w_cnt)))
    new = plan.n_slots * (cap(v_slot) + cap(w_slot))
    return int((base - new) * row_bytes * m)
