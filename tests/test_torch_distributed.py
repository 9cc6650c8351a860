"""The port's distributed executor (``repro_torch.core.distributed``) on the
CPU with gloo.

* Stage parity: the stats, counts and verify stages against the JAX
  package's on a 1-device mesh, with the reference's plan injected
  (``convert.join_plan``) and the port in an in-process gloo world of 1.
  Packets and confidences within fp32 tolerance (different special-function
  kernels), counts and verify counters exact. The serve stage against the
  reference's ``DistIndex`` over one index the JAX package built and the
  port loaded: query and insert pairs byte-identical, the same insert stats.
* Joins with 4 gloo ranks (spawned processes, file rendezvous): pairs
  byte-identical to brute force and to the port's single-host ``join`` for
  l1/l2/linf, self and R×S, mask and compact emission, lpt and contiguous
  placement; a forced-overflow compact join; the contract's collective
  counts per stage call; ``DistIndex`` against ``MetricIndex`` on 4 ranks.
* ``DistIndex`` on a world of 1, and the collective budget of each stage,
  read from the contract checker's budgets (the reference's baseline and
  the port's own budget file), not written here.

δ is set in the middle of a gap between neighbouring pair distances, so no
pair lies within fp reach of δ and every path must agree byte for byte.
"""
import datetime
import functools
import importlib.util
import multiprocessing as mp
import os
import pickle
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch.core import distances, distributed, index, spjoin
from repro_torch.core import placement as placement_lib
from repro_torch.core import verify as verify_lib
from repro_torch.data import synthetic

WORLD = 4
SPAWN_TIMEOUT_S = 300  # per rank of the 4-rank world
METRICS = ("l1", "l2", "linf")
JOIN_KW = dict(k=128, p=8, n_dims=4)


def _gap_delta(x, y, metric, q):
    """δ near the q-quantile of pair distances, in the middle of the widest
    gap between neighbouring distances around it."""
    d = np.sort(distances.pairwise(torch.as_tensor(x), torch.as_tensor(y), metric).numpy().ravel())
    i = int(q * d.size)
    window = d[max(i - 100, 0) : i + 100]
    g = int(np.argmax(np.diff(window)))
    return float((window[g] + window[g + 1]) / 2)


@functools.lru_cache(maxsize=None)
def _sets():
    """Self-join set, R×S sets, query and insert rows (numpy, seeded)."""
    x = synthetic.mixture(360, 6, n_clusters=3, spread=3.0, seed=4)
    r, s = synthetic.rs_mixture(240, 280, 6, n_clusters=3, spread=3.0, seed=5)
    rng = np.random.default_rng(6)
    q = x[rng.choice(x.shape[0], 90, replace=False)] + rng.normal(0, 0.3, (90, 6)).astype(np.float32)
    new = x[rng.choice(x.shape[0], 40, replace=False)] + rng.normal(0, 0.3, (40, 6)).astype(np.float32)
    return x, r, s, q.astype(np.float32), new.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _delta(metric, cross):
    x, r, s, _, _ = _sets()
    return _gap_delta(r, s, metric, 0.01) if cross else _gap_delta(x, x, metric, 0.01)


@pytest.fixture
def world1(tmp_path):
    """An in-process gloo world of one rank, destroyed after the test."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rdzv", world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        yield None
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Stage parity against the JAX stages (1-device mesh, plan injected)
# ---------------------------------------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.core import distributed as jd
    from repro.core import verify as jverify

    mesh = jax.make_mesh((1,), ("data",))
    return jax, jnp, jd, jverify, mesh, NamedSharding(mesh, P("data"))


def _reference_plan(x, metric, delta):
    """The reference's JoinPlan from pivots = every 3rd row, and its
    injection into the port."""
    jax, jnp, jd, _, _, _ = _jax()
    plan = jd.build_join_plan(
        jax.random.PRNGKey(0), jnp.asarray(x[::3]), delta=delta, metric=metric, p=8, n_dims=4,
    )
    arrays = [np.asarray(a) for a in (plan.anchors, plan.kernel_lo, plan.kernel_hi,
                                      plan.whole_lo, plan.whole_hi)]
    mine = convert.join_plan(arrays[0], metric, *arrays[1:], delta, plan.p, device="cpu")
    return plan, mine


def test_stats_stage_matches_reference(world1):
    jax, jnp, jd, _, mesh, sh = _jax()
    rng = np.random.default_rng(11)
    x = (rng.gamma(3.0, 0.7, size=(300, 6))).astype(np.float32)
    x[:40] = 0.0  # padding rows: invalid, weight 0
    valid = np.ones(300, np.float32)
    valid[:40] = 0.0
    want = [np.asarray(a) for a in jd.make_stage_stats(mesh, "data", backend="numpy")(
        jax.device_put(jnp.asarray(x), sh), jax.device_put(jnp.asarray(valid), sh))]
    got = [a.numpy() for a in distributed.make_stage_stats(backend="torch")(
        torch.as_tensor(x), torch.as_tensor(valid))]
    assert got[0][0, 0] == want[0][0, 0]  # the same family won
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-6)  # packets (MLE)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-5)  # confidences
    assert got[2].tobytes() == want[2].astype(np.float32).tobytes()  # counts


@pytest.mark.parametrize("fused", (True, False))
def test_counts_stage_matches_reference(world1, fused):
    jax, jnp, jd, _, mesh, sh = _jax()
    x, _, _, _, _ = _sets()
    delta = _delta("l1", False)
    jplan, plan = _reference_plan(x, "l1", delta)
    xj, vj, _, _ = jd._pad_shard_set(jnp.asarray(x), 1, sh)
    want = [np.asarray(a) for a in jd.make_stage_counts(mesh, "data", jplan, "numpy", fused=fused)(xj, vj)]
    xt, vt, _, _ = distributed._pad_shard_set(torch.as_tensor(x), 1, 0)
    got = [a.numpy() for a in distributed.make_stage_counts(plan, backend="torch", fused=fused)(xt, vt)]
    assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)  # member MBBs
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)


FAR = 1e3  # the shift that puts one group of rows far from the origin


def _far_sets(cross, far):
    """The stage-parity sets; with ``far`` some rows shifted by ``FAR`` in
    every feature, so they form a cell far from the origin and the
    join-wide band (which scales with max |x|) is wider than the band of
    the slots near the origin."""
    x, r, s, _, _ = _sets()
    x, r, s = x.copy(), r.copy(), s.copy()
    if far:
        x[:60] += FAR
        r[:40] += FAR
        s[:50] += FAR
    return (r, s) if cross else (x,)


@pytest.mark.parametrize("cross", (False, True))
@pytest.mark.parametrize("strategy", ("contiguous", "lpt"))
def test_verify_stage_matches_reference(world1, cross, strategy):
    _check_verify_stage(cross, strategy, far=False)


@pytest.mark.parametrize("cross", (False, True))
@pytest.mark.parametrize("strategy", ("contiguous", "lpt"))
def test_verify_stage_far_cell_matches_reference(world1, cross, strategy):
    """One cell far from the origin: the join-wide band the executor passes
    is wider than a slot's own, and the stage must filter with it."""
    _check_verify_stage(cross, strategy, far=True)


def _check_verify_stage(cross, strategy, far):
    """The port's verify stage against the JAX stage at the same join-wide
    band: hits, verified, candidates, the pruned counter, overflow, per-slot
    areas and the pairs."""
    jax, jnp, jd, jverify, mesh, sh = _jax()
    arrays = _far_sets(cross, far)
    left = arrays[0]
    delta = _gap_delta(arrays[0], arrays[-1], "l1", 0.01)
    jplan, plan = _reference_plan(left, "l1", delta)
    sets = [jd._pad_shard_set(jnp.asarray(a), 1, sh) for a in arrays]
    v_cnt, w_cnt, _, _ = (np.asarray(a) for a in jd.make_stage_counts(mesh, "data", jplan, "numpy")(
        sets[0][0], sets[0][1]))
    if cross:
        _, w_cnt, _, _ = (np.asarray(a) for a in jd.make_stage_counts(mesh, "data", jplan, "numpy")(
            sets[1][0], sets[1][1]))
    loads = np.random.default_rng(3).uniform(1, 10, size=jplan.p)  # a nontrivial permutation
    pl = placement_lib.plan_placement(loads, 1, strategy=strategy)
    v_slot, w_slot = placement_lib.slot_exact_counts(pl, v_cnt, w_cnt)
    cap_v, cap_w = int(v_slot.max()), int(w_slot.max())
    band = jverify.prune_band(delta, "l1", *(a[0] for a in sets))
    jcfg = jd.VerifyConfig(cap_v=cap_v, cap_w=cap_w, emit_pairs=True, backend="numpy",
                           prune="pivot", delta_bound=band)
    want = jd.make_stage_verify(mesh, "data", jplan, jcfg, cross=cross, pl=pl)(
        *[a for st in sets for a in st[:3]])
    tsets = [distributed._pad_shard_set(torch.as_tensor(a), 1, 0) for a in arrays]

    def stage(delta_bound):
        cfg = distributed.VerifyConfig(cap_v=cap_v, cap_w=cap_w, emit_pairs=True, backend="torch",
                                       prune="pivot", delta_bound=delta_bound)
        return distributed.make_stage_verify(plan, cfg, cross=cross, pl=pl)(
            *[a for st in tsets for a in st[:3]])

    got = stage(band)
    for k in ("hits", "verified", "candidates", "overflow"):
        assert got[k] == int(np.asarray(want[k]).sum()), k
    # The pruned counter: verified pairs the join-wide band filtered out.
    pruned = int(np.asarray(want["verified"]).sum()) - int(np.asarray(want["candidates"]).sum())
    assert got["verified"] - got["candidates"] == pruned > 0
    assert got["per_cell_verified"].tolist() == np.asarray(want["per_cell_verified"]).astype(np.int64).tolist()
    assert 0 < got["candidates"] < got["verified"] and got["hits"] > 0
    masks = np.asarray(want["masks"])
    slot, vi, wi = np.nonzero(masks)
    gi = np.asarray(want["v_ids"]).reshape(masks.shape[0], -1)[slot, vi]
    gj = np.asarray(want["w_ids"]).reshape(masks.shape[0], -1)[slot, wi]
    pr = np.stack([gi, gj], 1) if cross else np.sort(np.stack([gi, gj], 1), axis=1)
    assert np.unique(got["pairs"], axis=0).tobytes() == np.unique(pr.astype(np.int64), axis=0).tobytes()
    if far:  # the data separates the bands: each slot's own band admits fewer
        own = stage(None)
        assert own["candidates"] < got["candidates"] and own["hits"] == got["hits"]


# ---------------------------------------------------------------------------
# Collective budgets, one stage call each (world of 1)
# ---------------------------------------------------------------------------


def _budgets():
    """The contract checker's budgets (``tools/spjoin_lint_torch/budgets.py``:
    the reference's ``contracts_baseline.json`` mapped onto the port's
    counted names, and the port's own ``port_budgets.json``), loaded by
    file location: it imports nothing of its package."""
    path = Path(__file__).resolve().parents[1] / "tools" / "spjoin_lint_torch" / "budgets.py"
    spec = importlib.util.spec_from_file_location("spjoin_lint_torch_budgets", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stage_collective_budgets(world1):
    x, r, s, q, _ = _sets()
    delta = _delta("l1", False)
    _, plan = _reference_plan(x, "l1", delta)
    xt, vt, it, _ = distributed._pad_shard_set(torch.as_tensor(x), 1, 0)
    rt_ = distributed._pad_shard_set(torch.as_tensor(r), 1, 0)[:3]
    st_ = distributed._pad_shard_set(torch.as_tensor(s), 1, 0)[:3]
    calls = {
        "stats": lambda: distributed.make_stage_stats(backend="torch")(xt, vt),
        "counts": lambda: distributed.make_stage_counts(plan, backend="torch")(xt, vt),
        "verify": lambda: distributed.make_stage_verify(
            plan, distributed.VerifyConfig(cap_v=len(x), cap_w=len(x), prune="pivot"))(xt, vt, it),
        "verify R×S": lambda: distributed.make_stage_verify(
            plan, distributed.VerifyConfig(cap_v=len(r), cap_w=len(s), prune="pivot"), cross=True,
        )(*rt_, *st_),
    }
    budgets = _budgets()
    want = {"stats": budgets.stage_budget("stage_stats"), "counts": budgets.stage_budget("stage_counts"),
            "verify": budgets.stage_budget("stage_verify"), "verify R×S": budgets.stage_budget("stage_verify_cross")}
    for name, call in calls.items():
        distributed.reset_collective_counts()
        call()
        assert distributed.collective_counts() == want[name], name
    idx = index.build_index(x, spjoin.JoinConfig(delta=delta, metric="l1", **JOIN_KW), device="cpu")
    didx = idx.to_distributed()
    distributed.reset_collective_counts()
    didx.query_batch(q)
    assert distributed.collective_counts() == {**budgets.stage_budget("stage_serve"),
                                               **budgets.port_budget("DistIndex.query_batch")}


# ---------------------------------------------------------------------------
# DistIndex on a world of 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_dist_index_world_of_one(world1, metric):
    x, _, _, q, new = _sets()
    delta = _delta(metric, False)
    cfg = spjoin.JoinConfig(delta=delta, metric=metric, **JOIN_KW)
    host = index.build_index(x, cfg, device="cpu")
    mine = index.build_index(x, cfg, device="cpu").to_distributed()
    assert isinstance(mine, distributed.DistIndex) and mine.n_devices == 1
    want = host.query_batch(q)
    assert len(want) > 0 and mine.query_batch(q).tobytes() == want.tobytes()
    assert mine.query_batch(q, delta * 1.3).tobytes() == host.query_batch(q, delta * 1.3).tobytes()
    got_ins, st = mine.insert_batch(new)
    want_ins, st_host = host.insert_batch(new)
    assert got_ins.tobytes() == want_ins.tobytes() and st.action == st_host.action
    assert mine.query_batch(q).tobytes() == host.query_batch(q).tobytes()


@pytest.mark.parametrize("prune", ("pivot", "none"))
def test_serve_stage_matches_reference(world1, tmp_path, prune):
    """The serve stage against the reference's DistIndex on a 1-device mesh:
    one index built by the JAX package, saved, and loaded into the port;
    query batches, an insert and the grown index answer identically."""
    jax, jnp, jd, _, mesh, _ = _jax()
    from repro.core import index as jindex
    from repro.core import spjoin as jspjoin

    x, _, _, q, new = _sets()
    delta = _delta("l1", False)
    ref = jindex.build_index(x, jspjoin.JoinConfig(delta=delta, metric="l1", backend="numpy",
                                                   prune=prune, **JOIN_KW))
    mine = index.MetricIndex.load(ref.save(str(tmp_path / "ref")), device="cpu").to_distributed()
    theirs = ref.to_distributed(mesh)
    assert mine.prune == theirs.prune == prune
    for d in (delta, delta * 1.3):
        want = theirs.query_batch(q, d)
        assert len(want) > 0 and mine.query_batch(q, d).tobytes() == want.tobytes()
    got_ins, st = mine.insert_batch(new)
    want_ins, st_ref = theirs.insert_batch(new)
    assert len(want_ins) > 0 and got_ins.tobytes() == want_ins.tobytes()
    assert (st.action, st.n_new_pairs, st.n_cross_pairs) == (
        st_ref.action, st_ref.n_new_pairs, st_ref.n_cross_pairs)
    assert mine.query_batch(q).tobytes() == theirs.query_batch(q).tobytes()


def test_dist_index_rejects_kernel_less_metrics(world1):
    x, _, _, _, _ = _sets()
    idx = index.build_index(np.abs(x), spjoin.JoinConfig(delta=0.1, metric="angular", **JOIN_KW),
                            device="cpu")
    with pytest.raises(ValueError, match="metric"):
        idx.to_distributed()


def test_join_rejects_window_and_kernel_less_metrics(world1):
    x, _, _, _, _ = _sets()
    with pytest.raises(ValueError, match="prune"):
        distributed.distributed_join(x, delta=1.0, prune="window", device="cpu")
    with pytest.raises(ValueError, match="kernel metrics"):
        distributed.distributed_join(x, delta=1.0, metric="angular", device="cpu")


def test_join_defaults_to_the_card(world1, monkeypatch):
    x, _, _, _, _ = _sets()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.distributed_join(x, delta=1.0)


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------


def _join_jobs():
    jobs = []
    for metric in METRICS:
        for cross in (False, True):
            for emit in ("mask", "compact"):
                for strategy in ("lpt", "contiguous"):
                    jobs.append(("join", (metric, cross, emit, strategy)))
    jobs.append(("join", ("l1", False, "mask", "lpt", "random")))
    jobs.append(("overflow", ("l1", False, "compact", "lpt")))
    jobs.append(("overflow", ("l2", True, "compact", "lpt")))
    for metric in METRICS:
        jobs.append(("serve", (metric,)))
    return jobs


def _run_join(key, deltas, force_overflow=False):
    metric, cross, emit, strategy, *rest = key
    x, r, s, _, _ = _sets()
    data, other = (r, s) if cross else (x, None)
    kw = dict(delta=deltas[(metric, cross)], metric=metric, emit_pairs=True, emit=emit,
              placement=strategy, device="cpu", s=other, sampler=rest[0] if rest else "generative",
              **JOIN_KW)
    knobs = {k: getattr(verify_lib, k) for k in
             ("DEFAULT_EMIT_RATE", "EMIT_SLACK", "_EMIT_FLOOR", "_estimate_emit_rate")}
    if force_overflow:
        verify_lib.DEFAULT_EMIT_RATE = verify_lib.EMIT_SLACK = 1e-9
        verify_lib._EMIT_FLOOR = 1
        verify_lib._estimate_emit_rate = lambda *a, **k: 1e-9
    try:
        distributed.reset_collective_counts()
        res = distributed.distributed_join(data, **kw)
    finally:
        for k, v in knobs.items():
            setattr(verify_lib, k, v)
    return dict(
        pairs=res.pairs, hits=res.n_hits, verified=res.n_verifications,
        per_cell=res.per_cell_verified.astype(np.int64), loads=res.device_loads,
        candidates=res.n_candidates, overflow=res.overflow, retries=res.n_overflow_retries,
        emit=res.emit, collectives=distributed.collective_counts(),
        split_cells=res.placement_plan.n_split_cells,
    )


def _run_serve(key, deltas):
    (metric,) = key
    x, _, _, q, new = _sets()
    cfg = spjoin.JoinConfig(delta=deltas[(metric, False)], metric=metric, **JOIN_KW)
    host = index.build_index(x, cfg, device="cpu", n_devices=2)  # re-planned for 4 ranks
    didx = index.build_index(x, cfg, device="cpu", n_devices=2).to_distributed()
    distributed.reset_collective_counts()
    got = didx.query_batch(q)
    serve_counts = distributed.collective_counts()
    got_ins, _ = didx.insert_batch(new)
    want_ins, _ = host.insert_batch(new)
    return dict(
        query=got, insert=got_ins, want_insert=want_ins, after=didx.query_batch(q),
        want_after=host.query_batch(q), collectives=serve_counts,
        n_slots=didx.pl.n_slots, n_devices=didx.pl.n_devices,
    )


def _rank_main(rank, world, init_file, out_dir, jobs, deltas):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT_S),
        )
        try:
            out = {}
            for kind, key in jobs:
                if kind == "serve":
                    out[(kind, key)] = _run_serve(key, deltas)
                else:
                    out[(kind, key)] = _run_join(key, deltas, force_overflow=kind == "overflow")
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Run every 4-rank job in one spawned gloo world; per-rank results."""
    tmp = tmp_path_factory.mktemp("world4")
    jobs = _join_jobs()
    deltas = {(m, c): _delta(m, c) for m in METRICS for c in (False, True)}
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main, args=(r, WORLD, str(tmp / "rdzv"), str(tmp), jobs, deltas))
        for r in range(WORLD)
    ]
    for pr in procs:
        pr.start()
    try:
        for pr in procs:
            pr.join(SPAWN_TIMEOUT_S)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join(10)
    errors = [(tmp / f"rank{r}.err") for r in range(WORLD)]
    msg = "\n".join(e.read_text() for e in errors if e.exists())
    assert all(pr.exitcode == 0 for pr in procs), f"exit codes {[pr.exitcode for pr in procs]}\n{msg}"
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


JOIN_KEYS = [key for kind, key in _join_jobs() if kind == "join"]


@pytest.mark.parametrize("key", JOIN_KEYS, ids=lambda k: "-".join(str(v) for v in k))
def test_four_rank_join_exact(four_ranks, key):
    metric, cross, *_ = key
    x, r, s, _, _ = _sets()
    data, other = (r, s) if cross else (x, None)
    delta = _delta(metric, cross)
    res = four_ranks[0][("join", key)]
    for rank in range(1, WORLD):  # every rank returns the same result
        assert four_ranks[rank][("join", key)]["pairs"].tobytes() == res["pairs"].tobytes()
    truth = spjoin.brute_force_pairs(data, delta, metric, s=other, device="cpu")
    single = spjoin.join(data, spjoin.JoinConfig(delta=delta, metric=metric, **JOIN_KW),
                         s=other, device="cpu")
    assert len(truth) > 0 and res["pairs"].dtype == np.int64
    assert res["pairs"].tobytes() == truth.tobytes() == single.pairs.tobytes()
    assert res["hits"] == len(truth) and res["overflow"] == 0 and res["retries"] == 0
    assert res["verified"] == int(res["per_cell"].sum()) == int(res["loads"].sum())
    assert 0 < res["candidates"] <= res["verified"]
    if key[3] == "contiguous":
        assert res["split_cells"] == 0
    n_sets = 2 if cross else 1
    assert res["collectives"] == {
        "stats.all_gather": 3 * n_sets, "counts.all_gather": 4 * 2,
        "verify.all_to_all": 6, "result.all_gather": 2,
    }


def test_four_rank_lpt_splits_heavy_cells(four_ranks):
    """The LPT joins exercise heavy-cell slabs (V rows dealt over slabs, W
    replicated) somewhere in the sweep."""
    split = [four_ranks[0][("join", k)]["split_cells"] for k in JOIN_KEYS if k[3] == "lpt"]
    assert max(split) > 0, split


@pytest.mark.parametrize(
    "key", [("l1", False, "compact", "lpt"), ("l2", True, "compact", "lpt")], ids=("l1-self", "l2-RxS")
)
def test_four_rank_forced_overflow(four_ranks, key):
    res = four_ranks[0][("overflow", key)]
    plain = four_ranks[0][("join", key)]
    assert res["retries"] > 0 and res["emit"] == "compact"
    assert res["pairs"].tobytes() == plain["pairs"].tobytes() and len(res["pairs"]) > 0


@pytest.mark.parametrize("metric", METRICS)
def test_four_rank_dist_index(four_ranks, metric):
    x, _, _, q, _ = _sets()
    delta = _delta(metric, False)
    res = four_ranks[0][("serve", (metric,))]
    truth = index.brute_force_query(x, q, delta, metric, device="cpu")
    host = index.build_index(x, spjoin.JoinConfig(delta=delta, metric=metric, **JOIN_KW),
                             device="cpu", n_devices=2)
    assert len(truth) > 0 and res["query"].tobytes() == host.query_batch(q).tobytes() == truth.tobytes()
    assert res["insert"].tobytes() == res["want_insert"].tobytes()
    assert res["after"].tobytes() == res["want_after"].tobytes()
    assert res["n_devices"] == WORLD and res["n_slots"] % WORLD == 0
    assert res["collectives"] == {"serve.all_to_all": 3, "result.all_gather": 2}
    for rank in range(1, WORLD):
        assert four_ranks[rank][("serve", (metric,))]["query"].tobytes() == res["query"].tobytes()
