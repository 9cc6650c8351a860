"""The port's streaming layer (``insert_batch``, ``join_incremental``)
against the JAX package's and against its own one-shot join.

The same insertion batches go into a reference-built index loaded in both
packages (one control plane, since torch cannot reproduce ``jax.random``
streams): the new pairs and the ``StreamStats`` must be equal (the
engine's counters under the reference's δ-expanded boxes; the port's own
guard-band boxes only add candidates). The port's
``join_incremental`` under one, two and k-way splits must be byte-identical
to the port's own ``join`` over the concatenated rows. δ sits mid-way in a
gap of all pair distances, so no pair is within fp reach of it and pair
sets compare byte for byte; counters compare exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jdist
from repro.core import index as jindex
from repro.core import spjoin as jspjoin
from repro.data.pipeline import StreamSource as JStreamSource
from repro_torch.core import cost_model, index, mapping, partition, spjoin
from repro_torch.core import placement as placement_lib
from repro_torch.data.pipeline import StreamSource

STATS = (
    "n_delta", "n_resident", "n_total", "n_cross_pairs", "n_self_pairs", "n_new_pairs",
    "drift", "replan_threshold", "resample_threshold", "action", "resample_due",
)
VSTATS = ("n_verifications", "n_tiles", "n_cells", "n_hits", "n_pruned", "n_tiles_pruned",
          "n_overflow_retries", "prune", "emit", "bucket_shapes")


def _rows(seed, n, m=4):
    """Perturbed copies of a small base pool (non-degenerate pair sets)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(max(n // 3, 1), m))
    r = base[rng.integers(0, base.shape[0], size=n)]
    return (r + 0.05 * rng.normal(size=r.shape)).astype(np.float32)


def _gap_delta(x, metric, q=0.08):
    d = np.asarray(jdist.pairwise(jnp.asarray(x), jnp.asarray(x), metric))
    d = np.sort(d[np.triu_indices(len(x), 1)])
    i = int(q * d.size)
    window = d[max(i - 60, 0) : i + 60]
    g = int(np.argmax(np.diff(window)))
    return float((window[g] + window[g + 1]) / 2)


def _cfg(mod, metric, delta, **kw):
    return mod.JoinConfig(delta=delta, metric=metric, k=48, p=8, n_dims=3, **kw)


def _split(x, cuts):
    return [x[a:b] for a, b in zip([0, *cuts], [*cuts, x.shape[0]])]


@pytest.mark.parametrize("metric,prune", [("l1", "pivot"), ("l2", "window"), ("linf", "none")])
def test_insert_batches_match_reference(metric, prune, tmp_path, monkeypatch):
    """The port's inserts against the reference's. The port routes and
    tests membership under boxes expanded by the pivot filter's guard band
    (``MetricIndex.query_band``), which only adds candidates: pairs, the
    stream stats, the hits and ``observed_w`` equal the reference's, and
    it verifies at least the reference's candidates. Under the reference's
    own boxes (the band pinned to δ) every engine counter is the
    reference's, bit for bit."""
    full = _rows(1, 90)
    delta = _gap_delta(full, metric)
    ref_idx = jindex.build_index(full[:40], _cfg(jspjoin, metric, delta, backend="numpy", prune=prune))
    path = ref_idx.save(str(tmp_path / "i"))
    theirs = jindex.MetricIndex.load(path)
    batches = _split(full, [40, 55, 70])[1:]
    want = [theirs.insert_batch(b) for b in batches]
    ours = index.MetricIndex.load(path, device="cpu")
    got = [ours.insert_batch(torch.as_tensor(b)) for b in batches]
    with monkeypatch.context() as m:
        m.setattr(index.MetricIndex, "query_band", lambda self, d, batch=None: float(d))
        at_delta = index.MetricIndex.load(path, device="cpu")
        got_delta = [at_delta.insert_batch(torch.as_tensor(b)) for b in batches]
    for (gp, gs), (dp, ds), (wp, ws) in zip(got, got_delta, want):
        assert gp.dtype == np.int64 and gp.tobytes() == wp.tobytes() == dp.tobytes()
        for st in (gs, ds):
            for k in STATS:
                assert getattr(st, k) == getattr(ws, k), k
            assert np.isclose(st.balance_std_before, ws.balance_std_before)
            assert np.isclose(st.balance_std_after, ws.balance_std_after)
        for part in ("cross_verify", "self_verify"):
            for k in VSTATS:
                assert getattr(getattr(ds, part), k) == getattr(getattr(ws, part), k), (part, k)
            assert getattr(gs, part).n_hits == getattr(ws, part).n_hits, part
            assert getattr(gs, part).n_verifications >= getattr(ws, part).n_verifications, part
    assert ours.n_batches == at_delta.n_batches == theirs.n_batches == 3
    assert ours.observed_w.tobytes() == at_delta.observed_w.tobytes() == theirs.observed_w.tobytes()
    truth = spjoin.brute_force_pairs(full, delta, metric, device="cpu")
    assert ours.self_pairs().tobytes() == truth.tobytes()


@pytest.mark.parametrize("metric", ("l1", "l2", "linf", "angular"))
@pytest.mark.parametrize("cuts", ([], [37], [15, 28, 41, 60]), ids=("one", "two", "k-way"))
def test_join_incremental_equals_join(metric, cuts):
    full = _rows(3, 72)
    delta = _gap_delta(full, metric)
    cfg = _cfg(spjoin, metric, delta)
    sess = spjoin.join_incremental(_split(full, cuts), cfg, device="cpu")
    one_shot = spjoin.join(full, cfg, device="cpu").pairs
    assert len(one_shot) > 0 and sess.pairs.dtype == np.int64
    assert sess.pairs.tobytes() == one_shot.tobytes()
    assert sess.stats[0].action == "build" and sess.n_rows == 72
    assert [s.n_delta for s in sess.stats] == [b.shape[0] for b in _split(full, cuts)]


def test_compact_emission_and_window_streams_equal_join():
    full = _rows(4, 64)
    delta = _gap_delta(full, "l1")
    base = spjoin.join(full, _cfg(spjoin, "l1", delta), device="cpu").pairs
    for kw in (dict(emit="compact"), dict(prune="window")):
        cfg = _cfg(spjoin, "l1", delta, **kw)
        assert spjoin.join(full, cfg, device="cpu").pairs.tobytes() == base.tobytes()
        sess = spjoin.join_incremental(_split(full, [30, 47]), cfg, device="cpu")
        assert sess.pairs.tobytes() == base.tobytes()


def test_drift_decision_table_and_load_drift():
    assert placement_lib.drift_action(0.0) == "none"
    assert placement_lib.drift_action(placement_lib.REPLAN_DRIFT) == "replan"
    assert placement_lib.drift_action(placement_lib.RESAMPLE_DRIFT) == "resample"
    assert placement_lib.drift_action(0.3, 0.1, 0.5) == "replan"
    assert placement_lib.drift_action(0.6, 0.1, 0.5) == "resample"
    with pytest.raises(ValueError):
        placement_lib.drift_action(0.2, replan_threshold=0.5, resample_threshold=0.1)
    p = np.array([1.0, 2.0, 3.0])
    assert cost_model.load_drift(p, p) == 0.0 and cost_model.load_drift(p, 10 * p) == 0.0
    assert cost_model.load_drift(np.array([1.0, 0.0]), np.array([0.0, 1.0])) == 1.0


def test_drift_actions_fire_as_the_table_says():
    full = _rows(5, 60)
    delta = _gap_delta(full, "l2")
    cfg = _cfg(spjoin, "l2", delta)
    truth = spjoin.brute_force_pairs(full, delta, "l2", device="cpu")

    quiet = spjoin.IncrementalJoin(cfg, replan_drift=0.999, resample_drift=1.0, device="cpu")
    quiet.insert(full[:40])
    plan_before = quiet.index.placement
    _, st = quiet.insert(full[40:])
    assert st.action == "none" and quiet.index.placement is plan_before
    assert quiet.pairs.tobytes() == truth.tobytes()

    idx = spjoin.join_incremental([full[:40]], cfg, device="cpu").index
    _, st = idx.insert_batch(full[40:], replan_drift=0.0, resample_drift=0.0)
    assert st.action == "replan" and st.resample_due  # no rebuild config
    assert st.balance_std_after <= st.balance_std_before + 1e-9

    resample = spjoin.IncrementalJoin(cfg, replan_drift=0.0, resample_drift=0.0, device="cpu")
    resample.insert(full[:40])
    _, st = resample.insert(full[40:])
    assert st.action == "resample" and not st.resample_due and resample.index.n_batches == 1
    assert resample.pairs.tobytes() == truth.tobytes()
    q = _rows(6, 9)
    want = index.brute_force_query(full, q, delta, "l2", device="cpu")
    assert resample.index.query_batch(q).tobytes() == want.tobytes()


def test_insert_never_reenters_the_build(monkeypatch):
    counts = {"fit": 0, "draw": 0, "anchors": 0, "partition": 0}

    def wrap(key, fn):
        def counted(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(spjoin, "fit_node_stats", wrap("fit", spjoin.fit_node_stats))
    monkeypatch.setattr(spjoin, "draw_pivots", wrap("draw", spjoin.draw_pivots))
    monkeypatch.setattr(mapping, "select_anchors", wrap("anchors", mapping.select_anchors))
    monkeypatch.setattr(partition, "build_partition", wrap("partition", partition.build_partition))
    full = _rows(7, 50)
    delta = _gap_delta(full, "l2")
    sess = spjoin.IncrementalJoin(
        _cfg(spjoin, "l2", delta), replan_drift=1.5, resample_drift=2.0, device="cpu")
    sess.insert(full[:20])
    after_build = dict(counts)
    assert all(v == 1 for v in after_build.values()), after_build
    sess.insert(full[20:35])
    sess.insert(full[35:])
    assert counts == after_build, f"insert_batch re-entered the build: {counts}"
    assert sess.pairs.tobytes() == spjoin.brute_force_pairs(full, delta, "l2", device="cpu").tobytes()


def test_empty_and_malformed_deltas():
    full = _rows(8, 40)
    sess = spjoin.IncrementalJoin(_cfg(spjoin, "l2", 0.3), device="cpu")
    pairs, st = sess.insert(np.zeros((0, 4), np.float32))  # before the build: lazy no-op
    assert pairs.shape == (0, 2) and st.action == "none" and sess.index is None
    sess.insert(full)
    idx = sess.index
    before = (idx.n_rows, idx.placement)
    pairs, st = idx.insert_batch(np.zeros((0, 4), np.float32))
    assert pairs.shape == (0, 2) and pairs.dtype == np.int64 and st.action == "none"
    assert (idx.n_rows, idx.placement) == before and idx.n_batches == 0
    for bad in (np.zeros((3, 9), np.float32), np.zeros(4, np.float32)):
        with pytest.raises(ValueError, match="insert_batch"):
            idx.insert_batch(bad)


@pytest.mark.parametrize("dist", ("normal", "uniform", "clustered"))
def test_stream_source_matches_reference(dist):
    ours, theirs = StreamSource(4, seed=13, dist=dist), JStreamSource(4, seed=13, dist=dist)
    full = ours.prefix(30)
    assert full.tobytes() == theirs.prefix(30).tobytes()
    chopped = np.concatenate([ours.batch(0, 7), ours.batch(7, 13), ours.batch(20, 10)])
    assert chopped.tobytes() == full.tobytes()
    assert ours.batch(5, 0).shape == (0, 4) and ours.prefix(0).shape == (0, 4)
    with pytest.raises(ValueError, match="dist"):
        StreamSource(4, dist="cauchy")
