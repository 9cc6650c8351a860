"""The port's streaming verify engine against the JAX package's.

Both engines get the same cells, membership and mapped coordinates (the
reference's, carried over as numpy arrays), so the port must return
byte-identical pairs and equal ``VerifyStats`` counters — the tile
schedule, the windows, the bounding-box skips and the candidate pre-pass
are the reference's decisions. The thresholds are chosen in the middle of a
gap between pair distances, so no pair is within fp reach of δ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as jmap
from repro.core import partition as jpart
from repro.core import verify as jver
from repro_torch.core import verify
from repro_torch.data import synthetic

COUNTERS = (
    "n_verifications", "n_padded", "n_dispatched", "n_tiles", "n_cells", "n_hits",
    "n_pruned", "n_tiles_pruned", "n_overflow_retries", "prune", "emit", "bucket_shapes",
)


def _gap_delta(x, y, metric, q):
    """A δ near quantile q of the pair distances, mid-way in a gap of them."""
    from repro.core import distances as jdist

    d = np.sort(np.asarray(jdist.pairwise(jnp.asarray(x), jnp.asarray(y), metric)).ravel())
    i = int(q * d.size)
    window = d[max(i - 200, 0) : i + 200]
    g = int(np.argmax(np.diff(window)))
    return float((window[g] + window[g + 1]) / 2)


def _setup(metric, cross, seed=0):
    if cross:
        r, s = synthetic.rs_mixture(300, 420, 12, n_clusters=4, spread=3.0, seed=seed)
    else:
        r = synthetic.mixture(500, 12, n_clusters=4, spread=3.0, seed=seed)
        s = None
    w = r if s is None else s
    delta = _gap_delta(r, w, metric, 0.01)
    rng = np.random.default_rng(seed)
    anchors = r[rng.choice(len(r), 4, replace=False)]
    smap = jmap.SpaceMap(jnp.asarray(anchors), metric)
    xr = np.array(smap(jnp.asarray(r)))
    xw = np.array(smap(jnp.asarray(w)))
    plan = jpart.build_partition(xr[::5], 6, delta, strategy="iterative", seed=seed)
    cells = np.asarray(jpart.assign_kernel(plan, jnp.asarray(xr)))
    plan = jpart.tighten(plan, jnp.asarray(xr), jnp.asarray(cells))
    member = np.asarray(jpart.whole_membership(plan, jnp.asarray(xw)))
    return r, s, cells, member, xr, (None if s is None else xw), delta


@pytest.mark.parametrize("metric", ("l1", "l2", "linf", "angular"))
@pytest.mark.parametrize("prune", ("pivot", "none"))
@pytest.mark.parametrize("cross", (False, True))
def test_verify_pairs_identical_to_reference(metric, prune, cross):
    r, s, cells, member, xr, xs, delta = _setup(metric, cross)
    kw = dict(tile_v=64, tile_w=96, prune=prune)
    want, wstats = jver.verify_pairs(
        r, cells, member, delta, metric, config=jver.EngineConfig(backend="numpy", **kw),
        data_w=s, coords=xr, coords_w=xs,
    )
    got, gstats = verify.verify_pairs(
        torch.as_tensor(r), cells, member, delta, metric,
        config=verify.EngineConfig(backend="auto", **kw),
        data_w=None if s is None else torch.as_tensor(s),
        coords=torch.as_tensor(xr), coords_w=None if xs is None else torch.as_tensor(xs),
    )
    assert got.dtype == np.int64 and want.dtype == np.int64
    assert got.tobytes() == want.tobytes() and len(got) > 0
    for k in COUNTERS:
        assert getattr(gstats, k) == getattr(wstats, k), k
    if prune == "pivot" and metric != "angular":
        assert gstats.n_pruned > 0


def test_prune_pivot_equals_none_and_default_tiles():
    r, _, cells, member, xr, _, delta = _setup("l1", False, seed=3)
    base, _ = verify.verify_pairs(torch.as_tensor(r), cells, member, delta, "l1")
    pruned, st = verify.verify_pairs(
        torch.as_tensor(r), cells, member, delta, "l1",
        config=verify.EngineConfig(prune="pivot"), coords=torch.as_tensor(xr),
    )
    assert base.tobytes() == pruned.tobytes() and st.prune == "pivot"


@pytest.mark.parametrize("cross", (False, True))
@pytest.mark.parametrize("prune", ("pivot", "none"))
def test_tile_hits_and_dedup_match_reference_verify_tile(cross, prune):
    rng = np.random.default_rng(2)
    xv = rng.normal(size=(40, 9)).astype(np.float32)
    xw = rng.normal(size=(56, 9)).astype(np.float32)
    pv = rng.normal(size=(40, 3)).astype(np.float32)
    pw = rng.normal(size=(56, 3)).astype(np.float32)
    vids = np.r_[rng.permutation(100)[:36], [-1] * 4].astype(np.int64)
    wids = np.r_[rng.permutation(100)[:50], [-1] * 6].astype(np.int64)
    wcells = rng.integers(0, 4, size=56).astype(np.int64)
    delta = _gap_delta(xv, xw, "l1", 0.3)
    kw = dict(delta=delta, metric="l1", cross=cross, prune=prune)
    if prune == "pivot":
        kw["delta_bound"] = 4.0
    want = np.asarray(jver.verify_tile(
        xv, xw, vids, wids, wcells, 2, backend="numpy",
        pv=pv if prune == "pivot" else None, pw=pw if prune == "pivot" else None, **kw,
    ))
    t = torch.as_tensor
    cross = kw.pop("cross")
    hits = verify.tile_hits(
        t(xv), t(xw), backend="torch",
        pv=t(pv) if prune == "pivot" else None, pw=t(pw) if prune == "pivot" else None, **kw,
    )
    got = verify.apply_dedup(hits, t(vids), t(wids), t(wcells), 2, cross=cross).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()


def test_bucket_size_matches_reference():
    for cap in (8, 1024, 4096):
        for n in (1, 7, 8, 9, 33, 100, 513, 1000, 4095, 5000):
            assert verify.bucket_size(n, cap) == jver.bucket_size(n, cap)


def test_unported_modes_raise_and_capabilities_resolve():
    """The capability rules: an unsound metric resolves pruning to "none",
    a metric without a kernel resolves compact emission to "mask" and the
    plain backend; pivot pruning without coordinates and unknown modes
    raise."""
    assert verify.resolve_prune("pivot", "cosine", True) == "none"
    assert verify.resolve_prune("window", "cosine", True) == "none"
    assert verify.resolve_emit("compact", "angular") == "mask"
    with pytest.raises(ValueError, match="requires the mapped coordinates"):
        verify.resolve_prune("pivot", "l1", False)
    with pytest.raises(ValueError, match="unknown prune mode"):
        verify.resolve_prune("bogus", "l1", True)
    with pytest.raises(ValueError, match="unknown emit mode"):
        verify.resolve_emit("bogus", "l1")
    x = torch.zeros((2, 3))
    assert verify.resolve_engine_backend("cuda", "angular", x) == "torch"


def test_prune_emit_modes_resolve_and_run():
    """``prune="window"`` and ``emit="compact"`` resolve to themselves on a
    true metric and return the default engine's pairs."""
    assert verify.resolve_prune("window", "l1", True) == "window"
    assert verify.resolve_emit("compact", "l2") == "compact"
    r, _, cells, member, xr, _, delta = _setup("l1", False, seed=1)
    base, _ = verify.verify_pairs(torch.as_tensor(r), cells, member, delta, "l1")
    for prune, emit in (("window", "mask"), ("pivot", "compact")):
        got, st = verify.verify_pairs(
            torch.as_tensor(r), cells, member, delta, "l1",
            config=verify.EngineConfig(prune=prune, emit=emit), coords=torch.as_tensor(xr),
        )
        assert got.tobytes() == base.tobytes() and (st.prune, st.emit) == (prune, emit)


def test_prune_band_matches_reference():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=(30, 7)) * 50).astype(np.float32)
    b = (rng.normal(size=(20, 7)) * 80).astype(np.float32)
    for metric in ("l1", "l2"):
        want = jver.prune_band(0.5, metric, jnp.asarray(a), jnp.asarray(b))
        assert verify.prune_band(0.5, metric, torch.as_tensor(a), torch.as_tensor(b)) == want


@pytest.mark.parametrize("emit", ("mask", "compact"))
def test_explicit_delta_bound_sets_the_filter(emit):
    """A band the caller passes (the distributed executor's join-wide one)
    is the pivot filter's threshold: ``n_pruned`` is the count of that
    band's pruned pairs, Σ_h |{(v, w) ∈ V_h × W_h : max |xv − xw| > band}|
    over the mapped coordinates, and None means the band of these rows."""
    r, _, cells, member, xr, _, delta = _setup("l1", False)
    order = np.argsort(cells, kind="stable")
    bounds = np.searchsorted(cells[order], np.arange(member.shape[1] + 1))
    v_lists = [order[bounds[h] : bounds[h + 1]] for h in range(member.shape[1])]
    w_lists = [np.flatnonzero(member[:, h]) for h in range(member.shape[1])]
    rows = torch.as_tensor(r)
    cfg = verify.EngineConfig(tile_v=64, tile_w=96, prune="pivot", emit=emit)
    got = {}
    for band in (None, 0.5, 50.0):
        pairs, st = verify.verify_cell_lists(
            rows, cells, v_lists, w_lists, delta, "l1", config=cfg,
            coords=torch.as_tensor(xr), delta_bound=band,
        )
        b = verify.prune_band(delta, "l1", rows) if band is None else band
        want = sum(
            int((np.abs(xr[v][:, None] - xr[w][None]).max(-1) > b).sum())
            for v, w in zip(v_lists, w_lists)
        )
        assert st.n_pruned == want, (band, st.n_pruned, want)
        got[band] = (pairs, st.n_pruned)
    assert len({n for _, n in got.values()}) == 3, got
    assert 0.5 < delta < verify.prune_band(delta, "l1", rows) < 50.0
    # A wider band admits more candidates and the same pairs; a band below
    # δ loses pairs (the filter is then unsound), never adds one.
    assert got[50.0][0].tobytes() == got[None][0].tobytes()
    kept = {tuple(p) for p in got[None][0].tolist()}
    assert {tuple(p) for p in got[0.5][0].tolist()} < kept


def test_empty_cells_and_no_hits():
    x = torch.zeros((0, 4))
    pairs, st = verify.verify_pairs(x, np.zeros(0, np.int64), np.zeros((0, 3), bool), 1.0, "l1")
    assert pairs.shape == (0, 2) and st.n_cells == 0


# ---------------------------------------------------------------------------
# Compact emission and window pruning against the reference engine
# ---------------------------------------------------------------------------

# The buffered compact path on every prunable metric; the host-only window
# mode and the lowered compact modes on l1 and l2.
CASES = [("pivot", "compact", m) for m in ("l1", "l2", "linf")] + [
    (prune, emit, m)
    for prune, emit in (("window", "mask"), ("window", "compact"), ("none", "compact"))
    for m in ("l1", "l2")
]


def _both(r, s, cells, member, xr, xs, delta, metric, **kw):
    want = jver.verify_pairs(
        r, cells, member, delta, metric, config=jver.EngineConfig(backend="numpy", **kw),
        data_w=s, coords=xr, coords_w=xs,
    )
    got = verify.verify_pairs(
        torch.as_tensor(r), cells, member, delta, metric,
        config=verify.EngineConfig(backend="auto", **kw),
        data_w=None if s is None else torch.as_tensor(s),
        coords=torch.as_tensor(xr), coords_w=None if xs is None else torch.as_tensor(xs),
    )
    return got, want


def _assert_same(got, want):
    (gp, gs), (wp, ws) = got, want
    assert gp.dtype == np.int64 and gp.tobytes() == wp.tobytes() and len(gp) > 0
    for k in COUNTERS:
        assert getattr(gs, k) == getattr(ws, k), k


@pytest.mark.parametrize("prune,emit,metric", CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("cross", (False, True))
def test_compact_and_window_identical_to_reference(prune, emit, metric, cross):
    r, s, cells, member, xr, xs, delta = _setup(metric, cross)
    got, want = _both(r, s, cells, member, xr, xs, delta, metric,
                      tile_v=64, tile_w=96, prune=prune, emit=emit)
    _assert_same(got, want)
    assert (got[1].prune, got[1].emit) == (prune, emit)
    if prune != "none":
        assert got[1].n_pruned > 0


def test_window_angular_and_early_flushes_match_reference(monkeypatch):
    """The batched window dispatch with flushes forced every few tiles, and
    a metric without a kernel (angular: compact resolves back to mask)."""
    monkeypatch.setattr(jver, "_BATCH_FLUSH_AREA", 20_000)
    monkeypatch.setattr(verify, "_BATCH_FLUSH_AREA", 20_000)
    for metric, emit in (("l1", "mask"), ("angular", "compact")):
        r, s, cells, member, xr, xs, delta = _setup(metric, False, seed=4)
        got, want = _both(r, s, cells, member, xr, xs, delta, metric,
                          tile_v=32, tile_w=48, prune="window", emit=emit)
        _assert_same(got, want)


def _force_undercapacity(monkeypatch, *mods):
    """Shrink the capacity prior so the first bucket always overflows (the
    reference suite's knobs, set alike in both engines)."""
    for mod in mods:
        monkeypatch.setattr(mod, "DEFAULT_EMIT_RATE", 1e-9)
        monkeypatch.setattr(mod, "EMIT_SLACK", 1e-9)
        monkeypatch.setattr(mod, "_EMIT_FLOOR", 1)
        monkeypatch.setattr(mod, "_estimate_emit_rate", lambda *a, **k: 1e-9)


@pytest.mark.parametrize("metric,retries", [("l1", 3), ("l2", 0)], ids=("retry", "mask-fallback"))
def test_overflow_ladder_matches_reference(metric, retries, monkeypatch):
    r, _, cells, member, xr, _, delta = _setup(metric, False, seed=2)
    base = verify.verify_pairs(
        torch.as_tensor(r), cells, member, delta, metric,
        config=verify.EngineConfig(tile_v=64, tile_w=96, prune="pivot"),
        coords=torch.as_tensor(xr),
    )
    _force_undercapacity(monkeypatch, jver, verify)
    monkeypatch.setattr(jver, "_MAX_OVERFLOW_RETRIES", retries)
    monkeypatch.setattr(verify, "_MAX_OVERFLOW_RETRIES", retries)
    got, want = _both(r, None, cells, member, xr, None, delta, metric,
                      tile_v=64, tile_w=96, prune="pivot", emit="compact")
    _assert_same(got, want)
    assert got[1].n_overflow_retries >= 1
    assert got[0].tobytes() == base[0].tobytes() and got[1].n_pruned == base[1].n_pruned


def test_compact_capacity_prior_matches_reference():
    _, _, _, _, xr, _, _ = _setup("l1", False)
    for d in (0.1, 1.0, 5.0):
        assert verify._estimate_emit_rate(torch.as_tensor(xr), d) == jver._estimate_emit_rate(xr, d)


def test_verify_resident_matches_reference():
    r, s, cells, member, xr, xs, delta = _setup("l2", True, seed=6)
    p = member.shape[1]
    order = np.argsort(cells, kind="stable")
    bounds = np.searchsorted(cells[order], np.arange(p + 1))
    v_lists = [order[bounds[h] : bounds[h + 1]] for h in range(p)]
    want, ws = jver.verify_resident(
        r, cells, v_lists, member, delta, "l2",
        config=jver.EngineConfig(backend="numpy", prune="pivot"), data_w=s, coords=xr, coords_w=xs,
    )
    got, gs = verify.verify_resident(
        torch.as_tensor(r), torch.from_numpy(np.array(cells)), v_lists, torch.from_numpy(np.array(member)), delta, "l2",
        config=verify.EngineConfig(prune="pivot"), data_w=torch.as_tensor(s),
        coords=torch.as_tensor(xr), coords_w=torch.as_tensor(xs),
    )
    _assert_same((got, gs), (want, ws))


@pytest.mark.parametrize("metric", ("l1", "l2", "angular"))
def test_reference_verify_matches_reference(metric):
    """The seed's dense per-cell loop, port against reference: the same
    pairs and verification count, and the engine's pairs."""
    r, _, cells, member, xr, _, delta = _setup(metric, False, seed=1)
    got, n_got = verify.reference_verify(torch.as_tensor(r), cells, member, delta, metric)
    want, n_want = jver.reference_verify(r, cells, member, delta, metric)
    assert got.dtype == np.int64 and got.tobytes() == want.tobytes() and len(got) > 0
    assert n_got == n_want
    engine, st = verify.verify_pairs(torch.as_tensor(r), cells, member, delta, metric)
    assert engine.tobytes() == got.tobytes() and st.n_verifications == n_got
    empty, n_empty = verify.reference_verify(r, cells, member, delta, metric, return_pairs=False)
    assert empty.shape == (0, 2) and n_empty == n_got


@pytest.mark.parametrize("cross", (False, True))
@pytest.mark.parametrize("prune", ("pivot", "none"))
def test_verify_tile_wrappers_match_reference(cross, prune):
    """``pair_validity``, ``candidate_mask`` and ``verify_tile`` with the
    reference's signatures ("torch" for the reference's "numpy")."""
    rng = np.random.default_rng(5)
    xv = rng.normal(size=(40, 9)).astype(np.float32)
    xw = rng.normal(size=(56, 9)).astype(np.float32)
    pv = rng.normal(size=(40, 3)).astype(np.float32)
    pw = rng.normal(size=(56, 3)).astype(np.float32)
    vids = np.r_[rng.permutation(100)[:36], [-1] * 4].astype(np.int64)
    wids = np.r_[rng.permutation(100)[:50], [-1] * 6].astype(np.int64)
    wcells = rng.integers(0, 4, size=56).astype(np.int64)
    delta = _gap_delta(xv, xw, "l1", 0.3)
    t = torch.as_tensor
    np.testing.assert_array_equal(
        verify.pair_validity(t(vids), t(wids)).numpy(), np.asarray(jver.pair_validity(vids, wids))
    )
    cand = verify.candidate_mask(t(pv), t(pw), t(vids), t(wids), delta, 2.5).numpy()
    np.testing.assert_array_equal(cand, np.asarray(jver.candidate_mask(pv, pw, vids, wids, delta, 2.5)))
    assert 0 < cand.sum() < cand.size
    kw = dict(delta=delta, metric="l1", cross=cross, prune=prune)
    coords = dict(pv=pv, pw=pw, delta_bound=4.0) if prune == "pivot" else {}
    want = np.asarray(jver.verify_tile(xv, xw, vids, wids, wcells, 1, backend="numpy", **kw, **coords))
    got = verify.verify_tile(
        t(xv), t(xw), t(vids), t(wids), t(wcells), 1, backend="torch", **kw,
        **{k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in coords.items()},
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()
