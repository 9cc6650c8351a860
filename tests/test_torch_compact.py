"""The port's verify-compact plain version and dispatch against the JAX package.

``ref.compact_mask`` / ``ref.verify_compact`` are held slot by slot against
``repro.kernels.ref`` (both fill the buffer in row-major order, pad with -1
and keep the TRUE count on overflow). ``ops.verify_compact(backend="torch")``
is held against ``repro.kernels.ops.verify_compact(backend="pallas")``,
which off the TPU runs the Pallas kernel in interpret mode: counts and
candidate counts exactly, pairs order-normalised (the Pallas kernel emits
in block order). δ sits mid-way in a gap of the tile's pair distances, so
no pair is within fp reach of it and the comparisons are exact. The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import compact, ops, ref

METRICS = ("l1", "l2", "linf")


def _gap_delta(x, y, metric, q=0.05):
    d = np.sort(np.asarray(jref.pairdist(jnp.asarray(x), jnp.asarray(y), metric)).ravel())
    i = int(q * d.size)
    window = d[max(i - 50, 0) : i + 50]
    g = int(np.argmax(np.diff(window)))
    return float((window[g] + window[g + 1]) / 2)


def _tile(seed, a, b, m, metric, n_pad=5):
    """Clustered rows, ids with ``n_pad`` trailing -1 pads, W cells around
    the verified cell 2, mapped coordinates to 3 anchors."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, m)) * 3
    x = (centers[rng.integers(0, 3, a)] + rng.normal(size=(a, m))).astype(np.float32)
    y = (centers[rng.integers(0, 3, b)] + rng.normal(size=(b, m))).astype(np.float32)
    vids = np.r_[rng.permutation(10 * a)[: a - n_pad], [-1] * n_pad].astype(np.int32)
    wids = np.r_[rng.permutation(10 * a)[: b - n_pad], [-1] * n_pad].astype(np.int32)
    wcells = rng.integers(0, 5, b).astype(np.int32)
    anchors = y[:3]
    px = np.asarray(jref.pairdist(jnp.asarray(x), jnp.asarray(anchors), metric))
    py = np.asarray(jref.pairdist(jnp.asarray(y), jnp.asarray(anchors), metric))
    return x, y, vids, wids, wcells, px, py, _gap_delta(x, y, metric)


def _norm(pairs):
    pairs = np.asarray(pairs)
    pairs = pairs[pairs[:, 0] >= 0]
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("cross", (False, True))
@pytest.mark.parametrize("coords", (False, True))
def test_plain_verify_compact_slot_by_slot(metric, cross, coords):
    x, y, vids, wids, wcells, px, py, delta = _tile(1, 70, 90, 12, metric)
    if not coords:
        px = py = None
    kw = dict(delta=delta, metric=metric, cross=cross, delta_bound=1.5 * delta if coords else None)
    _, full, _ = jref.verify_compact(x, y, vids, wids, wcells, 2, capacity=1, px=px, py=py, **kw)
    full = int(full)
    assert full > 2
    for cap in (full, full // 2, 1):
        wp, wc, wn = jref.verify_compact(x, y, vids, wids, wcells, 2, capacity=cap, px=px, py=py, **kw)
        tx, ty, tv, tw, twc, tpx, tpy = _t(x, y, vids, wids, wcells, px, py)
        gp, gc, gn = ref.verify_compact(tx, ty, tv, tw, twc, 2, capacity=cap, px=tpx, py=tpy, **kw)
        assert gp.dtype == torch.int32 and gp.shape == (cap, 2)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        assert int(gc) == int(wc) == full and int(gn) == int(wn)
        op, oc, on = ops.verify_compact(
            tx, ty, tv, tw, twc, 2, tpx, tpy, capacity=cap, backend="torch", **kw)
        np.testing.assert_array_equal(op.numpy(), np.asarray(wp))
        assert (int(oc), int(on)) == (full, int(wn))


@pytest.mark.parametrize("seed", range(6))
def test_compact_mask_slot_by_slot(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(1, 12, size=2)
    mask = rng.random((a, b)) < rng.random()
    vids = rng.integers(0, 100, a).astype(np.int32)
    wids = rng.integers(0, 100, b).astype(np.int32)
    for cap in (1, 3, int(mask.sum()) or 1, int(mask.sum()) + 4):
        wp, wc = jref.compact_mask(jnp.asarray(mask), jnp.asarray(vids), jnp.asarray(wids), cap)
        gp, gc = ref.compact_mask(*_t(mask, vids, wids), cap)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        assert int(gc) == int(wc) == int(mask.sum())


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("cross", (False, True))
@pytest.mark.parametrize("coords", (False, True))
def test_ops_verify_compact_matches_pallas(metric, cross, coords):
    x, y, vids, wids, wcells, px, py, delta = _tile(2, 128, 192, 32, metric)
    if not coords:
        px = py = None
    kw = dict(delta=delta, metric=metric, cross=cross, capacity=4096)
    wp, wc, wn = jops.verify_compact(
        x, y, vids, wids, wcells, 2, px, py, backend="pallas", **kw)
    gp, gc, gn = ops.verify_compact(*_t(x, y, vids, wids, wcells), 2, *_t(px, py), backend="torch", **kw)
    assert int(gc) == int(wc) > 0 and int(gn) == int(wn)
    np.testing.assert_array_equal(_norm(gp.numpy()), _norm(np.asarray(wp)))
    if coords:
        assert int(gn) < int(((vids >= 0)[:, None] & (wids >= 0)[None]).sum())


@pytest.mark.parametrize("cap", ("full", "overflow", "one"))
def test_ops_overflow_and_capacity_one_match_pallas(cap):
    x, y, vids, wids, wcells, px, py, delta = _tile(3, 37, 101, 9, "l1")
    _, full, _ = ref.verify_compact(*_t(x, y, vids, wids, wcells), 2, delta=delta, metric="l1", capacity=1)
    full = int(full)
    capacity = {"full": full, "overflow": max(full // 3, 2), "one": 1}[cap]
    kw = dict(delta=delta, metric="l1", capacity=capacity)
    wp, wc, wn = jops.verify_compact(x, y, vids, wids, wcells, 2, px, py, backend="pallas", **kw)
    gp, gc, gn = ops.verify_compact(*_t(x, y, vids, wids, wcells), 2, *_t(px, py), backend="torch", **kw)
    assert int(gc) == int(wc) == full and int(gn) == int(wn)
    if cap == "full":  # both buffers exactly full: the same pair set
        np.testing.assert_array_equal(_norm(gp.numpy()), _norm(np.asarray(wp)))
        assert (gp.numpy() >= 0).all()
    else:  # overflow: only the count is a contract; every slot is filled
        assert gp.shape == (capacity, 2) and (gp.numpy() >= 0).all()


def test_dispatch_rules_and_wrapper_checks():
    x, y, vids, wids, wcells, px, py, delta = _tile(4, 20, 30, 6, "l1")
    tx, ty, tv, tw, twc, tpx, tpy = _t(x, y, vids, wids, wcells, px, py)
    kw = dict(delta=delta, metric="l1")
    with pytest.raises(ValueError, match="capacity"):
        ops.verify_compact(tx, ty, tv, tw, twc, 2, capacity=0, **kw)
    with pytest.raises(ValueError, match="unsound"):
        ops.verify_compact(tx, ty, tv, tw, twc, 2, tpx, tpy, capacity=8, delta=delta, metric="cosine")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.verify_compact(tx, ty, tv, tw, twc, 2, capacity=8, backend="cuda", **kw)
    with pytest.raises(ValueError, match="CUDA kernel needs CUDA tensors"):
        compact.verify_compact_cuda(
            tx, ty, tv, tw, twc, 2, None, None, metric="l1", delta=delta, delta_bound=0.0,
            capacity=8, cross=False,
        )
    # The default bound is the reference's prune_delta; an empty tile gives
    # a -1 buffer and zero counts.
    a = ops.verify_compact(tx, ty, tv, tw, twc, 2, tpx, tpy, capacity=64, **kw)
    b = ref.verify_compact(tx, ty, tv, tw, twc, 2, capacity=64, px=tpx, py=tpy,
                           delta_bound=ref.prune_delta(delta, "l1"), **kw)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    p, c, n = ops.verify_compact(tx[:0], ty, tv[:0], tw, twc, 2, capacity=4, **kw)
    assert (p == -1).all() and p.shape == (4, 2) and int(c) == int(n) == 0


def test_compact_launch_choices_follow_the_filtered_kernel():
    """verify_compact_cuda takes its tile and staging path from the same
    host logic as the filtered pairdist kernel (one tile core): rows
    without pivot coordinates stage on the rows' alignment alone."""
    from repro_torch.kernels import pairdist

    assert compact.launch_plan is pairdist.launch_plan
    assert compact.stage_flags is pairdist.stage_flags
    x = torch.zeros((6, 100))
    assert compact.stage_flags(x, x, None, None) == pairdist.VEC_ROWS
    assert compact.stage_flags(x[:, :33].contiguous(), x[:, :33].contiguous(), None, None) == 0
    p = torch.zeros((6, 8))
    assert compact.stage_flags(x, x, p, p) == pairdist.VEC_ROWS | pairdist.VEC_PIVOTS
