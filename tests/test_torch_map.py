"""The port's map phase against the JAX package's, on the same control plane.

The reference's pivots, anchors and ``PartitionPlan`` are carried into the
port with ``repro_torch.convert`` (torch cannot reproduce ``jax.random``
streams, so this is how both packages compute from the same plan). Then
the port's mapping, partition tree, assignment, membership and tightening
must give the reference's outputs: boxes and labels exactly, coordinates
within fp32 tolerance, and cells/membership exactly on every row not within
1e-5 of a box edge (exactly everywhere when fed the same coordinates).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jdist
from repro.core import mapping as jmap
from repro.core import partition as jpart
from repro.core import spjoin as jspjoin
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import distances, mapping, partition
from repro_torch.data import synthetic
from repro_torch.kernels import ops


def _reference_plan(metric, p=12, n_dims=5, delta=0.8, strategy="learning"):
    data = synthetic.mixture(600, 10, n_clusters=5, spread=3.0, seed=9)
    cfg = jspjoin.JoinConfig(
        delta=delta, metric=metric, k=128, p=p, n_dims=n_dims, partitioner=strategy,
        backend="numpy",
    )
    key = jax.random.PRNGKey(0)
    shards = jspjoin._as_shards(data, 3)
    stats = jspjoin.fit_node_stats(shards, cfg.t_cells)
    pivots = jspjoin.draw_pivots(key, shards, stats, cfg)
    plan, smap = jspjoin.build_plan(key, pivots, cfg)
    return data, np.asarray(pivots), plan, smap, cfg


def _plan(plan):
    return convert.partition_plan(
        plan.kernel_lo, plan.kernel_hi, plan.whole_lo, plan.whole_hi, plan.delta, device="cpu"
    )


def _near_edge(xm, plan, tol=1e-5):
    near = np.zeros(len(xm), bool)
    for edge in (plan.kernel_lo, plan.kernel_hi, plan.whole_lo, plan.whole_hi):
        near |= (np.abs(xm[:, None, :] - np.asarray(edge)[None]) <= tol).any(-1).any(-1)
    return near


@pytest.mark.parametrize("metric", ("l1", "l2", "linf", "cosine"))
def test_map_phase_matches_reference(metric):
    data, _, plan, smap, _ = _reference_plan(metric)
    tplan = _plan(plan)
    tsmap = convert.space_map(smap.anchors, smap.metric, device="cpu")
    boxes = (plan.kernel_lo, plan.kernel_hi, plan.whole_lo, plan.whole_hi)
    want_xm, want_c, want_b = (
        np.asarray(v) for v in jops.map_assign(data, smap.anchors, *boxes, metric, backend="numpy")
    )
    x = torch.as_tensor(data)
    got_xm, got_c, got_b = (
        v.numpy() for v in ops.map_assign(
            x, tsmap.anchors, tplan.kernel_lo, tplan.kernel_hi, tplan.whole_lo,
            tplan.whole_hi, metric,
        )
    )
    np.testing.assert_allclose(got_xm, want_xm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tsmap(x).numpy(), np.asarray(smap(jnp.asarray(data))), rtol=1e-5, atol=1e-5)
    ok = ~_near_edge(want_xm, plan)
    np.testing.assert_array_equal(got_c[ok], want_c[ok])
    np.testing.assert_array_equal(got_b.view(np.uint32)[ok], want_b[ok])


@pytest.mark.parametrize("metric", ("l1", "l2"))
def test_tighten_and_membership_match_reference_on_same_coords(metric):
    data, _, plan, smap, _ = _reference_plan(metric)
    xm = np.array(smap(jnp.asarray(data)))
    cells = np.asarray(jpart.assign_kernel(plan, jnp.asarray(xm)))
    tplan = _plan(plan)
    txm = torch.as_tensor(xm)
    tcells = partition.assign_kernel(tplan, txm)
    np.testing.assert_array_equal(tcells.numpy(), cells)
    np.testing.assert_array_equal(partition.assign_kernel(tplan, txm, backend="auto").numpy(), cells)
    jt = jpart.tighten(plan, jnp.asarray(xm), jnp.asarray(cells))
    tt = partition.tighten(tplan, txm, tcells)
    for a, b in ((tt.whole_lo, jt.whole_lo), (tt.whole_hi, jt.whole_hi)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = np.asarray(jpart.whole_membership(jt, jnp.asarray(xm)))
    np.testing.assert_array_equal(partition.whole_membership(tt, txm).numpy(), want)
    np.testing.assert_array_equal(partition.whole_membership(tt, txm, backend="torch").numpy(), want)
    st = partition.partition_stats(cells, want)
    js = jpart.partition_stats(cells, want)
    for k in ("v_sizes", "w_sizes"):
        np.testing.assert_array_equal(st[k], js[k])


@pytest.mark.parametrize("strategy", ("learning", "iterative"))
def test_partition_tree_matches_reference(strategy):
    _, pivots, _, smap, cfg = _reference_plan("l1", strategy=strategy)
    piv_mapped = np.asarray(smap(jnp.asarray(pivots)))
    d = np.asarray(jdist.pairwise(jnp.asarray(pivots), jnp.asarray(pivots), "l1"))
    labels = jpart.single_linkage_labels(d, 2 * cfg.p)
    np.testing.assert_array_equal(partition.single_linkage_labels(d, 2 * cfg.p), labels)
    want = jpart.build_partition(piv_mapped, cfg.p, cfg.delta, strategy=strategy, labels=labels, seed=3)
    got = partition.build_partition(
        piv_mapped, cfg.p, cfg.delta, strategy=strategy, labels=labels, seed=3, device="cpu"
    )
    for a, b in zip(
        (got.kernel_lo, got.kernel_hi, got.whole_lo, got.whole_hi),
        (want.kernel_lo, want.kernel_hi, want.whole_lo, want.whole_hi),
    ):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(0)
    lab = rng.integers(0, 3, size=50)
    left = rng.random(50) < 0.4
    assert partition.gain_ratio(lab, left) == jpart.gain_ratio(lab, left)


@pytest.mark.parametrize("method", ("fft", "random"))
def test_select_anchors_picks_distinct_pivots(method):
    _, pivots, _, _, _ = _reference_plan("l1")
    tp = convert.pivots(pivots, device="cpu")
    smap = mapping.select_anchors(torch.Generator().manual_seed(0), tp, 6, "l1", method)
    anchors = smap.anchors.numpy()
    rows = {r.tobytes() for r in pivots}
    assert anchors.shape == (6, pivots.shape[1]) and all(a.tobytes() in rows for a in anchors)
    assert len({a.tobytes() for a in anchors}) == 6
    if method == "fft":
        # Farthest-first from the same start picks the reference's anchors.
        first = int(np.flatnonzero((pivots == anchors[0]).all(1))[0])
        d = np.asarray(jdist.pairwise(jnp.asarray(pivots), jnp.asarray(pivots), "l1"))
        chosen, min_d, idx = {first}, d[first].copy(), [first]
        for _ in range(5):
            nxt = int(np.argmax(np.where(np.isin(np.arange(len(d)), list(chosen)), -np.inf, min_d)))
            chosen.add(nxt)
            min_d = np.minimum(min_d, d[nxt])
            idx.append(nxt)
        np.testing.assert_array_equal(anchors, pivots[idx])


def test_select_anchors_residual_fill_with_few_distinct_pivots():
    piv = torch.as_tensor(np.repeat(np.eye(3, 4, dtype=np.float32), 4, axis=0))
    smap = mapping.select_anchors(torch.Generator().manual_seed(0), piv, 5, "l1", "fft")
    assert smap.anchors.shape == (5, 4)
    assert torch.unique(smap.anchors[:3], dim=0).shape[0] == 3  # the 3 distinct rows first
    assert jmap.select_anchors(jax.random.PRNGKey(0), jnp.asarray(piv.numpy()), 5, "l1").anchors.shape == (5, 4)
    assert distances.pairwise(smap.anchors, smap.anchors, "l1").shape == (5, 5)


def test_map_shards_and_as_numpy_match_reference():
    data, _, _, smap, _ = _reference_plan("l1")
    tmap = convert.space_map(np.asarray(smap.anchors), "l1", device="cpu")
    shards = np.array_split(data, 3)
    got = mapping.map_shards(tmap, [torch.as_tensor(s) for s in shards])
    want = jmap.map_shards(smap, [jnp.asarray(s) for s in shards])
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    host = mapping.as_numpy(tmap)
    assert host.metric == "l1" and host.anchors.device.type == "cpu"
    np.testing.assert_array_equal(host.anchors.numpy(), np.asarray(jmap.as_numpy(smap).anchors))
    np.testing.assert_array_equal(host(torch.as_tensor(data[:5])).numpy(), got[0][:5].numpy())
