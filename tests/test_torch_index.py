"""The port's persistent metric index against the JAX package's.

An index built by ``repro.core.index.build_index`` is saved in the shared
on-disk format and loaded into the port, so both packages serve from the
same control plane (torch cannot reproduce ``jax.random`` streams). The
port's ``query_batch`` must then give pairs byte-identical to the
reference's and to brute force, at the build δ and at another δ; the port's
own ``save`` must load into the reference; every ``load`` error path
raises; and queries never re-enter sampling or partitioning. δ sits
mid-way in a gap of the query-to-index distances, so no pair is within fp
reach of it and the comparisons are exact.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jdist
from repro.core import index as jindex
from repro.core import spjoin as jspjoin
from repro_torch.core import index, mapping, partition, spjoin

METRICS = ("l1", "l2", "linf")


def _gap_delta(x, y, metric, q):
    d = np.sort(np.asarray(jdist.pairwise(jnp.asarray(x), jnp.asarray(y), metric)).ravel())
    i = int(q * d.size)
    window = d[max(i - 100, 0) : i + 100]
    g = int(np.argmax(np.diff(window)))
    return float((window[g] + window[g + 1]) / 2)


def _dataset(seed=0, n=260, n_q=70, m=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, m)).astype(np.float32), rng.normal(size=(n_q, m)).astype(np.float32)


def _cfg(mod, metric, delta, **kw):
    return mod.JoinConfig(delta=delta, metric=metric, k=64, p=8, n_dims=3, **kw)


def _reference_index(tmp_path, metric, r, q, q_gap=0.02, **kw):
    delta = _gap_delta(r, q, metric, q_gap)
    ref_idx = jindex.build_index(r, _cfg(jspjoin, metric, delta, backend="numpy", **kw))
    path = ref_idx.save(str(tmp_path / f"ref_{metric}"))
    return ref_idx, index.MetricIndex.load(path, device="cpu"), delta


@pytest.mark.parametrize("metric", METRICS)
def test_reference_index_answers_identically(metric, tmp_path):
    r, q = _dataset()
    ref_idx, idx, delta = _reference_index(tmp_path, metric, r, q)
    assert idx.backend == "torch" and idx.data.device.type == "cpu"
    for d in (delta, _gap_delta(r, q, metric, 0.05)):
        want = ref_idx.query_batch(q, d)
        truth = index.brute_force_query(r, q, d, metric, device="cpu")
        got = idx.query_batch(torch.as_tensor(q), d)
        assert got.dtype == np.int64 and len(got) > 0
        assert got.tobytes() == want.tobytes() == truth.tobytes()


def test_query_stats_single_point_and_empty_batches(tmp_path):
    r, q = _dataset(1)
    ref_idx, idx, delta = _reference_index(tmp_path, "l1", r, q)
    pairs, st = idx.query_batch(q, with_stats=True)
    _, want = ref_idx.query_batch(q, with_stats=True)
    for k in ("n_queries", "n_routed", "n_cells_touched"):
        assert getattr(st, k) == getattr(want, k), k
    assert st.verify.n_hits == len(pairs) == want.verify.n_hits
    np.testing.assert_array_equal(idx.query(q[0]), ref_idx.query(q[0]))
    with pytest.raises(ValueError):
        idx.query(q)
    far = np.full((6, 5), 500.0, np.float32)
    assert idx.query_batch(far).shape == (0, 2)
    assert idx.query_batch(np.zeros((0, 5), np.float32)).shape == (0, 2)


def test_port_save_loads_into_reference_and_port(tmp_path):
    r, q = _dataset(2)
    delta = _gap_delta(r, q, "l2", 0.02)
    idx = index.build_index(r, _cfg(spjoin, "l2", delta), device="cpu")
    path = idx.save(str(tmp_path / "port"))
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["backend"] == "numpy" and man["version"] == index.FORMAT_VERSION
    theirs = jindex.MetricIndex.load(path)
    ours = index.MetricIndex.load(path, device="cpu")
    for name in index._ARRAYS:
        a = np.asarray(getattr(idx, name))
        assert a.tobytes() == np.asarray(getattr(theirs, name)).tobytes(), name
        assert a.tobytes() == np.asarray(getattr(ours, name)).tobytes(), name
    for name in index._PLAN_ARRAYS:
        assert np.asarray(getattr(idx.placement, name)).tobytes() == \
            np.asarray(getattr(theirs.placement, name)).tobytes(), name
    truth = index.brute_force_query(r, q, delta, "l2", device="cpu")
    assert len(truth) > 0
    assert idx.query_batch(q).tobytes() == truth.tobytes()
    assert ours.query_batch(q).tobytes() == truth.tobytes()
    assert theirs.query_batch(q).tobytes() == truth.tobytes()
    assert idx.self_pairs().tobytes() == spjoin.brute_force_pairs(r, delta, "l2", device="cpu").tobytes()


def _corrupt(kind, path):
    mpath = os.path.join(path, "manifest.json")
    man = json.load(open(mpath))
    if kind == "missing":
        os.remove(mpath)
    elif kind == "format":
        man["format"] = "something-else"
    elif kind == "version":
        man["version"] = index.FORMAT_VERSION + 1
    elif kind == "backend":
        man["backend"] = "tpu-v9"
    elif kind == "shape":
        man["arrays"] = {**man["arrays"], "pivots": [1, 1]}
    elif kind == "k":
        man["k"] = man["k"] + 1
    elif kind == "incremental":
        man.pop("incremental")
    elif kind == "counters":
        man["incremental"]["n_inserted"] = 7
    elif kind == "npz":
        z = dict(np.load(os.path.join(path, "arrays.npz")))
        z.pop("observed_w")
        np.savez(os.path.join(path, "arrays.npz"), **z)
    if kind != "missing":
        json.dump(man, open(mpath, "w"))


@pytest.mark.parametrize("kind,err,match", [
    ("missing", index.IndexFormatError, "manifest"),
    ("format", index.IndexFormatError, "format"),
    ("version", index.IndexFormatError, "version"),
    ("backend", index.IndexFormatError, "backend"),
    ("shape", index.IndexFormatError, "shape"),
    ("k", index.IndexFormatError, "pivot count"),
    ("npz", index.IndexFormatError, "missing"),
    ("incremental", index.IndexFormatError, "incremental"),
    ("counters", index.IndexMismatchError, "stream"),
])
def test_load_error_paths(kind, err, match, tmp_path):
    r, _ = _dataset(3)
    path = index.build_index(r, _cfg(spjoin, "l1", 2.0), device="cpu").save(str(tmp_path / "i"))
    _corrupt(kind, path)
    with pytest.raises(err, match=match):
        index.MetricIndex.load(path, device="cpu")


def test_load_checks_the_callers_expectations(tmp_path):
    r, _ = _dataset(4)
    path = index.build_index(r, _cfg(spjoin, "l1", 2.0), device="cpu").save(str(tmp_path / "i"))
    assert index.MetricIndex.load(path, metric="l1", delta=2.0, k=64, device="cpu").metric == "l1"
    with pytest.raises(index.IndexMismatchError, match="metric"):
        index.MetricIndex.load(path, metric="l2", device="cpu")
    with pytest.raises(index.IndexMismatchError, match="delta"):
        index.MetricIndex.load(path, delta=9.0, device="cpu")
    with pytest.raises(index.IndexMismatchError, match="pivots"):
        index.MetricIndex.load(path, k=999, device="cpu")


def test_queries_perform_no_sampling_or_partitioning(monkeypatch):
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
    r, q = _dataset(5)
    idx = index.build_index(r, _cfg(spjoin, "l2", 1.0), device="cpu")
    after_build = dict(counts)
    assert all(v == 1 for v in after_build.values()), after_build
    idx.query_batch(q)
    idx.query_batch(q, delta=0.5)
    idx.query(q[0])
    assert counts == after_build, f"query phase re-entered the build: {counts}"


def test_fused_on_off_identical_and_distributed_not_ported(tmp_path):
    """Fused and two-pass map phases answer identically; ``to_distributed``
    on a world of 1 (gloo, in process) serves the same bytes."""
    r, q = _dataset(6)
    delta = _gap_delta(r, q, "l2", 0.02)
    on = index.build_index(r, _cfg(spjoin, "l2", delta, map_fused=True), device="cpu")
    off = index.build_index(r, _cfg(spjoin, "l2", delta, map_fused=False), device="cpu")
    assert on.query_batch(q).tobytes() == off.query_batch(q).tobytes()
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rdzv", world_size=1, rank=0
    )
    try:
        dist_idx = on.to_distributed()
        assert type(dist_idx).__name__ == "DistIndex"
        assert dist_idx.query_batch(q).tobytes() == on.query_batch(q).tobytes()
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize(
    "entry",
    (
        lambda p: index.build_index(np.zeros((8, 2), np.float32), _cfg(spjoin, "l1", 1.0)),
        lambda p: index.MetricIndex.load(p),
        lambda p: index.brute_force_query(np.zeros((4, 2), np.float32), np.zeros((2, 2), np.float32), 1.0, "l1"),
        lambda p: spjoin.join_incremental([np.zeros((8, 2), np.float32)], _cfg(spjoin, "l1", 1.0)),
    ),
    ids=("build_index", "load", "brute_force_query", "join_incremental"),
)
def test_serving_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    """Like ``join``, the serving entry points run on the card unless the
    caller passes ``device="cpu"``; without CUDA they raise."""
    r, _ = _dataset(7)
    path = index.build_index(r, _cfg(spjoin, "l1", 2.0), device="cpu").save(str(tmp_path / "i"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(path)
