"""The slice end to end: ``repro_torch.core.spjoin.join(device="cpu")``
against ``repro.core.spjoin.join(backend="numpy")`` on the same data.

The two packages draw different pivots (torch cannot reproduce
``jax.random`` streams), but the join is exact for any pivots, so the
sorted unique int64 pair sets must be byte-identical — or else every
differing pair lies within 1e-5·max(1, δ) of δ in float64 (fp summation
order differs between the two). Both are also held to brute force.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import spjoin as jspjoin
from repro_torch import convert
from repro_torch.core import baselines, partition, spjoin
from repro_torch.data import dedup, synthetic

DELTA = {"l1": 3.0, "l2": 1.2, "linf": 0.6}


def _d64(a, b, metric):
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    if metric == "l1":
        return diff.sum(-1)
    if metric == "linf":
        return diff.max(-1)
    return np.sqrt((diff * diff).sum(-1))


def _assert_same_pairs(got, want, r, s, delta, metric):
    assert got.dtype == np.int64 and got.ndim == 2 and got.shape[1] == 2
    if got.tobytes() == want.tobytes():
        return
    g = {tuple(p) for p in got}
    w = {tuple(p) for p in want}
    diff = np.array(sorted(g ^ w))
    d = _d64(r[diff[:, 0]], s[diff[:, 1]], metric)
    assert (np.abs(d - delta) <= 1e-5 * max(1.0, delta)).all(), diff


def _data(cross):
    if cross:
        return synthetic.rs_mixture(260, 320, 6, n_clusters=3, spread=3.0, seed=5)
    return synthetic.mixture(420, 6, n_clusters=3, spread=3.0, seed=4), None


@pytest.mark.parametrize("metric", ("l1", "l2", "linf"))
@pytest.mark.parametrize("prune", ("pivot", "none"))
@pytest.mark.parametrize("cross", (False, True))
def test_join_matches_reference(metric, prune, cross):
    r, s = _data(cross)
    kw = dict(delta=DELTA[metric], metric=metric, k=128, p=8, n_dims=4, prune=prune)
    got = spjoin.join(r, spjoin.JoinConfig(**kw), s=s, device="cpu")
    want = jspjoin.join(r, jspjoin.JoinConfig(backend="numpy", **kw), s=s)
    w = r if s is None else s
    _assert_same_pairs(got.pairs, want.pairs, r, w, kw["delta"], metric)
    truth = spjoin.brute_force_pairs(r, kw["delta"], metric, s=s, device="cpu")
    _assert_same_pairs(got.pairs, truth, r, w, kw["delta"], metric)
    assert got.n_pairs > 0
    vs = got.verify_stats
    assert vs.prune == ("pivot" if prune == "pivot" else "none")
    assert vs.n_verifications == got.n_verifications == int(got.per_cell_verified.sum())
    assert got.placement_plan is not None and got.device_loads.shape == (4,)
    assert got.sample_time_s >= 0 and got.map_time_s >= 0 and got.verify_time_s >= 0


@pytest.mark.parametrize(
    "overrides",
    (
        dict(sampler="random"),
        dict(sampler="distribution", partitioner="iterative"),
        dict(tighten=False),
        dict(map_fused=False, anchor_method="random"),
        dict(metric="angular", delta=0.08),
    ),
)
def test_join_options_exact(overrides):
    r, _ = _data(False)
    kw = dict(delta=3.0, metric="l1", k=96, p=6, n_dims=4)
    kw.update(overrides)
    got = spjoin.join(r, spjoin.JoinConfig(**kw), device="cpu")
    truth = spjoin.brute_force_pairs(r, kw["delta"], kw["metric"], device="cpu")
    if kw["metric"] == "angular":
        assert got.pairs.tobytes() == truth.tobytes()
    else:
        _assert_same_pairs(got.pairs, truth, r, r, kw["delta"], kw["metric"])


def test_join_aliasing_and_shard_lists():
    r, _ = _data(False)
    cfg = spjoin.JoinConfig(delta=3.0, k=96, p=6, n_dims=4)
    base = spjoin.join(r, cfg, device="cpu")
    assert spjoin.join(r, cfg, s=r, device="cpu").pairs.tobytes() == base.pairs.tobytes()
    shards = [torch.as_tensor(v) for v in np.array_split(r, 4)]
    assert spjoin.join(shards, cfg, device="cpu").pairs.tobytes() == base.pairs.tobytes()


def test_join_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spjoin.join(np.zeros((4, 2), np.float32), spjoin.JoinConfig(delta=1.0))


@pytest.mark.parametrize(
    "entry",
    (
        lambda: spjoin.brute_force_pairs(np.zeros((4, 2), np.float32), 1.0),
        lambda: partition.build_partition(np.zeros((8, 2)), 2, 0.1, strategy="iterative"),
        lambda: convert.pivots(np.zeros((4, 2))),
        lambda: convert.space_map(np.zeros((2, 2)), "l1"),
        lambda: convert.partition_plan(*[np.zeros((2, 2))] * 4, 0.1),
        lambda: convert.node_stats("gaussian", np.zeros(2), np.ones(2), 0.5, 4),
        lambda: baselines.ball_join(np.zeros((4, 2), np.float32), 1.0),
        lambda: dedup.dedup(np.zeros((4, 2), np.float32), 1.0),
    ),
    ids=("brute_force_pairs", "build_partition", "pivots", "space_map", "partition_plan", "node_stats",
         "ball_join", "dedup"),
)
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Like ``join``, the other public entry points run on the card unless
    the caller passes ``device="cpu"``; without CUDA they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def _nudge(x: torch.Tensor, gen: torch.Generator, most: int = 4) -> torch.Tensor:
    """``x`` moved by a random whole number of ulps in [-most, most] per
    element: what a different fp32 summation order does to a distance."""
    steps = torch.randint(-most, most + 1, x.shape, generator=gen)
    up, down = torch.full_like(x, float("inf")), torch.full_like(x, float("-inf"))
    for _ in range(most):
        x = torch.where(steps > 0, torch.nextafter(x, up), torch.where(steps < 0, torch.nextafter(x, down), x))
        steps = steps - steps.sign()
    return x


@pytest.mark.parametrize("tighten", (True, False))
@pytest.mark.parametrize("fused", (True, False))
def test_join_exact_when_mapped_coordinates_round_differently(monkeypatch, tighten, fused):
    """Lemma 4 on computed coordinates: a row's mapped coordinate is a sum
    rounded in fp32, and the card's kernel sums in another order than the
    plain path. On integer rows under l1 many pairs sit at exactly δ with
    the triangle inequality tight along an anchor (every same-side pair of
    a 1-feature set), so a δ-neighbour of a row on its cell's box face
    lies a few ulps past a box expanded by exactly δ. The join must stay
    exact with every coordinate nudged by up to 4 ulps."""
    x = np.random.default_rng(0).integers(0, 120, size=(600, 1)).astype(np.float32)
    delta = 4.0
    gen = torch.Generator().manual_seed(0)
    real_map_assign, real_call = spjoin.kops.map_assign, spjoin.mapping.SpaceMap.__call__

    def map_assign(*args, **kwargs):
        xm, cells, bits = real_map_assign(*args, **kwargs)
        return _nudge(xm, gen), cells, bits

    def space_map(self, v):
        return _nudge(real_call(self, v), gen)

    monkeypatch.setattr(spjoin.kops, "map_assign", map_assign)
    monkeypatch.setattr(spjoin.mapping.SpaceMap, "__call__", space_map)
    cfg = spjoin.JoinConfig(delta=delta, metric="l1", k=64, p=8, n_dims=1, tighten=tighten,
                            map_fused=fused)
    truth = spjoin.brute_force_pairs(x, delta, "l1", device="cpu")
    for seed in range(4):
        got = spjoin.join(x, dataclasses.replace(cfg, seed=seed), device="cpu")
        assert got.pairs.tobytes() == truth.tobytes(), seed
