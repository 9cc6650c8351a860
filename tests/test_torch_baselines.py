"""The port's baselines and brute-force oracle against the JAX package's.

``ball_join`` is given the reference's pivots (``jax.random`` streams cannot
be reproduced), so both run one plan: pairs byte-identical,
``n_verifications`` and ``cost`` equal. The reference's dense per-cell
loop and the port's streaming engine decide each pair on the same fp32
distance form; the data are kept away from δ-ties by their draw.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import distances as jdist
from repro.core import sampling as jsamp
from repro_torch.core import baselines, distances, spjoin
from repro_torch.data import synthetic, vectorize

DELTA = {"l1": 3.0, "l2": 1.2, "linf": 0.6, "cosine": 0.02, "jaccard_minhash": 0.4}


def _data(metric, n=240):
    if metric == "jaccard_minhash":
        strs = synthetic.strings(n, length=(24, 60), n_templates=8, mutate=0.08, seed=1)
        return vectorize.minhash(vectorize.shingle_sets(strs, q=3), k=32).astype(np.float32)
    return synthetic.mixture(n, 6, n_clusters=3, spread=3.0, seed=4)


def test_kpm_config_matches_reference():
    got = baselines.kpm_config(0.5, "l2", k=64, p=6, n_dims=5, seed=3)
    want = jbase.kpm_config(0.5, "l2", k=64, p=6, n_dims=5, seed=3)
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.pop("backend") == "auto" and w.pop("backend") == "auto"
    assert g == w


@pytest.mark.parametrize("metric", sorted(DELTA))
def test_ball_join_matches_reference_on_its_pivots(metric, n_pivots=5):
    x = _data(metric)
    delta = DELTA[metric]
    want = jbase.ball_join(x, delta, metric, n_pivots, seed=2)
    pivots = np.array(jsamp.random_sample(jax.random.PRNGKey(2), jnp.asarray(x), n_pivots))
    got = baselines._ball_join_with_pivots(x, pivots, delta, metric, device="cpu")
    assert got.pairs.dtype == np.int64 and got.n_pairs > 0
    assert got.pairs.tobytes() == want.pairs.tobytes()
    assert got.n_verifications == want.n_verifications
    assert dataclasses.astuple(got.cost) == dataclasses.astuple(want.cost)
    assert got.verify_stats.prune == "none"


@pytest.mark.parametrize("metric", ("l1", "l2", "linf", "jaccard_minhash"))
def test_ball_join_exact_against_brute_force(metric):
    x = _data(metric)
    res = baselines.ball_join(x, DELTA[metric], metric, n_pivots=10, seed=5, device="cpu")
    truth = spjoin.brute_force_pairs(x, DELTA[metric], metric, device="cpu")
    assert res.pairs.tobytes() == truth.tobytes()
    assert res.sample_time_s >= 0 and res.map_time_s >= 0 and res.verify_time_s >= 0
    assert res.node_confidences.shape == (0,)
    # The same pair set as the SP-Join and KPM arms.
    for cfg in (
        spjoin.JoinConfig(delta=DELTA[metric], metric=metric, k=96, p=6, n_dims=4),
        baselines.kpm_config(DELTA[metric], metric, k=96, p=6, n_dims=4),
    ):
        assert spjoin.join(x, cfg, device="cpu").pairs.tobytes() == truth.tobytes()


def test_ball_join_return_pairs_false_and_more_pivots_than_rows():
    x = _data("l1", n=40)
    res = baselines.ball_join(x, 3.0, "l1", n_pivots=64, return_pairs=False, device="cpu")
    assert res.n_pairs == 0 and res.cost.total == res.n_verifications > 0
    assert res.verify_stats.n_hits > 0


@pytest.mark.parametrize("metric", ("l1", "l2", "jaccard_minhash"))
@pytest.mark.parametrize("cross", (False, True))
def test_brute_force_join_matches_reference(metric, cross):
    x = _data(metric, n=120)
    delta = DELTA[metric]
    if cross:
        r, s = x[:50], x[50:]
        got = distances.brute_force_join(torch.as_tensor(r), torch.as_tensor(s), delta, metric)
        want = jdist.brute_force_join(jnp.asarray(r), jnp.asarray(s), delta, metric)
        assert got.shape == (50, 70)
        kw = distances.brute_force_join(r, s=s, delta=delta, metric=metric)
        assert torch.equal(kw, got)
    else:
        got = distances.brute_force_join(torch.as_tensor(x), delta, metric)
        want = jdist.brute_force_join(jnp.asarray(x), delta, metric)
        assert not bool(got.tril().any())
    assert got.dtype == torch.bool and int(got.sum()) > 0
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_brute_force_join_empty_sides_and_default_metric():
    x = torch.as_tensor(_data("l1", n=30))
    empty = torch.zeros((0, 6))
    assert distances.brute_force_join(x, empty, 1.0).shape == (30, 0)
    assert distances.brute_force_join(empty, x, 1.0).shape == (0, 30)
    got = distances.brute_force_join(x, delta=3.0)  # metric defaults to l1
    assert np.array_equal(got.numpy(), np.asarray(jdist.brute_force_join(jnp.asarray(x.numpy()), 3.0)))


@pytest.mark.parametrize(
    "args, kwargs",
    (
        ((), {}),  # no delta
        ((1.0,), {"delta": 1.0}),  # delta twice
        ((1.0, "l1"), {"metric": "l1"}),  # metric twice
        ((1.0, "l1", "extra"), {}),  # too many positionals
        ((np.zeros((3, 2), np.float32), 1.0), {"s": np.zeros((3, 2), np.float32)}),  # s twice
        ((1.0,), {"bogus": 1}),  # unknown keyword
    ),
    ids=("no-delta", "delta-twice", "metric-twice", "too-many", "s-twice", "unknown-kw"),
)
def test_brute_force_join_type_errors_match_reference(args, kwargs):
    x = np.zeros((3, 2), np.float32)
    with pytest.raises(TypeError) as want:
        jdist.brute_force_join(jnp.asarray(x), *args, **kwargs)
    with pytest.raises(TypeError) as got:
        distances.brute_force_join(torch.as_tensor(x), *args, **kwargs)
    assert str(got.value) == str(want.value)
