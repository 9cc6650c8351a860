"""The port's sampling-phase modules against the JAX package: distances,
expfam fits, the GoF confidence, and the samplers.

Fits and statistics agree within fp32 tolerance on the same shards (made
with numpy from a seed). The samplers cannot draw the same pivots (torch
cannot reproduce ``jax.random`` streams), so they are held to
distribution-level checks: the allocation and the count k.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jdist
from repro.core import expfam as jexp
from repro.core import gof as jgof
from repro.core import sampling as jsamp
from repro_torch import convert
from repro_torch.core import distances, expfam, gof, sampling
from repro_torch.data import synthetic

RTOL = 2e-5  # fp32, different summation orders and special-function kernels


def _shard(kind, seed=0, n=400, m=6):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.normal(size=(n, m)) * 2 + 3).astype(np.float32)
    if kind == "exponential":
        return rng.exponential(1.5, size=(n, m)).astype(np.float32)
    return rng.gamma(3.0, 0.7, size=(n, m)).astype(np.float32)


@pytest.mark.parametrize("metric", sorted(jdist.METRICS))
def test_pairwise_matches_reference(metric):
    rng = np.random.default_rng(1)
    if metric == "jaccard_minhash":
        x = rng.integers(0, 5, size=(30, 16)).astype(np.float32)
        y = rng.integers(0, 5, size=(20, 16)).astype(np.float32)
    else:
        x = rng.normal(size=(30, 16)).astype(np.float32)
        y = rng.normal(size=(20, 16)).astype(np.float32)
    want = np.asarray(jdist.pairwise(jnp.asarray(x), jnp.asarray(y), metric))
    got = distances.pairwise(torch.as_tensor(x), torch.as_tensor(y), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jm, tm = jdist.get_metric(metric), distances.get_metric(metric)
    assert (jm.mxu_friendly, jm.true_metric, jm.discrete) == (
        tm.mxu_friendly, tm.true_metric, tm.discrete,
    )


@pytest.mark.parametrize("kind", ("normal", "exponential", "gamma"))
@pytest.mark.parametrize("family", ("normal", "exponential", "gamma"))
def test_fits_match_reference(kind, family):
    x = _shard(kind, seed=len(kind) + len(family))
    jp = jexp.fit(family, jexp.suff_stats(jnp.asarray(x)))
    tp = expfam.fit(family, expfam.suff_stats(torch.as_tensor(x)))
    np.testing.assert_allclose(tp.a.numpy(), np.asarray(jp.a), rtol=1e-4)
    np.testing.assert_allclose(tp.b.numpy(), np.asarray(jp.b), rtol=1e-4)
    u = np.linspace(0.05, 0.95, 7, dtype=np.float32)[:, None].repeat(x.shape[1], 1)
    np.testing.assert_allclose(
        expfam.cdf(tp, torch.as_tensor(x)).numpy(), np.asarray(jexp.cdf(jp, jnp.asarray(x))),
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        expfam.quantile(tp, torch.as_tensor(u)).numpy(),
        np.asarray(jexp.quantile(jp, jnp.asarray(u))), rtol=1e-3, atol=1e-4,
    )


@pytest.mark.parametrize("kind", ("normal", "exponential", "gamma"))
def test_gof_matches_reference(kind):
    x = _shard(kind, seed=3)
    jpar, jres = jgof.fit_best_family(jnp.asarray(x), t=8)
    tpar, tres = gof.fit_best_family(torch.as_tensor(x), t=8)
    assert tpar.family == jpar.family
    np.testing.assert_allclose(float(tres.statistic), float(jres.statistic), rtol=1e-3)
    np.testing.assert_allclose(float(tres.confidence), float(jres.confidence), rtol=1e-3, atol=1e-6)
    assert float(tres.dof) == float(jres.dof)
    for k, df in ((3.0, 4.0), (40.0, 30.0), (0.0, 2.0)):
        np.testing.assert_allclose(
            float(gof.chi2_sf(torch.tensor(k), torch.tensor(df))),
            float(jgof.chi2_sf(jnp.asarray(k), jnp.asarray(df))), rtol=RTOL, atol=1e-7,
        )


@pytest.mark.parametrize("k", (1, 50, 999, 5000))
def test_allocate_samples_matches_reference(k):
    rng = np.random.default_rng(k)
    n_i = rng.integers(1, 800, size=5)
    c_i = rng.random(5)
    got = sampling.allocate_samples(n_i, c_i, k)
    np.testing.assert_array_equal(got, jsamp.allocate_samples(n_i, c_i, k))
    assert got.sum() == min(k, n_i.sum()) and (got <= n_i).all()


def _node_stats(shards):
    out = []
    for s in shards:
        par, res = gof.fit_best_family(s)
        out.append(sampling.NodeStats(par.family, par, float(res.confidence), int(s.shape[0])))
    return out


def test_generative_sample_returns_k_from_the_mixture():
    shards = [torch.as_tensor(_shard("normal", seed=i, n=600)) for i in range(3)]
    stats = _node_stats(shards)
    gen = torch.Generator().manual_seed(0)
    piv, acc = sampling.generative_sample(gen, stats, 256)
    assert piv.shape == (256, 6) and torch.isfinite(piv).all() and 0.0 < acc <= 1.0
    # Distribution level: the pivots' marginals follow the shards'.
    err = float(sampling.sampling_error(piv, torch.cat(shards)))
    assert err < 0.15, err


def test_generative_sample_from_reference_node_stats():
    """The reference's fitted node statistics, carried over with
    ``convert.node_stats``, drive the port's Gibbs chain."""
    shards = [_shard(kind, seed=i) for i, kind in enumerate(("normal", "gamma", "exponential"))]
    ref_stats = []
    for s in shards:
        par, res = jgof.fit_best_family(jnp.asarray(s))
        ref_stats.append(jsamp.NodeStats(par.family, par, float(res.confidence), len(s)))
    stats = [
        convert.node_stats(s.family, s.params.a, s.params.b, s.confidence, s.count, device="cpu")
        for s in ref_stats
    ]
    assert [s.family for s in stats] == [s.family for s in ref_stats]
    gen = torch.Generator().manual_seed(3)
    piv, acc = sampling.generative_sample(gen, stats, 200)
    assert piv.shape == (200, 6) and torch.isfinite(piv).all() and acc > 0.0


def test_gibbs_chain_shortfall_repeats_accepted_draws():
    shards = [torch.as_tensor(_shard("normal", seed=i)) for i in range(2)]
    stats = [s._replace(confidence=0.0) for s in _node_stats(shards)]
    gen = torch.Generator().manual_seed(1)
    piv, acc = sampling.gibbs_chain(gen, stats, 64, normalize_confidence=False)
    length = int(np.ceil(64 / 0.05 * 1.5)) + 8  # c_min floors at 0.05
    n_accepted = round(acc * length)
    assert piv.shape == (64, 6) and torch.isfinite(piv).all()
    # Confidence floors at 1e-3: a handful of draws are accepted and the
    # shortfall repeats them — no rejected draw is returned.
    assert 0 < n_accepted < 64
    assert torch.unique(piv, dim=0).shape[0] <= n_accepted


@pytest.mark.parametrize("allocation", ("eq11", "proportional"))
def test_distribution_aware_sample_count_and_membership(allocation):
    x = synthetic.mixture(900, 5, n_clusters=3, seed=4)
    shards = [torch.as_tensor(s) for s in np.array_split(x, 3)]
    stats = _node_stats(shards)
    gen = torch.Generator().manual_seed(2)
    piv = sampling.distribution_aware_sample(gen, shards, stats, 120, allocation=allocation)
    assert piv.shape == (120, 5)
    rows = {r.tobytes() for r in x}
    assert all(r.tobytes() in rows for r in piv.numpy())  # real rows only
    assert torch.unique(piv, dim=0).shape[0] == 120  # without replacement


def test_random_sample_and_sample_size():
    x = torch.arange(40, dtype=torch.float32).reshape(20, 2)
    gen = torch.Generator().manual_seed(0)
    piv = sampling.random_sample(gen, x, 50)
    assert piv.shape == (20, 2) and torch.unique(piv, dim=0).shape[0] == 20
    for eps, fail, m in ((0.05, 0.01, 8), (0.2, 100.0, 4)):
        assert sampling.required_sample_size(eps, fail, m) == jsamp.required_sample_size(eps, fail, m)


@pytest.mark.parametrize("k, eps, m", ((1, 0.05, 8), (500, 0.05, 8), (3000, 0.02, 128), (10, 0.5, 1)))
def test_error_bound_probability_matches_reference(k, eps, m):
    got = sampling.error_bound_probability(k, eps, m)
    assert isinstance(got, float) and got == jsamp.error_bound_probability(k, eps, m)
    dp = 0.05
    k_req = sampling.required_sample_size(eps, dp, m)
    assert sampling.error_bound_probability(k_req, eps, m) <= dp * (1 + 1e-9)


@pytest.mark.parametrize("kind", ("normal", "exponential", "gamma"))
def test_global_confidence_and_merge_stats_match_reference(kind):
    shards = [_shard(kind, seed=s, n=300 + 50 * s) for s in range(3)]
    ks, dofs, conf = [], [], []
    for s in shards:
        _, res = jgof.fit_best_family(jnp.asarray(s), t=8)
        ks.append(float(res.statistic))
        dofs.append(float(res.dof))
        conf.append(float(res.confidence))
    got = float(gof.global_confidence(torch.tensor(ks), torch.tensor(dofs)))
    want = float(jgof.global_confidence(jnp.asarray(ks), jnp.asarray(dofs)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # Theorem 2: the global confidence is at least the smallest node's.
    assert got >= min(conf) - 1e-6
    jst = [jexp.suff_stats(jnp.asarray(s)) for s in shards]
    tst = [expfam.suff_stats(torch.as_tensor(s)) for s in shards]
    jm = jexp.merge_stats(jexp.SuffStats(*(jnp.stack(f) for f in zip(*jst))))
    tm = expfam.merge_stats(expfam.SuffStats(*(torch.stack(f) for f in zip(*tst))))
    for t, j in zip(tm, jm):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5)
    whole = expfam.suff_stats(torch.as_tensor(np.concatenate(shards)))
    for t, w in zip(tm, whole):
        np.testing.assert_allclose(t.numpy(), w.numpy(), rtol=1e-5)


@pytest.mark.parametrize("family", ("normal", "exponential", "gamma"))
def test_log_prob_and_fit_jit_match_reference(family):
    x = _shard("gamma", seed=7)
    jp = jexp.fit(family, jexp.suff_stats(jnp.asarray(x)))
    tp = expfam.FamilyParams(family, torch.tensor(np.asarray(jp.a)), torch.tensor(np.asarray(jp.b)))
    pts = np.concatenate([x[:20], -x[:3]])  # the last rows lie off the positive support
    got = expfam.log_prob(tp, torch.as_tensor(pts)).numpy()
    want = np.asarray(jexp.log_prob(jp, jnp.asarray(pts)))
    assert got.shape == (23,)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    packed = expfam.fit_jit(family, torch.as_tensor(x))
    assert packed.shape == (2 * x.shape[1] + 1,)
    np.testing.assert_allclose(packed.numpy(), np.asarray(jexp.fit_jit(family, jnp.asarray(x))), rtol=1e-4)


def _ref_stats(kinds, m=3, n=2000):
    out = []
    for i, kind in enumerate(kinds):
        s = _shard(kind, seed=20 + i, n=n, m=m)
        par, res = jgof.fit_best_family(jnp.asarray(s))
        out.append(jsamp.NodeStats(par.family, par, float(res.confidence), n + 100 * i))
    return out


def _ks_per_dim(a, b):
    from scipy.stats import ks_2samp

    return [float(ks_2samp(a[:, d], b[:, d]).pvalue) for d in range(a.shape[1])]


def test_generative_model_draws_follow_the_reference_chain():
    """The reference's broadcast model, carried over with
    ``convert.generative_model``: the port's chain over it and the
    reference's fixed-length chain draw the same law (fixed-seed two-sample
    KS per dimension)."""
    import jax

    ref_stats = _ref_stats(("normal", "gamma", "exponential"))
    ref_model = jsamp.GenerativeModel(
        families=tuple(s.family for s in ref_stats),
        packed_params=jnp.stack([jexp.pack(s.params) for s in ref_stats]),
        confidence=jnp.asarray([s.confidence for s in ref_stats], jnp.float32),
        counts=jnp.asarray([s.count for s in ref_stats], jnp.float32),
    )
    model = convert.generative_model(ref_model, device="cpu")
    assert model.n_nodes == 3 and model.families == ref_model.families
    assert model.packed_params.shape == (3, 7) and model.counts.dtype == torch.float32
    stats = model.node_stats()
    assert [s.count for s in stats] == [s.count for s in ref_stats]
    np.testing.assert_allclose([s.confidence for s in stats], [s.confidence for s in ref_stats], rtol=1e-6)
    k = 2000
    want, _ = jsamp.gibbs_chain(jax.random.PRNGKey(0), ref_model, k)
    got, acc = sampling.gibbs_chain(torch.Generator().manual_seed(0), stats, k)
    assert got.shape == (k, 3) and acc > 0.0
    assert min(_ks_per_dim(got.numpy(), np.asarray(want))) > 1e-3


def test_gibbs_chain_numpy_follows_the_reference_loop():
    """The paper's exact loop, port against reference: the same law (KS per
    dimension) from the same ``np.random.Generator`` seed."""
    ref_stats = _ref_stats(("normal", "exponential"), n=1500)
    stats = [
        convert.node_stats(s.family, s.params.a, s.params.b, s.confidence, s.count, device="cpu")
        for s in ref_stats
    ]
    k = 600
    got = sampling.gibbs_chain_numpy(np.random.default_rng(0), stats, k)
    want = jsamp.gibbs_chain_numpy(np.random.default_rng(0), ref_stats, k)
    assert got.shape == want.shape == (k, 3) and got.dtype == np.float32
    assert min(_ks_per_dim(got, want)) > 1e-3
