"""The port's dedup against the JAX package's (``repro.data.dedup``).

Both joins are exact, so for the same vectors the pair sets are identical
whatever pivots each package draws, and the union-find (lowest index as
root) must then give the same keep mask. The q-gram profiles are computed
once in this process and handed to both packages.
"""
import numpy as np
import pytest

from repro.data import dedup as jdedup
from repro_torch.core import spjoin
from repro_torch.data import dedup, synthetic, vectorize


def _near_duplicates(seed=0):
    """The vectors of tests/test_partition_join.py::test_dedup_removes_near_duplicates."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(60, 8)).astype(np.float32)
    dups = base[:20] + rng.normal(scale=1e-3, size=(20, 8)).astype(np.float32)
    return np.concatenate([base, dups])


def _profiles(seed):
    strs = synthetic.strings(300, n_templates=12, mutate=0.12, seed=seed)
    return vectorize.qgram_profile(strs, q=2, dim=64)


def _check_same(got, want, n):
    assert got.keep_mask.dtype == bool and got.keep_mask.shape == (n,)
    assert np.array_equal(got.keep_mask, want.keep_mask)
    assert got.n_components == want.n_components
    assert got.n_duplicates == want.n_duplicates == n - got.n_components
    assert got.pairs.tobytes() == want.pairs.tobytes()


@pytest.mark.parametrize("seed", (0, 1))
def test_dedup_near_duplicates_matches_reference(seed):
    data = _near_duplicates(seed)
    got = dedup.dedup(data, delta=0.05, metric="l2", device="cpu")
    want = jdedup.dedup(data, delta=0.05, metric="l2")
    _check_same(got, want, data.shape[0])
    assert got.n_duplicates == 20 and data[got.keep_mask].shape[0] == 60


@pytest.mark.parametrize("seed, delta", ((2, 2.0), (3, 6.0)))
def test_dedup_qgram_profiles_matches_reference(seed, delta):
    prof = _profiles(seed)
    got = dedup.dedup(prof, delta, metric="l1", device="cpu")
    want = jdedup.dedup(prof, delta, metric="l1")
    _check_same(got, want, prof.shape[0])
    assert 0 < got.n_duplicates < prof.shape[0]


def test_dedup_with_a_given_config():
    prof = _profiles(4)
    cfg = spjoin.JoinConfig(delta=4.0, metric="l1", k=64, p=5, n_dims=3, seed=9)
    got = dedup.dedup(prof, 4.0, cfg=cfg, device="cpu")
    truth = spjoin.brute_force_pairs(prof, 4.0, "l1", device="cpu")
    assert got.pairs.tobytes() == truth.tobytes()
    assert got.n_components == int(got.keep_mask.sum())


@pytest.mark.parametrize("seed", (0, 5))
def test_union_find_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 200
    pairs = np.sort(rng.integers(0, n, size=(150, 2)), axis=1)
    got, want = dedup._UnionFind(n), jdedup._UnionFind(n)
    for i, j in pairs.tolist():
        got.union(i, j)
        want.union(i, j)
    roots = [got.find(i) for i in range(n)]
    assert roots == [want.find(i) for i in range(n)]
    # Lowest index as root: every root is the smallest member of its set.
    for i, r in enumerate(roots):
        assert r <= i and roots[r] == r
