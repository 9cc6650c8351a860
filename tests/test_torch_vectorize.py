"""The port's string/set transforms and generators against the JAX
package's (``repro.data.vectorize``, ``repro.data.synthetic``): exact.

``qgram_profile`` and ``shingle_sets`` hash with Python's per-process salted
``hash()``, so both sides are computed in this process and nothing here
pins a value computed in another one.
"""
import numpy as np
import pytest

from repro.data import synthetic as jsyn
from repro.data import vectorize as jvec
from repro_torch.data import synthetic, vectorize


def _corpus(n=120, seed=3, **kw):
    return synthetic.strings(n, n_templates=7, seed=seed, **kw)


@pytest.mark.parametrize("q", (1, 2, 3))
@pytest.mark.parametrize("s", ("", "a", "abcab", "hello world"))
def test_qgrams_match_reference(s, q):
    assert vectorize.qgrams(s, q) == jvec.qgrams(s, q)


@pytest.mark.parametrize("q, dim", ((2, 64), (3, 17)))
def test_qgram_profile_matches_reference(q, dim):
    strs = _corpus() + [""]
    got = vectorize.qgram_profile(strs, q=q, dim=dim)
    want = jvec.qgram_profile(strs, q=q, dim=dim)
    assert got.dtype == np.float32 and got.shape == (len(strs), dim)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("q", (2, 3))
def test_shingle_sets_match_reference(q):
    strs = _corpus(length=(24, 60), mutate=0.08)
    assert vectorize.shingle_sets(strs, q=q) == jvec.shingle_sets(strs, q=q)


@pytest.mark.parametrize("k, seed", ((64, 0), (7, 5), (1, 2)))
def test_minhash_matches_reference_bit_for_bit(k, seed):
    sets = vectorize.shingle_sets(_corpus(length=(24, 60)), q=3)
    sets += [set(), {0}, {2**31 - 1, 5}]  # an empty set keeps its row of 0
    got = vectorize.minhash(sets, k=k, seed=seed)
    want = jvec.minhash(sets, k=k, seed=seed)
    assert got.dtype == np.int32 and got.shape == (len(sets), k)
    assert np.array_equal(got, want)


def test_minhash_blocks_cover_every_set(monkeypatch):
    """Small hash blocks (sets split over many blocks) change no bit."""
    sets = vectorize.shingle_sets(_corpus(n=60), q=3)
    want = vectorize.minhash(sets, k=9)
    monkeypatch.setattr(vectorize, "_MINHASH_BLOCK", 40)
    assert np.array_equal(vectorize.minhash(sets, k=9), want)
    assert np.array_equal(vectorize.minhash([set()] * 3, k=4), np.zeros((3, 4), np.int32))


@pytest.mark.parametrize("a, b", (("", ""), ("kitten", "sitting"), ("abc", ""), ("flaw", "lawn")))
def test_edit_and_jaccard_distance_match_reference(a, b):
    assert vectorize.edit_distance(a, b) == jvec.edit_distance(a, b)
    sa, sb = set(vectorize.qgrams(a)), set(vectorize.qgrams(b))
    assert vectorize.jaccard_distance(sa, sb) == jvec.jaccard_distance(sa, sb)


def test_qgram_profile_filters_edit_distance():
    """L1 between hashed q-gram profiles is at most 2q times the edit
    distance (hashing only merges bins), the filter the paper relies on."""
    strs = _corpus(n=40, mutate=0.2)
    q = 2
    prof = vectorize.qgram_profile(strs, q=q, dim=64)
    for i in range(0, 40, 3):
        for j in range(1, 40, 5):
            l1 = np.abs(prof[i] - prof[j]).sum()
            assert l1 <= 2 * q * vectorize.edit_distance(strs[i], strs[j])


@pytest.mark.parametrize("seed", (0, 7))
def test_generators_match_reference(seed):
    assert np.array_equal(
        synthetic.heavy_tailed(200, 9, alpha=2.5, seed=seed),
        jsyn.heavy_tailed(200, 9, alpha=2.5, seed=seed),
    )
    got = synthetic.exponential_nodes(40, 5, 3, seed=seed)
    want = jsyn.exponential_nodes(40, 5, 3, seed=seed)
    assert len(got) == 3 and all(np.array_equal(a, b) for a, b in zip(got, want))
    kw = dict(length=(24, 60), n_templates=11, mutate=0.08, seed=seed)
    assert synthetic.strings(150, **kw) == jsyn.strings(150, **kw)
    assert synthetic.strings(50, seed=seed) == jsyn.strings(50, seed=seed)
