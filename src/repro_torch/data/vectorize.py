"""String/set -> vector transforms (paper §6.2).

The transforms of ``repro.data.vectorize``, copied (the port imports
nothing of the JAX package; the module is numpy, as in the reference):

  qgram_profile   string -> hashed q-gram count vector; L1 distance on
                  profiles lower-bounds 2q * edit distance (the classic
                  q-gram filter), so a join at delta' = 2*q*delta is a
                  complete candidate filter for EDIT <= delta.
  minhash         set -> k-permutation MinHash signature; the fraction of
                  unequal entries estimates the Jaccard distance (metric
                  "jaccard_minhash").

``qgram_profile`` and ``shingle_sets`` hash q-grams with Python's
``hash()`` on ``str``, which is salted per process (``PYTHONHASHSEED``):
their output is a function of the strings AND the process, so two
processes agree only under the same fixed salt. Compare them only within
one process.
"""
from __future__ import annotations

import numpy as np

_P1 = np.uint64(11400714819323198485)
_P2 = np.uint64(14029467366897019727)
_MINHASH_BLOCK = 1 << 22  # set elements hashed against all k seeds per block


def _hash64(x: np.ndarray, seed) -> np.ndarray:
    """The reference's 64-bit mixer (wrapping uint64 arithmetic); ``seed``
    broadcasts against ``x``."""
    h = x.astype(np.uint64) * _P1 + seed
    h ^= h >> np.uint64(33)
    h *= _P2
    h ^= h >> np.uint64(29)
    return h


def qgrams(s: str, q: int = 2) -> list[str]:
    padded = ("#" * (q - 1)) + s + ("#" * (q - 1))
    return [padded[i : i + q] for i in range(len(padded) - q + 1)]


def qgram_profile(strings: list[str], q: int = 2, dim: int = 64) -> np.ndarray:
    """Hashed q-gram count vectors (n, dim) float32; L1 on these is the
    q-gram distance (complete filter for edit distance). Bins come from
    ``hash()``: the result depends on the process's hash salt."""
    out = np.zeros((len(strings), dim), np.float32)
    for i, s in enumerate(strings):
        for g in qgrams(s, q):
            out[i, hash(g) % dim] += 1.0
    return out


def shingle_sets(strings: list[str], q: int = 3) -> list[set[int]]:
    """Each string's set of hashed q-gram shingles (31-bit ints). Like
    :func:`qgram_profile`, the values depend on the process's hash salt."""
    return [set(hash(g) & 0x7FFFFFFF for g in qgrams(s, q)) for s in strings]


def minhash(sets: list[set[int]], k: int = 64, seed: int = 0) -> np.ndarray:
    """(n, k) int32 MinHash signatures; mean(sig_a != sig_b) estimates the
    Jaccard distance. Bit for bit the reference's signatures: the same k
    seeds from ``np.random.default_rng(seed)`` and the same ``_hash64``,
    evaluated over blocks of (set element x seed) at once instead of one
    call per (set, seed); an empty set's row stays 0."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(1, 2**63 - 1, size=k, dtype=np.uint64)
    out = np.zeros((len(sets), k), np.int32)
    sizes = np.fromiter((len(s) for s in sets), np.int64, len(sets))
    rows = np.flatnonzero(sizes)
    if rows.size == 0 or k == 0:
        return out
    # Set iteration order does not matter: the minimum is order-free.
    elems = np.fromiter(
        (e for i in rows for e in sets[i]), np.uint64, int(sizes[rows].sum())
    )
    starts = np.concatenate([[0], np.cumsum(sizes[rows])[:-1]])
    mask = np.uint64(0x7FFFFFFF)
    per_block = max(1, _MINHASH_BLOCK // k)
    r0 = 0
    while r0 < rows.size:
        # Whole sets per block, about per_block elements each.
        e0 = starts[r0]
        r1 = int(np.searchsorted(starts, e0 + per_block, "right"))
        r1 = max(r1, r0 + 1)
        e1 = starts[r1] if r1 < rows.size else elems.size
        h = _hash64(elems[e0:e1, None], seeds[None, :])  # (elements, k)
        mins = np.minimum.reduceat(h, starts[r0:r1] - e0, axis=0)
        out[rows[r0:r1]] = (mins & mask).astype(np.int32)
        r0 = r1
    return out


def edit_distance(a: str, b: str) -> int:
    """Reference DP edit distance (the tests check the q-gram filter bound)."""
    la, lb = len(a), len(b)
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(
                prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1])
            )
        prev = cur
    return prev[lb]


def jaccard_distance(a: set, b: set) -> float:
    if not a and not b:
        return 0.0
    return 1.0 - len(a & b) / len(a | b)
