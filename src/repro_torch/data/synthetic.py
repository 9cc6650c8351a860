"""Synthetic dataset generators.

Join workloads mirror the paper's four datasets *statistically* (the real
NETFLIX/SIFT/AOL/PUBMED corpora are not shippable): per-node mixtures with
controllable skew, cluster structure and dimensionality, so every paper
claim (skew hurts random sampling, Gen/Dist fix it, ...) is reproducible
and parameterized.

The join generators of ``repro.data.synthetic``, copied (the port imports
nothing of the JAX package): the same seed gives the same arrays in both
packages.
"""
from __future__ import annotations

import numpy as np


def mixture(
    n: int,
    m: int,
    n_clusters: int = 4,
    spread: float = 8.0,
    scale: float = 1.0,
    skew: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Gaussian mixture in m dims. ``skew`` in [0, 1): 0 = even cluster
    sizes; ->1 = one cluster dominates (the data-skew regime of Fig. 2)."""
    rng = np.random.default_rng(seed)
    weights = (1.0 - skew) * np.ones(n_clusters) / n_clusters
    weights[0] += skew
    weights /= weights.sum()
    counts = rng.multinomial(n, weights)
    centers = rng.normal(scale=spread, size=(n_clusters, m))
    parts = [
        rng.normal(loc=centers[c], scale=scale, size=(counts[c], m))
        for c in range(n_clusters)
    ]
    x = np.concatenate(parts).astype(np.float32)
    rng.shuffle(x)
    return x


def rs_mixture(
    n_r: int,
    n_s: int,
    m: int,
    n_clusters: int = 4,
    spread: float = 8.0,
    scale: float = 1.0,
    skew: float = 0.0,
    shift: float = 3.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Two-set R×S workload: R is a Gaussian mixture; S reuses R's cluster
    centers but translates each by an independent random direction of length
    ``shift``, reverses the skew ordering and perturbs the per-cluster scale —
    so R and S overlap enough to join, yet have genuinely different per-node
    distributions (the regime where pooled R∪S pivots matter). Typical use is
    asymmetric |R| ≪ |S| (the skew-sensitive case of the ``--rs`` benchmark).
    """
    rng = np.random.default_rng(seed)
    weights = (1.0 - skew) * np.ones(n_clusters) / n_clusters
    weights[0] += skew
    weights /= weights.sum()
    centers = rng.normal(scale=spread, size=(n_clusters, m))

    def draw(n, w, ctr, scl):
        counts = rng.multinomial(n, w)
        parts = [
            rng.normal(loc=ctr[c], scale=scl[c], size=(counts[c], m))
            for c in range(n_clusters)
        ]
        x = np.concatenate(parts).astype(np.float32)
        rng.shuffle(x)
        return x

    r = draw(n_r, weights, centers, np.full(n_clusters, scale))
    dirs = rng.normal(size=(n_clusters, m))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True) + 1e-9
    s_centers = centers + shift * dirs
    s_scales = scale * rng.uniform(0.5, 2.0, size=n_clusters)
    s = draw(n_s, weights[::-1], s_centers, s_scales)
    return r, s
