"""Synthetic dataset generators.

Join workloads mirror the paper's four datasets *statistically* (the real
NETFLIX/SIFT/AOL/PUBMED corpora are not shippable): per-node mixtures with
controllable skew, cluster structure and dimensionality, so every paper
claim (skew hurts random sampling, Gen/Dist fix it, ...) is reproducible
and parameterized.

The join generators of ``repro.data.synthetic``, copied (the port imports
nothing of the JAX package): the same seed gives the same arrays and
strings in both packages (the same ``np.random.default_rng`` calls in the
same order). ``token_example``, the LM token stream's examples, is
copied too: the same (seed, index) gives the same tokens in both packages.
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


def heavy_tailed(n: int, m: int, alpha: float = 2.5, seed: int = 0) -> np.ndarray:
    """Pareto-tailed magnitudes (SIFT-like heavy local density variation)."""
    rng = np.random.default_rng(seed)
    r = rng.pareto(alpha, size=(n, 1)).astype(np.float32) + 1.0
    d = rng.normal(size=(n, m)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
    return r * d


def exponential_nodes(
    n_per_node: int, m: int, n_nodes: int, seed: int = 0
) -> list[np.ndarray]:
    """Per-node exponential data with node-specific rates — the regime where
    the paper's exponential-family fit shines (high GoF confidence)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_nodes):
        lam = rng.uniform(0.5, 3.0, size=(m,))
        out.append(rng.exponential(1.0 / lam, size=(n_per_node, m)).astype(np.float32))
    return out


def strings(n: int, vocab: str = "abcdefgh", length: tuple[int, int] = (8, 24),
            n_templates: int = 32, mutate: float = 0.15, seed: int = 0) -> list[str]:
    """Near-duplicate string corpus: templates + character mutations (the
    AOL/PubMed analogue for §6.2 string-metric support)."""
    rng = np.random.default_rng(seed)
    templates = [
        "".join(rng.choice(list(vocab), size=rng.integers(*length)))
        for _ in range(n_templates)
    ]
    out = []
    for _ in range(n):
        t = list(templates[rng.integers(n_templates)])
        for j in range(len(t)):
            if rng.uniform() < mutate:
                t[j] = vocab[rng.integers(len(vocab))]
        out.append("".join(t))
    return out


def token_example(seed: int, index: int, seq_len: int, vocab: int) -> np.ndarray:
    """Pure function (seed, index) -> token sequence; basis of the resumable
    pipeline. Markov-ish stream so the LM loss has learnable structure."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    base = rng.integers(0, vocab, size=seq_len)
    # inject copy structure: second half repeats first half with noise
    half = seq_len // 2
    noise = rng.integers(0, vocab, size=half)
    keep = rng.uniform(size=half) < 0.8
    base[half : half + half] = np.where(keep, base[:half], noise)[: seq_len - half]
    return base.astype(np.int32)
