"""Deterministic row stream for the incremental join layer.

``StreamSource`` of ``repro.data.pipeline``, copied (the port imports
nothing of the JAX package; it is numpy, as in the reference): row ``i`` is
a pure function of ``(seed, i)``, so the same seed gives the same rows in
both packages and under any split into insertion batches. The LM token
pipeline of that module belongs to the LM stack and is not ported.
"""
from __future__ import annotations

import numpy as np


class StreamSource:
    """Deterministic row stream feeding ``spjoin.join_incremental`` /
    ``MetricIndex.insert_batch``.

    Row ``i`` is ``np.random.SeedSequence([seed, i])``'s draw, so the
    GLOBAL row sequence is independent of how it is chopped into insertion
    batches — what makes "the same pairs under ANY batch split" a
    well-posed claim. ``dist``: "normal" | "uniform" | "clustered" (rows
    around ``n_clusters`` fixed centers, a function of the seed alone).
    """

    def __init__(
        self,
        n_features: int,
        seed: int = 0,
        dist: str = "normal",
        n_clusters: int = 4,
        scale: float = 1.0,
    ):
        if dist not in ("normal", "uniform", "clustered"):
            raise ValueError(f"unknown stream dist {dist!r}")
        self.n_features = n_features
        self.seed = seed
        self.dist = dist
        self.scale = scale
        # Cluster centers use the reserved row index 2**62.
        if dist == "clustered":
            rng = np.random.default_rng(np.random.SeedSequence([seed, 2**62]))
            self.centers = rng.normal(size=(n_clusters, n_features)).astype(
                np.float32
            ) * np.float32(3.0 * scale)
        else:
            self.centers = None

    def row(self, i: int) -> np.ndarray:
        """Row ``i`` of the global stream — pure in (seed, i)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, int(i)]))
        if self.dist == "uniform":
            x = rng.uniform(-1.0, 1.0, size=self.n_features) * self.scale
        elif self.dist == "clustered":
            c = self.centers[int(rng.integers(self.centers.shape[0]))]
            x = c + rng.normal(size=self.n_features) * (0.3 * self.scale)
        else:
            x = rng.normal(size=self.n_features) * self.scale
        return x.astype(np.float32)

    def prefix(self, n: int) -> np.ndarray:
        """The first ``n`` rows as one (n, m) array."""
        return self.batch(0, n)

    def batch(self, start: int, size: int) -> np.ndarray:
        """Rows [start, start + size) — one insertion batch."""
        if size == 0:
            return np.zeros((0, self.n_features), np.float32)
        return np.stack([self.row(i) for i in range(start, start + size)])
