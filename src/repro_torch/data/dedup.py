"""SP-Join-powered semantic dedup (port of ``repro.data.dedup``).

dedup(vectors, delta) = similarity self-join -> connected components of the
pair graph (union-find) -> keep the lowest-index representative per
component. The join is ``spjoin.join`` (generative sampling + learning
partition by default), on the card unless the caller passes
``device="cpu"``: its map phase runs the map-assign kernel and its verify
phase the filtered pairdist kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import spjoin


@dataclasses.dataclass
class DedupResult:
    keep_mask: np.ndarray  # (n,) bool
    n_components: int
    n_duplicates: int
    pairs: np.ndarray


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, a: int) -> int:
        p = self.parent
        while p[a] != a:
            p[a] = p[p[a]]
            a = p[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)  # keep lowest index as root


def dedup(
    vectors,
    delta: float,
    metric: str = "l2",
    cfg: spjoin.JoinConfig | None = None,
    *,
    device: torch.device | str = "cuda",
) -> DedupResult:
    """Near-duplicate removal over ``vectors`` (n, m): rows joined within
    ``delta`` form components; ``keep_mask`` keeps each component's
    lowest index. ``cfg`` defaults to the reference's (k = min(512,
    max(n // 4, 16)), p = 8, n_dims = min(8, m))."""
    n = vectors.shape[0]
    cfg = cfg or spjoin.JoinConfig(
        delta=delta, metric=metric, k=min(512, max(n // 4, 16)),
        p=8, n_dims=min(8, vectors.shape[1]),
    )
    res = spjoin.join(vectors, cfg, device=device)
    uf = _UnionFind(n)
    for i, j in res.pairs.tolist():
        uf.union(i, j)
    roots = np.array([uf.find(i) for i in range(n)])
    keep = roots == np.arange(n)
    return DedupResult(
        keep_mask=keep,
        n_components=int(keep.sum()),
        n_duplicates=int(n - keep.sum()),
        pairs=res.pairs,
    )
