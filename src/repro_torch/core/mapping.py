"""Space mapping: metric space → ℝⁿ via anchor pivots (paper §5.2).

n anchors A = {a_1..a_n} map an object o to oⁿ = (D(a_1, o), …, D(a_n, o)).
By the triangle inequality every coordinate is 1-Lipschitz, so a pair within
δ in the origin space lands within an L∞ ball of radius δ in the target
space (Lemma 4).

Anchor selection: farthest-first traversal (greedy k-center) over the
pivots by default, ``method="random"`` for the paper's uniform choice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import distances

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SpaceMap:
    """Frozen mapping: anchors (n, m) + metric name."""

    anchors: Tensor
    metric: str = "l1"

    @property
    def n_dims(self) -> int:
        return self.anchors.shape[0]

    def __call__(self, x: Tensor) -> Tensor:
        """(N, m) objects → (N, n) target-space coordinates."""
        return distances.pairwise(x, self.anchors, self.metric)


def select_anchors(
    gen: torch.Generator,
    pivots: Tensor,
    n: int,
    metric: str = "l1",
    method: str = "fft",
) -> SpaceMap:
    """Choose n anchors from the sampled pivots.

    method="fft"    — farthest-first traversal (greedy k-center, default)
    method="random" — uniform choice (the paper's A ⊂ S)

    The traversal counts metric-distinct rows (a row at ~zero distance from
    an earlier one, or a value repeat, is a twin); when fewer than n
    distinct rows exist, the residual anchors are a random fill over the
    pivots instead of copies of the first anchor.
    """
    k = pivots.shape[0]
    if n > k:
        raise ValueError(f"need n={n} anchors from only k={k} pivots")
    if method == "random":
        idx = torch.randperm(k, generator=gen)[:n]
        return SpaceMap(pivots[idx.to(pivots.device)], metric)
    if method != "fft":
        raise ValueError(f"unknown anchor method {method!r}")

    d_np = distances.pairwise(pivots, pivots, metric).cpu().numpy()  # (k, k)
    twin = np.tril(d_np <= 1e-4, -1).any(1)
    piv_np = pivots.cpu().numpy()
    _, first_of, inv = np.unique(piv_np, axis=0, return_index=True, return_inverse=True)
    twin |= first_of[inv.reshape(-1)] < np.arange(k)  # value repeats (exact, any metric)
    n_distinct = int(k - twin.sum())
    n_fft = min(n, n_distinct)
    first = int(torch.randint(0, k, (1,), generator=gen))

    # The traversal is control plane over a (k, k) host matrix: n steps.
    chosen = np.zeros(k, bool)
    chosen[first] = True
    min_dist = d_np[first].copy()
    idx = [first]
    for _ in range(n_fft - 1):
        nxt = int(np.argmax(np.where(chosen, -np.inf, min_dist)))
        chosen[nxt] = True
        min_dist = np.minimum(min_dist, d_np[nxt])
        idx.append(nxt)
    if n_fft < n:
        idx += torch.randperm(k, generator=gen)[: n - n_fft].tolist()
    return SpaceMap(pivots[torch.as_tensor(idx, device=pivots.device)], metric)


def map_shards(space_map: SpaceMap, shards: list[Tensor]) -> list[Tensor]:
    """Map a list of shards (reference executor convenience)."""
    return [space_map(s) for s in shards]


def as_numpy(space_map: SpaceMap) -> SpaceMap:
    """A host copy of the map: its anchors as a CPU tensor (``.numpy()``
    gives the array without a copy), so it maps CPU rows."""
    return SpaceMap(space_map.anchors.detach().cpu(), space_map.metric)
