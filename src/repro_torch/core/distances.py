"""Metric-space distance functions (paper Def. 1 / Def. 2).

Every metric is exposed in two forms:
  dist(x, y)        — single-pair distance, x/y: (m,)
  pairwise(X, Y)    — all-pairs matrix, X: (a, m), Y: (b, m) -> (a, b)

``pairwise`` here is the plain PyTorch form (the five kernel metrics share
``kernels.ref.pairdist``); the CUDA kernels compute the same quantity
blocked and fused and are held against it.

Supported metrics:
  l1        Σ|x−y|
  l2        √Σ(x−y)²            (expansion form ‖x‖²+‖y‖²−2x·y, fp32)
  linf      max|x−y|
  cosine    1 − x·y/(‖x‖‖y‖)    (pseudo-metric: no triangle inequality)
  angular   arccos(cos_sim)/π   (a true metric on the unit sphere)
  jaccard_minhash
            1 − mean(sig_x == sig_y) over MinHash signatures
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.kernels import ref as kref

Tensor = torch.Tensor


def _l1_pairwise(x: Tensor, y: Tensor) -> Tensor:
    return kref.pairdist(x, y, "l1")


def _l2_pairwise(x: Tensor, y: Tensor) -> Tensor:
    return kref.pairdist(x, y, "l2")


def _linf_pairwise(x: Tensor, y: Tensor) -> Tensor:
    return kref.pairdist(x, y, "linf")


def _cosine_pairwise(x: Tensor, y: Tensor) -> Tensor:
    return kref.pairdist(x, y, "cosine")


def _angular_pairwise(x: Tensor, y: Tensor) -> Tensor:
    cos = 1.0 - _cosine_pairwise(x, y)
    return torch.arccos(torch.clamp(cos, -1.0, 1.0)) / math.pi


def _jaccard_minhash_pairwise(x: Tensor, y: Tensor) -> Tensor:
    # x, y are integer MinHash signatures; distance = 1 − estimated Jaccard sim.
    eq = (x[..., :, None, :] == y[..., None, :, :]).float()
    return 1.0 - eq.mean(-1)


@dataclasses.dataclass(frozen=True)
class Metric:
    """A metric-space distance (Def. 1): the function plus metadata.

    ``mxu_friendly`` marks metrics whose pairwise form reduces to a matrix
    product (the flag keeps the reference's name). ``true_metric`` is False
    for pseudo-metrics (the pivot filter needs the triangle inequality).
    ``discrete`` marks equality-based metrics (MinHash), meaningful only on
    the data's integer support.
    """

    name: str
    pairwise: Callable[[Tensor, Tensor], Tensor]
    mxu_friendly: bool = False
    true_metric: bool = True
    discrete: bool = False

    def dist(self, x: Tensor, y: Tensor) -> Tensor:
        return self.pairwise(x[None, :], y[None, :])[0, 0]


METRICS: dict[str, Metric] = {
    "l1": Metric("l1", _l1_pairwise),
    "l2": Metric("l2", _l2_pairwise, mxu_friendly=True),
    "linf": Metric("linf", _linf_pairwise),
    "cosine": Metric("cosine", _cosine_pairwise, mxu_friendly=True, true_metric=False),
    "angular": Metric("angular", _angular_pairwise, mxu_friendly=True),
    "jaccard_minhash": Metric("jaccard_minhash", _jaccard_minhash_pairwise, discrete=True),
}


def get_metric(name: str) -> Metric:
    try:
        return METRICS[name]
    except KeyError:
        raise ValueError(f"unknown metric {name!r}; have {sorted(METRICS)}") from None


def pairwise(x: Tensor, y: Tensor, metric: str = "l1") -> Tensor:
    """All-pairs distance matrix (plain implementation)."""
    return get_metric(metric).pairwise(x, y)


def brute_force_join(x, *args, **kwargs) -> Tensor:
    """Oracle join — ground truth for tests and benchmarks (quadratic),
    with the reference's two call forms, overloaded on whether the second
    argument is a set:

      brute_force_join(x, delta[, metric])
          self-join: bool (n, n) tensor, True where D(o_i, o_j) ≤ δ, i < j.
      brute_force_join(r, s, delta[, metric])
          cross R×S join: bool (n_r, n_s) tensor, True where
          D(r_i, s_j) ≤ δ — no triangular de-dup.

    ``s``, ``delta`` and ``metric`` may also be passed by keyword; the
    reference's ``TypeError``s are raised for the same misuses. The plain
    distance runs on ``x``'s device (a numpy array is a CPU tensor).
    """
    y = kwargs.pop("s", None)
    delta = kwargs.pop("delta", None)
    metric = kwargs.pop("metric", None)
    if kwargs:
        raise TypeError(f"unexpected keyword arguments {sorted(kwargs)}")
    pos = list(args)
    # Cross form iff the second positional is a set — always (n, m); scalars
    # (and anything else) route to delta, so a stray 0-d array can't misroute.
    if pos and getattr(pos[0], "ndim", 0) == 2:
        if y is not None:
            raise TypeError("brute_force_join got multiple values for s")
        y = pos.pop(0)
    if pos:
        if delta is not None:
            raise TypeError("brute_force_join got multiple values for delta")
        delta = pos.pop(0)
    if pos:
        if metric is not None:
            raise TypeError("brute_force_join got multiple values for metric")
        metric = pos.pop(0)
    if pos:
        raise TypeError("too many positional arguments")
    if delta is None:
        raise TypeError("brute_force_join requires a delta threshold")
    metric = metric or "l1"
    x = torch.as_tensor(x)
    if y is None:
        n = x.shape[0]
        upper = torch.ones((n, n), dtype=torch.bool, device=x.device).triu_(1)
        return (pairwise(x, x, metric) <= float(delta)) & upper
    y = torch.as_tensor(y).to(x.device)
    if x.shape[0] == 0 or y.shape[0] == 0:
        return torch.zeros((x.shape[0], y.shape[0]), dtype=torch.bool, device=x.device)
    return pairwise(x, y, metric) <= float(delta)
