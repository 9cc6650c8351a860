"""Baseline distributed-join strategies the paper compares against (§7.3),
ported from ``repro.core.baselines``.

  ball_join   MRSimJoin/ClusterJoin-style generalized-hyperplane (Voronoi)
              partitioning with the 2-delta window replication rule:
              KERNEL cell = nearest pivot; WHOLE membership of cell h =
              D(o, p_h) <= D(o, p_nearest) + 2*delta (complete by the
              triangle inequality).
  kpm_config  KPM (Chen et al. 2017): random sampling + KD-style
              equi-depth space splitting — this framework's Random + Iter
              arm, exposed as a ``JoinConfig`` for ``spjoin.join``.

Both give the same ``JoinResult`` as ``spjoin.join``, so verifications,
cost model and pairs compare directly. ``ball_join`` runs on the card
unless the caller passes ``device="cpu"``: its pivot distances and its
verification run the plain pairdist kernel (``prune="none"``) for the
kernel metrics; a metric without a kernel (``jaccard_minhash``,
``angular``) takes the plain path, as in the reference's engine.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import cost_model, distances, sampling, spjoin
from repro_torch.core import verify as verify_lib
from repro_torch.kernels import ops as kops

def kpm_config(delta: float, metric: str = "l1", k: int = 1024, p: int = 16,
               n_dims: int = 8, seed: int = 0) -> spjoin.JoinConfig:
    """The KPM-like arm: random pivots + iterative equi-depth splits."""
    return spjoin.JoinConfig(
        delta=delta, metric=metric, sampler="random", partitioner="iterative",
        k=k, p=p, n_dims=n_dims, anchor_method="random", tighten=False, seed=seed,
    )


def ball_join(
    data,
    delta: float,
    metric: str = "l1",
    n_pivots: int = 16,
    seed: int = 0,
    return_pairs: bool = True,
    *,
    device: torch.device | str = "cuda",
) -> spjoin.JoinResult:
    """MRSimJoin-style ball (generalized-hyperplane) partitioning join.

    Pivots are drawn uniformly (the baseline's sampling) by
    ``sampling.random_sample`` on a ``torch.Generator`` seeded from
    ``seed``. Every object's KERNEL cell is its nearest pivot; it is
    replicated to every cell within the 2-delta window. Verification is
    per-cell V_h x W_h with the min-cell de-dup rule (the rule of
    ``spjoin.join``, so results are identical sets).
    """
    dev = kops.resolve_device(device)
    x = verify_lib._as_rows(data, dev)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed)
    pivots = sampling.random_sample(gen, x, min(n_pivots, x.shape[0]))
    spjoin._sync(dev)
    t_sample = time.perf_counter() - t0
    return _ball_join_with_pivots(
        x, pivots, delta, metric, return_pairs, device=dev, sample_time_s=t_sample
    )


def _ball_join_with_pivots(
    data,
    pivots,
    delta: float,
    metric: str = "l1",
    return_pairs: bool = True,
    *,
    device: torch.device | str = "cuda",
    sample_time_s: float = 0.0,
) -> spjoin.JoinResult:
    """The ball join after its sampling phase, over the given ``pivots``
    (the tests pass the reference's to hold the two joins to one plan)."""
    dev = kops.resolve_device(device)
    kops.strict_fp32()
    x = verify_lib._as_rows(data, dev)
    piv = verify_lib._as_rows(pivots, dev)

    t0 = time.perf_counter()
    if kops.supports_kernel(metric):
        d = kops.pairdist(x, piv, metric)  # (n, p); the kernel on the card
    else:
        d = distances.pairwise(x, piv, metric)
    nearest, cells = d.min(dim=1, keepdim=True)
    member = d <= nearest + 2.0 * delta  # (n, p) window rule
    cells_np = cells[:, 0].cpu().numpy()
    member_np = member.cpu().numpy()
    spjoin._sync(dev)
    t_map = time.perf_counter() - t0

    t0 = time.perf_counter()
    p = member_np.shape[1]
    v_sizes = np.bincount(cells_np, minlength=p).astype(np.int64)
    w_sizes = member_np.sum(0).astype(np.int64)
    pairs, vstats = verify_lib.verify_pairs(
        x, cells_np, member_np, delta, metric,
        config=verify_lib.EngineConfig(prune="none"), return_pairs=return_pairs,
    )
    spjoin._sync(dev)
    t_verify = time.perf_counter() - t0

    return spjoin.JoinResult(
        pairs=pairs,
        n_verifications=vstats.n_verifications,
        cost=cost_model.partition_cost(v_sizes, w_sizes),
        node_confidences=np.zeros((0,)),
        sample_time_s=sample_time_s,
        map_time_s=t_map,
        verify_time_s=t_verify,
        verify_stats=vstats,
    )
