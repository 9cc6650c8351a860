"""Chi-square goodness-of-fit confidence (paper §3.4: Lemma 2, Theorem 1, Eq. 10).

Per node: Pearson statistic K* over t equal-probability cells per dimension
under the fitted marginal (equal-width cells of the CDF transform u = F(x)),
K ~ χ²(t − w − 1) per dimension under H₀, and the confidence c⁰ = the
p-value P[χ²_df ≥ K*] from the regularized incomplete gamma function.

Plain PyTorch: the cell counts are a one-hot sum, as in the reference
(the histogram kernel serves only the distributed executor).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.special import gammainc

from repro_torch.core import expfam

Tensor = torch.Tensor


def chi2_cdf(x: Tensor, df: Tensor) -> Tensor:
    """CDF of χ²_df at x: P(df/2, x/2) (regularized lower incomplete gamma)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    df = torch.as_tensor(df, dtype=torch.float32, device=x.device)
    return gammainc(df / 2.0, torch.clamp(x, min=0.0) / 2.0)


def chi2_sf(x: Tensor, df: Tensor) -> Tensor:
    """Survival function 1 − CDF: the Eq. 10 confidence/p-value."""
    return 1.0 - chi2_cdf(x, df)


class GofResult(NamedTuple):
    statistic: Tensor  # K_i* — summed Pearson statistic over dims (scalar)
    dof: Tensor  # aggregated degrees of freedom
    confidence: Tensor  # c_i⁰ ∈ [0, 1]
    per_dim_statistic: Tensor  # (m,) decomposition, for diagnostics


def pearson_statistic(
    x: Tensor,
    params: expfam.FamilyParams,
    t: int = 8,
    mask: Tensor | None = None,
) -> GofResult:
    """Evaluate K* (Eq. 9) on a shard with t equal-probability cells per dim."""
    u = expfam.cdf(params, x.float())  # (n, m) in [0, 1]
    cell = torch.clamp((u * t).to(torch.int64), 0, t - 1)
    w = None if mask is None else mask.float()
    n_eff = torch.tensor(float(x.shape[0]), device=x.device) if w is None else w.sum()

    onehot = torch.nn.functional.one_hot(cell, t).float()  # (n, m, t)
    if w is not None:
        onehot = onehot * w[:, None, None]
    nu = onehot.sum(0)  # (m, t) observed counts per dim/cell

    expected = torch.clamp(n_eff / t, min=1e-9)
    per_dim = ((nu - expected) ** 2 / expected).sum(-1)  # (m,)
    k_star = per_dim.sum()

    m = x.shape[-1]
    dof = torch.tensor(max(float(m * (t - params.n_params - 1)), 1.0), device=x.device)
    conf = chi2_sf(k_star, dof)
    return GofResult(k_star, dof, conf, per_dim)


def fit_best_family(
    x: Tensor,
    t: int = 8,
    mask: Tensor | None = None,
    families: tuple[str, ...] = expfam.FAMILIES,
) -> tuple[expfam.FamilyParams, GofResult]:
    """Fit every candidate family and keep the max-confidence one; families
    whose support excludes the data self-eliminate (confidence 0)."""
    stats = expfam.suff_stats(x, mask)
    nonneg = (
        bool((x >= 0).all())
        if mask is None
        else bool(((x >= 0) | ~mask.bool()[:, None]).all())
    )
    best: tuple[expfam.FamilyParams, GofResult] | None = None
    for fam in families:
        params = expfam.fit(fam, stats)
        res = pearson_statistic(x, params, t=t, mask=mask)
        if fam in ("exponential", "gamma") and not nonneg:
            res = res._replace(confidence=torch.zeros_like(res.confidence))
        if best is None or float(res.confidence) > float(best[1].confidence):
            best = (params, res)
    assert best is not None
    return best


def global_confidence(k_stars: Tensor, dofs: Tensor) -> Tensor:
    """Theorem 2: the global statistic Σ_i K_i* is χ² with Σ_i df_i degrees
    of freedom (a sum of independent χ²); returns its confidence c̄⁰
    (Eq. 13), which is at least min_i c_i⁰."""
    return chi2_sf(torch.as_tensor(k_stars).sum(), torch.as_tensor(dofs).sum())
