"""Exponential-family distribution estimation (paper §3.3, Lemma 1, Table 1).

Each node's shard is modelled as i.i.d. draws from a product (per-dimension)
exponential-family distribution, fitted by closed-form MLE
η⁰ = μ⁻¹(mean of T(o_i)) (Lemma 1):

  normal       T(x) = (x, x²)    → μ, σ²       (w = 2 params / dim)
  exponential  T(x) = x          → λ           (w = 1; requires x ≥ 0)
  gamma        T(x) = (x, log x) → (α, β)      (w = 2; requires x > 0; the
                                                α equation has no closed
                                                form and is solved by Newton
                                                iterations on ψ(α))

Plain PyTorch on the tensors' device; ``torch.special`` stands in for
``jax.scipy.special``, and draws come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.special import digamma, erf, erfinv, gammainc, gammaln, polygamma

Tensor = torch.Tensor

FAMILIES = ("normal", "exponential", "gamma")


class SuffStats(NamedTuple):
    """Per-dimension sufficient statistics Σ T(o_i) plus the count. For every
    supported family T(x) ⊆ {x, x², log x}; shards combine by addition."""

    n: Tensor  # scalar, number of (weighted) observations
    sum_x: Tensor  # (m,)
    sum_x2: Tensor  # (m,)
    sum_logx: Tensor  # (m,)  computed on max(|x|, tiny) to stay finite


def suff_stats(x: Tensor, mask: Tensor | None = None) -> SuffStats:
    """One-pass sufficient statistics for an (n, m) shard; ``mask`` an
    optional (n,) validity mask."""
    x = x.float()
    if mask is None:
        n = torch.tensor(float(x.shape[0]), device=x.device)
        w = None
    else:
        w = mask.float()[:, None]
        n = w.sum()

    def _sum(v: Tensor) -> Tensor:
        return (v if w is None else v * w).sum(0)

    safe = torch.clamp(x.abs(), min=1e-20)  # log of |x| as a stand-in off-support
    return SuffStats(n=n, sum_x=_sum(x), sum_x2=_sum(x * x), sum_logx=_sum(torch.log(safe)))


def merge_stats(stats: SuffStats) -> SuffStats:
    """Combine per-shard stats stacked on a leading axis into global stats."""
    return SuffStats(*(s.sum(0) for s in stats))


@dataclasses.dataclass(frozen=True)
class FamilyParams:
    """Fitted per-dimension parameters for one family. All fields (m,)."""

    family: str
    a: Tensor  # normal: μ      exponential: λ      gamma: α (shape)
    b: Tensor  # normal: σ²     exponential: unused gamma: β (rate)

    @property
    def n_params(self) -> int:
        """w in Theorem 1 (degrees-of-freedom correction), per dimension."""
        return 1 if self.family == "exponential" else 2


def fit_normal(s: SuffStats) -> FamilyParams:
    n = torch.clamp(s.n, min=1.0)
    mu = s.sum_x / n
    var = torch.clamp(s.sum_x2 / n - mu * mu, min=1e-12)
    return FamilyParams("normal", mu, var)


def fit_exponential(s: SuffStats) -> FamilyParams:
    n = torch.clamp(s.n, min=1.0)
    mean = torch.clamp(s.sum_x / n, min=1e-12)
    lam = 1.0 / mean
    return FamilyParams("exponential", lam, torch.zeros_like(lam))


def fit_gamma(s: SuffStats, newton_iters: int = 12) -> FamilyParams:
    """Gamma MLE: solve log α − ψ(α) = log(mean x) − mean(log x) =: c by
    Newton on g(α) = log α − ψ(α) − c (monotone decreasing), from the
    Minka-style start α₀ ≈ (3−c+√((c−3)²+24c))/(12c)."""
    n = torch.clamp(s.n, min=1.0)
    mean = torch.clamp(s.sum_x / n, min=1e-12)
    mean_log = s.sum_logx / n
    c = torch.clamp(torch.log(mean) - mean_log, min=1e-8)
    alpha = (3.0 - c + torch.sqrt((c - 3.0) ** 2 + 24.0 * c)) / (12.0 * c)
    for _ in range(newton_iters):
        g = torch.log(alpha) - digamma(alpha) - c
        gp = 1.0 / alpha - polygamma(1, alpha)
        alpha = torch.clamp(alpha - g / gp, 1e-4, 1e7)
    beta = alpha / mean
    return FamilyParams("gamma", alpha, beta)


def fit(family: str, s: SuffStats) -> FamilyParams:
    if family == "normal":
        return fit_normal(s)
    if family == "exponential":
        return fit_exponential(s)
    if family == "gamma":
        return fit_gamma(s)
    raise ValueError(f"unknown family {family!r}; have {FAMILIES}")


def cdf(p: FamilyParams, x: Tensor) -> Tensor:
    """Per-dimension CDF, broadcasting x: (..., m) against params (m,)."""
    if p.family == "normal":
        z = (x - p.a) / torch.sqrt(2.0 * p.b)
        return 0.5 * (1.0 + erf(z))
    if p.family == "exponential":
        return torch.where(x > 0, 1.0 - torch.exp(-p.a * torch.clamp(x, min=0.0)), 0.0)
    if p.family == "gamma":
        a = p.a.expand_as(x)
        return torch.where(x > 0, gammainc(a, p.b * torch.clamp(x, min=1e-30)), 0.0)
    raise ValueError(p.family)


def quantile(p: FamilyParams, q: Tensor, bisect_iters: int = 60) -> Tensor:
    """Inverse CDF per dimension. Normal uses erfinv; others bisect."""
    q = torch.clamp(q, 1e-6, 1.0 - 1e-6)
    if p.family == "normal":
        return p.a + torch.sqrt(2.0 * p.b) * erfinv(2.0 * q - 1.0)
    if p.family == "exponential":
        return -torch.log1p(-q) / p.a
    hi = torch.broadcast_to((p.a + 10.0 * torch.sqrt(p.a) + 10.0) / p.b, q.shape).clone()
    lo = torch.zeros_like(q)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        below = cdf(p, mid) < q
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def sample(p: FamilyParams, gen: torch.Generator, shape: tuple[int, ...]) -> Tensor:
    """Draw samples of shape (*shape, m) from the fitted product distribution.
    The draws are made on ``gen``'s device and returned on the params'."""
    m = p.a.shape[-1]
    dev = gen.device
    a = p.a.to(dev)
    size = (*shape, m)
    if p.family == "normal":
        z = torch.randn(size, generator=gen, device=dev)
        out = a + torch.sqrt(p.b.to(dev)) * z
    elif p.family == "exponential":
        out = torch.empty(size, device=dev).exponential_(generator=gen) / a
    elif p.family == "gamma":
        alpha = torch.broadcast_to(a, size).contiguous()
        out = torch._standard_gamma(alpha, generator=gen) / p.b.to(dev)
    else:
        raise ValueError(p.family)
    return out.to(p.a.device)


def log_prob(p: FamilyParams, x: Tensor) -> Tensor:
    """Per-dimension log-density summed over dims, for diagnostics; −inf
    off the family's support."""
    if p.family == "normal":
        lp = -0.5 * ((x - p.a) ** 2 / p.b + torch.log(2.0 * math.pi * p.b))
    elif p.family == "exponential":
        lp = torch.where(x >= 0, torch.log(p.a) - p.a * x, -math.inf)
    elif p.family == "gamma":
        lp = torch.where(
            x > 0,
            p.a * torch.log(p.b) - gammaln(p.a)
            + (p.a - 1) * torch.log(torch.clamp(x, min=1e-30)) - p.b * x,
            -math.inf,
        )
    else:
        raise ValueError(p.family)
    return lp.sum(-1)


_FAMILY_ID = {name: i for i, name in enumerate(FAMILIES)}


def pack(p: FamilyParams) -> Tensor:
    """(2m + 1,) float32 vector [family_id, a..., b...] — the parameter
    packet one node broadcasts (the reference's layout)."""
    fid = torch.full((1,), float(_FAMILY_ID[p.family]), dtype=torch.float32, device=p.a.device)
    return torch.cat([fid, p.a.float(), p.b.float()])


def unpack(v: Tensor, family: str | None = None) -> FamilyParams:
    """Inverse of :func:`pack`; the family is read from ``v[0]`` unless
    given."""
    m = (v.shape[-1] - 1) // 2
    fam = family if family is not None else FAMILIES[int(v[0])]
    return FamilyParams(fam, v[1 : 1 + m], v[1 + m :])


def fit_jit(family: str, x: Tensor) -> Tensor:
    """Data → packed params in one call (the reference's name; nothing is
    compiled here: it is ``pack(fit(family, suff_stats(x)))``)."""
    return pack(fit(family, suff_stats(x)))
