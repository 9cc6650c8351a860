"""Sampling algorithms (paper §4): the error-bounded pivot selection.

  random_sample            — the prior-work baseline (uniform, no replacement)
  distribution_aware       — Alg. 2: per-node stratified sampling with Eq. 11
                             allocation and confidence-based rejection
  generative               — Alg. 3/4: Gibbs chain over (E, C, X) built from
                             the per-node (family, η, c⁰, N)

plus the supporting theory (``allocate_samples`` — Eq. 11,
``required_sample_size`` — Theorem 3 inverted, ``sampling_error`` — Def. 4,
``error_bound_probability`` — Theorem 3 forward). ``gibbs_chain_numpy`` is
the paper's exact Alg. 4 loop on the host, kept as the reference for the
chain's distribution.

Randomness comes from an explicit ``torch.Generator``; it cannot reproduce
``jax.random`` streams, so the samplers are held to the reference at the
level of distributions, not draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import expfam

Tensor = torch.Tensor


def error_bound_probability(k: int, epsilon: float, m: int) -> float:
    """P[D_k ≥ ε] < 2m·exp(−2kε²) (Theorem 3)."""
    return float(2.0 * m * np.exp(-2.0 * k * epsilon**2))


def required_sample_size(epsilon: float, fail_prob: float, m: int) -> int:
    """Smallest k ≥ 1 with 2m·exp(−2kε²) ≤ fail_prob (clamped to 1 when the
    bound is vacuous)."""
    k = int(np.ceil(np.log(2.0 * m / fail_prob) / (2.0 * epsilon**2)))
    return max(k, 1)


def sampling_error(samples: Tensor, reference: Tensor) -> Tensor:
    """Def. 4: max over dims of the marginal KS distance between the
    sample's empirical CDF and ``reference``'s."""
    s = torch.sort(samples.float(), dim=0).values  # (k, m)
    r = torch.sort(reference.float(), dim=0).values  # (n, m)
    k = s.shape[0]
    pos = torch.searchsorted(r.T.contiguous(), s.T.contiguous()).T  # (k, m)
    ref_cdf = pos.float() / r.shape[0]
    emp_lo = torch.arange(k, dtype=torch.float32, device=s.device)[:, None] / k
    emp_hi = (torch.arange(k, dtype=torch.float32, device=s.device)[:, None] + 1.0) / k
    dks = torch.maximum((ref_cdf - emp_lo).abs(), (ref_cdf - emp_hi).abs())
    return dks.max()


def allocate_samples(n_i: np.ndarray, conf_i: np.ndarray, k: int) -> np.ndarray:
    """Per-node sample counts  k_i = k · (N_i/c_i⁰) / Σ_j (N_j/c_j⁰)  (Eq. 11),
    rounded by largest remainder so Σ k_i == k exactly.

    Lower confidence ⇒ *more* samples from that node (the paper's intuition:
    we know less about it, so spend budget learning it).

    Quotas are capped at the node population, k_i ≤ N_i: a node cannot
    contribute more real objects than it holds, and an uncapped quota would
    make the local sampler silently truncate (returning < k pivots overall).
    Capped surplus is redistributed over the remaining nodes by the same
    largest-remainder rule until k is placed (or every node is full, when
    k > Σ N_i — the sampler then returns the whole population).
    """
    pop = np.asarray(n_i, np.int64)
    weights = np.asarray(n_i, np.float64) / np.clip(
        np.asarray(conf_i, np.float64), 1e-6, None
    )
    alloc = np.zeros(pop.shape, np.int64)
    k_left = int(min(k, pop.sum()))
    while k_left > 0:
        room = pop - alloc
        w = np.where(room > 0, weights, 0.0)
        if w.sum() <= 0:
            break
        shares = k_left * w / w.sum()
        give = np.floor(shares).astype(np.int64)
        rem = k_left - int(give.sum())
        if rem > 0:
            order = np.argsort(-(shares - give))
            give[order[:rem]] += 1
        give = np.minimum(give, room)
        alloc += give
        k_left -= int(give.sum())
    return alloc


def random_sample(gen: torch.Generator, x: Tensor, k: int) -> Tensor:
    """Uniform sampling without replacement (k clamped to the population)."""
    k = min(k, x.shape[0])
    idx = torch.randperm(x.shape[0], generator=gen)[:k]
    return x[idx.to(x.device)]


def stratified_local_sample(
    gen: torch.Generator,
    x: Tensor,
    params: expfam.FamilyParams,
    confidence: float,
    lc: int,
) -> Tensor:
    """Alg. 2 lines 3–7 on one node: ⌊√lc⌋ equal-probability strata of the
    first marginal's CDF u = F_1(x_1), lc·P{X∈B_j} draws from each,
    rejecting each draw with probability 1 − c_i⁰ (a rejected row's
    priority is demoted, which is resampling from the rest of its stratum).
    Underfull strata return their surplus to the best leftover rows, so
    exactly lc real rows come back."""
    n = x.shape[0]
    dev = x.device
    n_strata = max(int(np.floor(np.sqrt(max(lc, 1)))), 1)
    u = expfam.cdf(params, x.float())[:, 0]
    stratum = torch.clamp((u * n_strata).to(torch.int64), 0, n_strata - 1)

    quota = np.full((n_strata,), lc // n_strata, np.int64)
    quota[: lc - int(quota.sum())] += 1

    accept = (torch.rand(n, generator=gen) < confidence).to(dev)
    gumbel = -torch.log(-torch.log(torch.rand(n, generator=gen).clamp_(1e-20, 1.0)))
    priority = torch.where(accept, gumbel.to(dev), gumbel.to(dev) - 1e6)

    # Rank rows within their stratum by priority (descending): two stable
    # sorts make the lexicographic (stratum asc, priority desc) order.
    order = torch.argsort(-priority, stable=True)
    order = order[torch.argsort(stratum[order], stable=True)]
    sorted_stratum = stratum[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_stratum[1:] != sorted_stratum[:-1]
    ar = torch.arange(n, device=dev)
    start = torch.cummax(torch.where(first, ar, -1), 0).values
    take = (ar - start) < torch.as_tensor(quota, device=dev)[sorted_stratum]

    # Exactly-lc selection: quota rows first, then the best leftovers.
    final = torch.argsort(-priority[order], stable=True)
    final = final[torch.argsort((~take[final]).to(torch.int8), stable=True)]
    return x[order[final[:lc]]]


class NodeStats(NamedTuple):
    """What each node broadcasts (Alg. 1 line 5): ⟨F_i(x), c_i⁰, N_i⟩."""

    family: str
    params: expfam.FamilyParams
    confidence: float
    count: int


def distribution_aware_sample(
    gen: torch.Generator,
    shards: Sequence[Tensor],
    node_stats: Sequence[NodeStats],
    k: int,
    allocation: str = "eq11",
) -> Tensor:
    """Alg. 2 end to end over explicit shards; ``allocation="proportional"``
    allocates k_i ∝ N_i instead of Eq. 11."""
    n_i = np.array([s.count for s in node_stats])
    c_i = np.array([s.confidence for s in node_stats])
    lcs = allocate_samples(n_i, np.ones_like(c_i) if allocation == "proportional" else c_i, k)
    out = [
        stratified_local_sample(gen, shard, st.params, st.confidence, int(lcs[i]))
        for i, (shard, st) in enumerate(zip(shards, node_stats))
        if lcs[i] > 0
    ]
    return torch.cat(out, dim=0)


@dataclasses.dataclass(frozen=True)
class GenerativeModel:
    """The broadcast global model: per-node packed params + confidence +
    size (tensors). Conditionals (Eqs. 17–19):

      p(E=i | C=c) ∝ N_i · (c_i⁰)^{−c}
      p(X | E=i)   = f_i(X)           (the node's fitted product density)
      p(C=1 | E=i) = c_i⁰
    """

    families: tuple[str, ...]  # per-node family name
    packed_params: Tensor  # (M, 2m+1) — expfam.pack per node
    confidence: Tensor  # (M,)
    counts: Tensor  # (M,)

    @property
    def n_nodes(self) -> int:
        return len(self.families)

    def node_stats(self) -> list[NodeStats]:
        """The per-node statistics the model packs, the input of
        :func:`gibbs_chain`."""
        return [
            NodeStats(
                family=fam,
                params=expfam.unpack(self.packed_params[i], fam),
                confidence=float(self.confidence[i]),
                count=int(self.counts[i]),
            )
            for i, fam in enumerate(self.families)
        ]


def gibbs_chain(
    gen: torch.Generator,
    node_stats: Sequence[NodeStats],
    k: int,
    oversample: float = 1.5,
    normalize_confidence: bool = True,
) -> tuple[Tensor, float]:
    """Alg. 4 as a fixed-length chain over the state (e, c); per step

      e ~ p(E | C=c_prev)   — categorical, weights N_i·(c_i⁰)^{−c_prev}
      x ~ p(X | E=e)        — the node's fitted product density
      c ~ p(C | E=e)        — Bernoulli(c_e⁰); x kept iff c == 1

    with acceptance run on c_i / max_j c_j (``normalize_confidence``; the
    stationary mixture is unchanged) and length L = ceil(k / c_min ·
    oversample) + 8.

    Only (e, c) carries state, so the chain is resolved on index arrays:
    both candidate e's of every step come from one inverse-CDF lookup, and
    the walk itself is a loop over host ints. Then x is drawn only for the
    k compacted steps, one batched call per node (x is independent of
    everything but its step's e). Returns (samples (k, m), acceptance rate).
    Shortfall slots repeat the first accepted row; a chain that accepts
    nothing returns its first k raw draws (acceptance 0.0 is the caller's
    cue to warn).
    """
    counts = torch.tensor([float(s.count) for s in node_stats], dtype=torch.float64)
    conf = torch.clamp(
        torch.tensor([s.confidence for s in node_stats], dtype=torch.float32), 1e-6, 1.0
    )
    if normalize_confidence:
        conf = conf / conf.max()
    conf = torch.clamp(conf, 1e-3, 1.0)
    c_min = float(torch.clamp(conf.min(), 0.05, 1.0))
    length = int(np.ceil(k / c_min * oversample)) + 8

    return _gibbs_draws(gen, counts, conf, length, k, [st.params for st in node_stats])


def _compact_accepted(accepted: np.ndarray, k: int) -> np.ndarray:
    """Chain steps (k,) of the first k accepted draws, in chain order.

    Shortfall tail slots repeat the FIRST ACCEPTED step. If the chain
    accepted nothing at all, no accepted step exists to repeat: the first k
    raw steps are taken instead (still mixture-distributed and diverse), and
    the caller's acceptance rate of 0.0 is its cue to warn."""
    order = np.argsort(~accepted, kind="stable")
    take = order[:k]
    take = np.where(accepted[take], take, take[0])
    if not accepted.any():
        take = np.arange(k)
    return take


def _gibbs_draws(
    gen: torch.Generator,
    counts: Tensor,
    conf: Tensor,
    length: int,
    k: int,
    params: Sequence[expfam.FamilyParams],
) -> tuple[Tensor, float]:
    """The chain of :func:`gibbs_chain` over per-node float64 ``counts``
    (C=0 weights), float32 ``conf`` (acceptance, C=1 weights counts/conf)
    and fitted ``params``: walk ``length`` steps, compact the first k
    accepted ones, then draw x only for those steps, one batched call per
    node. Returns (samples (k, m), acceptance rate)."""
    w_c0 = counts  # C=0 → weights N_i
    w_c1 = counts / conf.double()  # C=1 → weights N_i / c_i
    u_e = torch.rand(length, generator=gen, dtype=torch.float64)
    u_c = torch.rand(length, generator=gen)
    last = len(params) - 1

    def draw_e(w: Tensor) -> list[int]:
        cdf = torch.cumsum(w, 0)
        return torch.clamp(torch.searchsorted(cdf, u_e * cdf[-1], right=True), max=last).tolist()

    e_if0, e_if1 = draw_e(w_c0), draw_e(w_c1)
    acc_e = (u_c[:, None] < conf[None, :]).tolist()  # accept[t][e]
    es = np.empty(length, np.int64)
    cs = np.empty(length, bool)
    c = True
    for t in range(length):
        e = e_if1[t] if c else e_if0[t]
        c = acc_e[t][e]
        es[t] = e
        cs[t] = c

    take = _compact_accepted(cs, k)
    steps, inv = np.unique(take, return_inverse=True)
    nodes = es[steps]
    m = params[0].a.shape[-1]
    dev = params[0].a.device
    xs = torch.empty((steps.size, m), dtype=torch.float32, device=dev)
    for i, pr in enumerate(params):
        rows = np.flatnonzero(nodes == i)
        if rows.size:
            xs[torch.as_tensor(rows, device=dev)] = expfam.sample(pr, gen, (rows.size,)).float()
    return xs[torch.as_tensor(inv.reshape(-1), device=dev)], float(cs.mean())


def generative_sample(
    gen: torch.Generator,
    node_stats: Sequence[NodeStats],
    k: int,
) -> tuple[Tensor, float]:
    """Alg. 3: the broadcast model (family, η, c⁰, N per node) and the Gibbs
    chain over it."""
    return gibbs_chain(gen, node_stats, k)


def gibbs_chain_numpy(
    rng: np.random.Generator,
    node_stats: Sequence[NodeStats],
    k: int,
) -> np.ndarray:
    """The exact Alg. 4 loop (dynamic length, on the host) — the reference
    the fixed-length chain is held against at the level of distributions.
    Each x is drawn by ``expfam.sample`` with a CPU ``torch.Generator``
    seeded from ``rng``."""
    counts = np.array([s.count for s in node_stats], np.float64)
    conf = np.clip(np.array([s.confidence for s in node_stats], np.float64), 1e-3, 1.0)
    out: list[np.ndarray] = []
    c_prev = 1
    guard = 0
    while len(out) < k and guard < 1000 * k:
        guard += 1
        w = counts / np.power(conf, c_prev)
        e = rng.choice(len(counts), p=w / w.sum())
        gen = torch.Generator().manual_seed(int(rng.integers(0, 2**31 - 1)))
        x = expfam.sample(node_stats[e].params, gen, ()).cpu().numpy()
        c_prev = int(rng.uniform() < conf[e])
        if c_prev == 1:
            out.append(x)
    return np.stack(out)
