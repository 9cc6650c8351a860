"""Mixture-of-Experts FFN with capacity-bounded dispatch.

The port of ``repro.models.moe``'s single-card path. Tokens are processed
in groups of ~``group_size``; in each group the router picks every token's
top-k experts, each (token, choice) assignment takes the next slot of its
expert's static capacity C (a running count over the group, token-major),
assignments past C are dropped, and every expert runs its SwiGLU FFN over
its (B, C, d) slice of the dispatch buffer — skew costs padding, not
stragglers. Both llama4-scout (16e top-1 + shared) and deepseek-moe (64e
top-6 + 2 shared, fine-grained) are instances of this one module.

The reference's expert-parallel path (``_dispatch_group_ep`` and
``moe_block``'s mesh branch: experts sharded over a "model" axis, one psum
to combine) has no single-card meaning; it is ported with the mesh tooling
(ROADMAP §1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.base import pdef

Tensor = torch.Tensor


def moe_defs(cfg) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    out = {
        "router": pdef((d, E), ("embed", None), init="scaled"),
        "gate": pdef((E, d, f), ("experts", "embed", "mlp"), init="scaled"),
        "up": pdef((E, d, f), ("experts", "embed", "mlp"), init="scaled"),
        "down": pdef((E, f, d), ("experts", "mlp", "embed"), init="scaled"),
    }
    if cfg.n_shared_experts:
        out["shared"] = layers.mlp_defs(cfg, cfg.n_shared_experts * cfg.d_ff_expert)
    return out


def _capacity(gs: int, cfg) -> int:
    c = math.ceil(gs * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(math.ceil(c / 8) * 8, 8)


def top_k(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The k largest entries of the last axis, ties to the lower index
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none). Router
    logits are computed in the activation dtype, so at bf16 ties among the
    experts are common."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def _dispatch_group(params, xg: Tensor, cfg) -> tuple[Tensor, Tensor]:
    """One token group. xg: (B, gs, d) -> (y (B, gs, d), aux_loss scalar)."""
    B, gs, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(gs, cfg)

    logits = (xg @ params["router"].to(xg.dtype)).float()  # (B, gs, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, k)  # (B, gs, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)  # renormalize top-k

    # Switch-style load-balance loss: E * sum_e f_e * P_e.
    me = probs.mean((0, 1))
    ce = F.one_hot(idx, E).float().sum(2).mean((0, 1))
    aux = E * (me * ce).sum()

    # ---- rank of each (token, choice) within its expert ------------------
    flat_e = idx.reshape(B, gs * k)  # (B, T') expert id per assignment
    rank = torch.cumsum(F.one_hot(flat_e, E), dim=1) - 1  # (B, T', E)
    rank_of = rank.gather(2, flat_e[..., None])[..., 0]  # (B, T')
    keep = rank_of < C  # dropped assignments beyond capacity
    ee = torch.where(keep, flat_e, E)  # row E collects the drops, then goes
    cc = torch.clamp(rank_of, 0, C - 1)

    # ---- dispatch: each kept assignment copies its token into its slot ----
    tok = torch.arange(gs, device=xg.device).repeat_interleave(k)  # (T',)
    slot = (torch.arange(B, device=xg.device)[:, None] * (E + 1) + ee) * C + cc  # (B, T')
    buf = torch.zeros((B * (E + 1) * C, d), dtype=xg.dtype, device=xg.device)
    buf.index_add_(0, slot.reshape(-1), xg[:, tok].reshape(B * gs * k, d))
    buf = buf.view(B, E + 1, C, d)[:, :E]  # (B, E, C, d)

    # ---- expert FFN: one batched product per expert -----------------------
    xe = buf.transpose(0, 1).reshape(E, B * C, d)
    g = torch.bmm(xe, params["gate"].to(xe.dtype))
    u = torch.bmm(xe, params["up"].to(xe.dtype))
    o = torch.bmm(F.silu(g) * u, params["down"].to(xe.dtype))  # (E, B*C, d)
    o = o.view(E, B, C, d).transpose(0, 1)  # (B, E, C, d)

    # ---- combine: weighted sum back in token order ------------------------
    # The reference scatter-adds the k weighted rows of each token in
    # assignment order in the output dtype; summing choice by choice keeps
    # that order (and each rounding) without an atomic scatter.
    bi = torch.arange(B, device=xg.device)[:, None]
    gathered = o[bi, torch.clamp(ee, max=E - 1), cc]  # (B, T', d)
    gathered = gathered.masked_fill((ee == E)[..., None], 0)  # the dropped contribute 0
    part = (gathered * w.reshape(B, gs * k, 1).to(o.dtype)).view(B, gs, k, d)
    y = torch.zeros((B, gs, d), dtype=o.dtype, device=o.device)
    for j in range(k):
        y = y + part[:, :, j]

    if cfg.n_shared_experts:
        y = y + layers.mlp(params["shared"], xg, "swiglu")
    return y.to(xg.dtype), aux


def moe_block(params: dict, x: Tensor, cfg, group_size: int = 2048) -> tuple[Tensor, Tensor]:
    """MoE FFN over (B, S, d). Returns (y, aux_loss): the groups of
    ``min(group_size, S)`` tokens are dispatched one after another and
    their aux losses averaged."""
    B, S, d = x.shape
    gs = min(group_size, S)
    assert S % gs == 0, (S, gs)
    nG = S // gs
    if nG == 1:
        return _dispatch_group(params, x, cfg)
    xr = x.reshape(B, nG, gs, d)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for g in range(nG):
        y, a = _dispatch_group(params, xr[:, g], cfg)
        aux = aux + a
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, d), aux / nG
