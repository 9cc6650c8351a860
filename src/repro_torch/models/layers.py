"""Shared neural layers: norms, RoPE, linear/MLP blocks (pure functions).

Convention: every layer is a pair (``<name>_defs(cfg) -> ParamDef tree``,
``<name>(params, x, ...) -> y``), as in ``repro.models.layers``. Computation
runs in ``cfg.act_dtype`` (bf16 by default) with fp32 norms/softmax — the
long-reduction rule. Weights are cast to the activation dtype at each use,
as the reference does; the cast is a no-op for weights already held in it
(``transformer.Transformer`` casts them once).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.base import pdef

Tensor = torch.Tensor


def act_dt(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.act_dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_defs(d: int) -> dict:
    return {"scale": pdef((d,), (None,), init="ones")}


def rmsnorm(params: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: Tensor, positions: Tensor, theta: float = 10_000.0) -> Tensor:
    """Rotary embedding. x: (..., S, n_heads, head_dim), positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[..., None] * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Linear / MLP
# ---------------------------------------------------------------------------


def linear_defs(d_in: int, d_out: int, axes=("embed", "mlp"), bias=False) -> dict:
    out = {"w": pdef((d_in, d_out), axes, init="scaled")}
    if bias:
        out["b"] = pdef((d_out,), (axes[1],), init="zeros")
    return out


def linear(params: dict, x: Tensor) -> Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def mlp_defs(cfg, d_ff: int | None = None) -> dict:
    d, dff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {
            "gate": linear_defs(d, dff, ("embed", "mlp")),
            "up": linear_defs(d, dff, ("embed", "mlp")),
            "down": linear_defs(dff, d, ("mlp", "embed")),
        }
    return {
        "up": linear_defs(d, dff, ("embed", "mlp")),
        "down": linear_defs(dff, d, ("mlp", "embed")),
    }


def mlp(params: dict, x: Tensor, kind: str = "swiglu") -> Tensor:
    if kind == "swiglu":
        g = linear(params["gate"], x)
        u = linear(params["up"], x)
        return linear(params["down"], F.silu(g) * u)
    # jax.nn.gelu defaults to the tanh approximation
    return linear(params["down"], F.gelu(linear(params["up"], x), approximate="tanh"))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(cfg) -> dict:
    out = {"tokens": pdef((cfg.vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["unembed"] = pdef((cfg.d_model, cfg.vocab), ("embed", "vocab"), init="scaled")
    return out


def embed(params: dict, tokens: Tensor, cfg) -> Tensor:
    return params["tokens"].to(act_dt(cfg))[tokens]


def unembed(params: dict, x: Tensor, cfg) -> Tensor:
    if cfg.tie_embeddings:
        w = params["tokens"].to(x.dtype).T
    else:
        w = params["unembed"].to(x.dtype)
    logits = x @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits.float() / c).to(logits.dtype)
    return logits
