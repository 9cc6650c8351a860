"""Shared neural layers: norms, RoPE, linear/MLP blocks (pure functions).

Convention: every layer is a pair (``<name>_defs(cfg) -> ParamDef tree``,
``<name>(params, x, ...) -> y``), as in ``repro.models.layers``. Computation
runs in ``cfg.act_dtype`` (bf16 by default) with fp32 norms/softmax — the
long-reduction rule. Weights are cast to the activation dtype at each use,
as the reference does; the cast is a no-op for weights already held in it
(``transformer.Transformer`` casts them once).

Under a split (``collectives.model_split``: the mesh step under "tp") the
MLP and the vocabulary are split over "model" where the rules shard them:
the MLP by column (``gate``/``up``) and row (``down``) between a
``copy_to`` and a ``reduce_sum``, the embedding by vocabulary row (a token
outside the rank's rows reads zeros, then ``reduce_sum``), and the
unembedding gives this rank's vocabulary columns of the logits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import collectives
from repro_torch.models.base import pdef

Tensor = torch.Tensor


def act_dt(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.act_dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_defs(d: int) -> dict:
    return {"scale": pdef((d,), (None,), init="ones")}


def rmsnorm(params: dict, x: Tensor, eps: float = 1e-6, sp=None) -> Tensor:
    """RMSNorm over the last dim. ``sp`` (a ``collectives.Split`` that
    shards that dim): ``x`` holds this rank's columns of it, the mean of
    squares is the ranks' partial means (each weighted by its share of the
    dim) summed over "model" (one all-reduce; its gradient summed back,
    each rank normalising its own columns), and the scale is its columns
    of the whole leaf. On one rank the whole norm, bit for bit."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    scale = params["scale"]
    if sp is not None:
        full = scale.shape[-1]
        var = collectives.reduce_sum(var * (x.shape[-1] / full), sp.groups, partial=True)
        scale = sp.block(collectives.copy_to(scale, sp.groups), 0, full)
    y = xf * torch.rsqrt(var + eps) * scale.float()
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


def mlp(params: dict, x: Tensor, kind: str = "swiglu", d_ff: int | None = None) -> Tensor:
    """The (Swi)GLU MLP. ``d_ff``: its hidden width, given where the MLP
    may run split (the mesh step's blocks): under a split that shards it,
    each rank computes its columns and rows and the partial outputs are
    summed over "model" (``mlp_share``)."""
    sp = collectives.model_split() if d_ff else None
    if sp is None or not sp.splits(d_ff):
        return mlp_share(params, x, kind)
    y = mlp_share(params, collectives.copy_to(x, sp.groups), kind, sp, d_ff)
    return row_bias(params["down"], collectives.reduce_sum(y, sp.groups))


def gathered_linear(x: Tensor, w: Tensor, b: Tensor | None, full: int, sp) -> Tensor:
    """``x @ w (+ b)`` whole along its ``full`` output columns inside this
    rank's share (``sp``): projected on the rank's columns and gathered
    along "model" (``collectives.gather_last``, partial) where "model"
    splits them, else on the whole leaf, its gradient summed over "model".
    For a projection whose column blocks do not line up with what the
    rank computes next (Mamba2's z | x | B | C | dt, sLSTM's gates where
    the heads do not divide "model")."""
    if not sp.splits(full):
        w = collectives.copy_to(w, sp.groups)
        b = None if b is None else collectives.copy_to(b, sp.groups)
    y = x @ sp.block(w, w.dim() - 1, full).to(x.dtype)
    if b is not None:
        y = y + sp.block(b, 0, full).to(x.dtype)
    return collectives.gather_last(y, sp.group) if sp.splits(full) else y


def row_bias(params: dict, y: Tensor) -> Tensor:
    """``y`` plus a row-split linear's bias, where it has one: added once,
    after the sum over "model"."""
    return y + params["b"].to(y.dtype) if "b" in params else y


def mlp_share(params: dict, x: Tensor, kind: str = "swiglu", sp=None, d_ff: int = 0) -> Tensor:
    """This rank's share of the MLP (``sp``: a ``collectives.Split`` that
    shards ``d_ff``): ``gate``/``up`` (and their biases) on its columns,
    ``down`` on its rows without its bias (``row_bias``, after the sum):
    the partial output before the sum over "model". Without ``sp`` the
    whole MLP."""
    def cols(p: dict) -> dict:
        return p if sp is None else {k: sp.block(v, v.dim() - 1, d_ff) for k, v in p.items()}

    def rows(p: dict) -> dict:
        return p if sp is None else {"w": sp.block(p["w"], 0, d_ff)}

    if kind == "swiglu":
        g = linear(cols(params["gate"]), x)
        u = linear(cols(params["up"]), x)
        return linear(rows(params["down"]), F.silu(g) * u)
    # jax.nn.gelu defaults to the tanh approximation
    return linear(rows(params["down"]), F.gelu(linear(cols(params["up"]), x), approximate="tanh"))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(cfg) -> dict:
    out = {"tokens": pdef((cfg.vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["unembed"] = pdef((cfg.d_model, cfg.vocab), ("embed", "vocab"), init="scaled")
    return out


def vocab_split(cfg):
    """The split in force when it shards the vocabulary, else None."""
    sp = collectives.model_split()
    return sp if sp is not None and sp.splits(cfg.vocab) else None


def embed(params: dict, tokens: Tensor, cfg) -> Tensor:
    sp = vocab_split(cfg)
    if sp is None:
        return params["tokens"].to(act_dt(cfg))[tokens]
    return collectives.reduce_sum(embed_share(params, tokens, cfg, sp), sp.groups)


def embed_share(params: dict, tokens: Tensor, cfg, sp) -> Tensor:
    """This rank's share of the embedding (``sp`` splits the vocabulary):
    its rows of ``tokens`` looked up, zeros for the tokens it does not own."""
    lo, hi = sp.span(cfg.vocab)
    local = tokens - lo
    inside = (local >= 0) & (local < hi - lo)
    rows = sp.block(params["tokens"], 0, cfg.vocab).to(act_dt(cfg))[torch.where(inside, local, 0)]
    return rows.masked_fill(~inside[..., None], 0)


def unembed(params: dict, x: Tensor, cfg) -> Tensor:
    """Logits (..., vocab); under a split that shards the vocabulary this
    rank's columns of them (..., vocab / m), ``vocab_split``'s span."""
    sp = vocab_split(cfg)
    if cfg.tie_embeddings:
        w = params["tokens"] if sp is None else sp.block(params["tokens"], 0, cfg.vocab)
        w = w.to(x.dtype).T
    else:
        w = params["unembed"] if sp is None else sp.block(params["unembed"], 1, cfg.vocab)
        w = w.to(x.dtype)
    if sp is not None:
        x = collectives.copy_to(x, sp.groups)
    logits = x @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits.float() / c).to(logits.dtype)
    return logits
