"""xLSTM blocks: chunked mLSTM (matrix memory) + recurrent sLSTM.

The port of ``repro.models.xlstm``. mLSTM rides the same chunked
linear-recurrence engine as Mamba2 (``ssm.py``): state C = f*C + i*(k (x) v),
read y = q.C / max(|q.n|, eps) with the normalizer n run as an extra value
column. Gates are per-head scalars; the input gate is a sigmoid folded into
k, so every exponent stays <= 0 (the reference's simplification of the
paper's exponential gating).

sLSTM has no parallel form (true nonlinear recurrence): a loop over time
with block-diagonal per-head recurrent weights ``r``, read in fp32 as the
reference reads them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import base, collectives, layers
from repro_torch.models.base import pdef
from repro_torch.models.ssm import (
    chunked_linear_recurrence, head_rows, inner_span, linear_recurrence_step, mixer_split,
)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_defs(cfg) -> dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = cfg.n_heads
    return {
        "up_gate": pdef((d, d_in), ("embed", "mlp"), init="scaled"),
        "up": pdef((d, d_in), ("embed", "mlp"), init="scaled"),
        "wq": pdef((d_in, d_in), ("mlp", "heads"), init="scaled"),
        "wk": pdef((d_in, d_in), ("mlp", "heads"), init="scaled"),
        "wv": pdef((d_in, d_in), ("mlp", "heads"), init="scaled"),
        "w_if": pdef((d, 2 * H), ("embed", None), init="scaled"),
        "b_if": pdef((2 * H,), (None,), init="zeros"),
        "norm": layers.rmsnorm_defs(d_in),
        "down": pdef((d_in, d), ("mlp", "embed"), init="scaled"),
    }


def mlstm_block(
    params: dict,
    x: Tensor,  # (B, S, d)
    cfg,
    *,
    state: Tensor | None = None,  # (B, H, dk, dv+1) matrix memory + normalizer
) -> tuple[Tensor, Tensor]:
    """The mLSTM sub-block (no residual). Under a split that shards d_in
    (``ssm.mixer_split``) each rank computes its share (``mlstm_share``)
    and the partial outputs are summed over "model"; ``state`` is then the
    rank's share of it (``mlstm_state_init``)."""
    sp = mixer_split(cfg, collectives.model_split())
    if sp is None:
        return mlstm_share(params, x, cfg, state=state)
    y, st = mlstm_share(params, collectives.copy_to(x, sp.groups), cfg, sp, state=state)
    return collectives.reduce_sum(y, sp.groups), st


def mlstm_layout(cfg, sp) -> tuple[str, int, int, int, int]:
    """How rank ``sp`` lays out its share of the mLSTM: (mode, lo, hi, h0,
    h1), its columns [lo, hi) of d_in (its ``up``/``up_gate`` columns and
    ``wq``/``wk``/``wv``/``down`` rows) and the heads [h0, h1) they touch.
    The mode is the same on every rank (each makes the same collectives):
    "heads" where m divides H (each rank's columns are whole heads);
    "inside" where H divides m (each rank's lie inside one head: xlstm's 4
    heads on 16 ranks, a quarter of a head's value columns each);
    "straddle" otherwise (heads straddling two ranks, computed on both)."""
    H = cfg.n_heads
    d_in = cfg.ssm_expand * cfg.d_model
    lo, hi, h0, h1 = inner_span(d_in, d_in // H, sp)
    mode = "heads" if H % sp.size == 0 else ("inside" if sp.size % H == 0 else "straddle")
    return mode, lo, hi, h0, h1


def mlstm_share(params: dict, x: Tensor, cfg, sp=None, *,
                state: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """This rank's share of the mLSTM block (``sp``: a split of d_in), the
    partial output before the sum over "model"; without ``sp`` the whole
    block. q, k and v are sums over "model" of the ranks' ``u_r @ w_r``
    (its ``up`` columns, its ``wq``/``wk``/``wv`` rows). Where the rank's
    columns are whole heads (``mlstm_layout`` "heads") one reduce-scatter
    gives it its heads' q, k and v (``collectives.scatter_last``); inside
    one head q and k of that head are all-reduced and v reduce-scattered,
    so the recurrence runs on the head's whole q and k with the rank's
    value columns plus the normalizer column (each value column's state is
    its own); where heads straddle two ranks q, k and v are all-reduced
    and the straddled heads computed on both. ``w_if`` (tiny) is read
    whole. The gate, the RMSNorm (partial means, ``layers.rmsnorm`` with
    ``sp``) and ``down`` on the rank's columns. ``state``: (B, heads, dh,
    value columns + 1)."""
    B, S, d = x.shape
    H = cfg.n_heads
    d_in = cfg.ssm_expand * d
    dh = d_in // H
    mode, lo, hi, h0, h1 = ("heads", 0, d_in, 0, H) if sp is None else mlstm_layout(cfg, sp)
    nh = h1 - h0

    def cols(w: Tensor) -> Tensor:
        return w if sp is None else sp.block(w, 1, d_in)

    def rows(w: Tensor) -> Tensor:
        return w if sp is None else sp.block(w, 0, d_in)

    u = x @ cols(params["up"]).to(x.dtype)  # (B, S, d_in / m)
    gate = F.silu(x @ cols(params["up_gate"]).to(x.dtype))
    q, k, v = (u @ rows(params[w]).to(x.dtype) for w in ("wq", "wk", "wv"))
    if sp is not None:
        heads = slice(h0 * dh, h1 * dh)
        if mode == "heads":
            q, k, v = collectives.scatter_last(torch.stack([q, k, v]), sp.group).unbind(0)
        elif mode == "inside":
            qk = collectives.reduce_sum(torch.stack([q, k]), sp.groups, partial=True)
            q, k = qk[..., heads].unbind(0)
            v = collectives.scatter_last(v, sp.group)
        else:
            qkv = collectives.reduce_sum(torch.stack([q, k, v]), sp.groups, partial=True)
            q, k, v = qkv[..., heads].unbind(0)
    dv = v.shape[-1] // nh
    q = q.reshape(B, S, nh, dh)
    # the reference divides by sqrt(dh) rounded to the activation dtype
    root = float(torch.tensor(math.sqrt(dh), dtype=torch.float32).to(x.dtype))
    k = k.reshape(B, S, nh, dh) / root
    v = v.reshape(B, S, nh, dv)

    w_if, b_if = params["w_if"], params["b_if"]
    if sp is not None:
        w_if, b_if = collectives.copy_to(w_if, sp.groups), collectives.copy_to(b_if, sp.groups)
    if_pre = (x @ w_if.to(x.dtype) + b_if.to(x.dtype)).float()
    i_gate = torch.sigmoid(if_pre[..., h0:h1])  # (B, S, nh)
    log_f = F.logsigmoid(if_pre[..., H + h0 : H + h1])  # <= 0

    k_in = k.float() * i_gate[..., None]
    ones = torch.ones((B, S, nh, 1), dtype=torch.float32, device=x.device)
    v_ext = torch.cat([v.float(), ones], dim=-1)

    if state is None or S > 1:
        y_ext, new_state = chunked_linear_recurrence(q.float(), k_in, v_ext, log_f, chunk=128,
                                                     state0=state)
    else:
        y1, new_state = linear_recurrence_step(state, q[:, 0].float(), k_in[:, 0], v_ext[:, 0],
                                               log_f[:, 0])
        y_ext = y1[:, None]

    y = y_ext[..., :dv] / torch.clamp(torch.abs(y_ext[..., dv:]), min=1e-6)
    y = y.reshape(B, S, nh * dv)
    if mode == "straddle":
        y = y[..., lo - h0 * dh : hi - h0 * dh]
    y = layers.rmsnorm(params["norm"], y.to(x.dtype) * gate, sp=sp)
    return y @ rows(params["down"]).to(x.dtype), new_state


def mlstm_state_init(cfg, batch: int, device: torch.device | str = "cuda", sp=None) -> Tensor:
    """(batch, H, dh, dh + 1) fp32; ``sp``: a rank's share under a split
    (``mlstm_share``): its heads, each with its value columns plus the
    normalizer."""
    H = cfg.n_heads
    dh = cfg.ssm_expand * cfg.d_model // H
    sp = mixer_split(cfg, sp)
    nh, dv = H, dh
    if sp is not None:
        mode, lo, hi, h0, h1 = mlstm_layout(cfg, sp)
        nh, dv = h1 - h0, (hi - lo if mode == "inside" else dh)
    return base.shard_act(torch.zeros((batch, nh, dh, dv + 1), dtype=torch.float32, device=device),
                          ("act_batch", "act_model", None, None))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_defs(cfg) -> dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = cfg.n_heads
    dh = d_in // H
    return {
        "w_in": pdef((d, 4 * d_in), ("embed", "mlp"), init="scaled"),
        "r": pdef((H, dh, 4 * dh), ("heads", None, None), init="scaled"),
        "b": pdef((4 * d_in,), ("mlp",), init="zeros"),
        "norm": layers.rmsnorm_defs(d_in),
        "down": pdef((d_in, d), ("mlp", "embed"), init="scaled"),
    }


def slstm_block(
    params: dict,
    x: Tensor,  # (B, S, d)
    cfg,
    *,
    state: tuple[Tensor, Tensor] | None = None,  # (c, h) each (B, H, dh)
) -> tuple[Tensor, tuple[Tensor, Tensor]]:
    """The sLSTM sub-block (no residual). Under a split that shards d_in
    (``ssm.mixer_split``) each rank computes its share (``slstm_share``)
    and the partial outputs are summed over "model"; ``state`` is then the
    rank's share of it (``slstm_state_init``)."""
    sp = mixer_split(cfg, collectives.model_split())
    if sp is None:
        return slstm_share(params, x, cfg, state=state)
    y, st = slstm_share(params, collectives.copy_to(x, sp.groups), cfg, sp, state=state)
    return collectives.reduce_sum(y, sp.groups), st


def slstm_share(params: dict, x: Tensor, cfg, sp=None, *,
                state: tuple[Tensor, Tensor] | None = None) -> tuple[Tensor, tuple[Tensor, Tensor]]:
    """This rank's share of the sLSTM block (``sp``: a split of d_in), the
    partial output before the sum over "model"; without ``sp`` the whole
    block. Where "model" divides the heads, the rank's ``w_in``/``b``
    columns are its heads' gates (4 · dh a head) and its ``r`` block their
    recurrent weights: it runs the recurrence on its heads. Where it does
    not (``r`` replicated), the rank projects on its columns, gathers the
    pre-activations whole along "model" and runs the recurrence whole (a
    per-head split would need a collective per token). The RMSNorm
    (partial means) and ``down`` on the rank's columns of d_in. ``state``:
    (c, h), each (B, heads, dh)."""
    B, S, d = x.shape
    H = cfg.n_heads
    d_in = cfg.ssm_expand * d
    dh = d_in // H
    lo, hi, h0, h1 = inner_span(d_in, dh, sp)
    if sp is None:
        pre = x @ params["w_in"].to(x.dtype) + params["b"].to(x.dtype)
    elif sp.splits(H):
        w_in, b = sp.block(params["w_in"], 1, 4 * d_in), sp.block(params["b"], 0, 4 * d_in)
        pre = x @ w_in.to(x.dtype) + b.to(x.dtype)
    else:
        pre = layers.gathered_linear(x, params["w_in"], params["b"], 4 * d_in, sp)
        h0, h1 = 0, H
    nh = h1 - h0
    pre = pre.reshape(B, S, nh, 4 * dh)
    if state is None:
        state = slstm_state_init(cfg, B, device=x.device, sp=sp)
    r = head_rows(params["r"], H, h0, h1, sp).float()  # (nh, dh, 4dh)

    c, h = state
    hs = []
    for t in range(S):
        rec = (h.transpose(0, 1) @ r).transpose(0, 1)  # (B, nh, 4dh)
        z, i, f, o = torch.split(pre[:, t].float() + rec, dh, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, nh * dh)[..., lo - h0 * dh : hi - h0 * dh].to(x.dtype)
    y = layers.rmsnorm(params["norm"], y, sp=sp)
    return y @ (params["down"] if sp is None else sp.block(params["down"], 0, d_in)).to(x.dtype), (c, h)


def slstm_state_init(cfg, batch: int, device: torch.device | str = "cuda",
                     sp=None) -> tuple[Tensor, Tensor]:
    """(c, h), each (batch, H, dh) fp32; ``sp``: a rank's share under a
    split (``slstm_share``): its heads where "model" divides them, else
    every head."""
    H = cfg.n_heads
    dh = cfg.ssm_expand * cfg.d_model // H
    sp = mixer_split(cfg, sp)
    nh = H // sp.size if sp is not None and sp.splits(H) else H
    return (torch.zeros((batch, nh, dh), dtype=torch.float32, device=device),
            torch.zeros((batch, nh, dh), dtype=torch.float32, device=device))
