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

from repro_torch.models import base, layers
from repro_torch.models.base import pdef
from repro_torch.models.ssm import chunked_linear_recurrence, linear_recurrence_step

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
    B, S, d = x.shape
    H = cfg.n_heads
    d_in = cfg.ssm_expand * d
    dh = d_in // H

    u = x @ params["up"].to(x.dtype)  # (B, S, d_in)
    gate = F.silu(x @ params["up_gate"].to(x.dtype))
    q = (u @ params["wq"].to(x.dtype)).reshape(B, S, H, dh)
    # the reference divides by sqrt(dh) rounded to the activation dtype
    root = float(torch.tensor(math.sqrt(dh), dtype=torch.float32).to(x.dtype))
    k = (u @ params["wk"].to(x.dtype)).reshape(B, S, H, dh) / root
    v = (u @ params["wv"].to(x.dtype)).reshape(B, S, H, dh)

    if_pre = (x @ params["w_if"].to(x.dtype) + params["b_if"].to(x.dtype)).float()
    i_gate = torch.sigmoid(if_pre[..., :H])  # (B, S, H)
    log_f = F.logsigmoid(if_pre[..., H:])  # <= 0

    k_in = k.float() * i_gate[..., None]
    ones = torch.ones((B, S, H, 1), dtype=torch.float32, device=x.device)
    v_ext = torch.cat([v.float(), ones], dim=-1)

    if state is None or S > 1:
        y_ext, new_state = chunked_linear_recurrence(q.float(), k_in, v_ext, log_f, chunk=128,
                                                     state0=state)
    else:
        y1, new_state = linear_recurrence_step(state, q[:, 0].float(), k_in[:, 0], v_ext[:, 0],
                                               log_f[:, 0])
        y_ext = y1[:, None]

    y = y_ext[..., :dh] / torch.clamp(torch.abs(y_ext[..., dh:]), min=1e-6)
    y = y.reshape(B, S, d_in).to(x.dtype) * gate
    y = layers.rmsnorm(params["norm"], y)
    return y @ params["down"].to(x.dtype), new_state


def mlstm_state_init(cfg, batch: int, device: torch.device | str = "cuda") -> Tensor:
    H = cfg.n_heads
    dh = cfg.ssm_expand * cfg.d_model // H
    return base.shard_act(torch.zeros((batch, H, dh, dh + 1), dtype=torch.float32, device=device),
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
    B, S, d = x.shape
    H = cfg.n_heads
    d_in = cfg.ssm_expand * d
    dh = d_in // H

    pre = (x @ params["w_in"].to(x.dtype) + params["b"].to(x.dtype)).reshape(B, S, H, 4 * dh)
    if state is None:
        state = slstm_state_init(cfg, B, device=x.device)
    r = params["r"].float()  # (H, dh, 4dh)

    c, h = state
    hs = []
    for t in range(S):
        rec = (h.transpose(0, 1) @ r).transpose(0, 1)  # (B, H, 4dh)
        z, i, f, o = torch.split(pre[:, t].float() + rec, dh, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, d_in).to(x.dtype)
    y = layers.rmsnorm(params["norm"], y)
    return y @ params["down"].to(x.dtype), (c, h)


def slstm_state_init(cfg, batch: int, device: torch.device | str = "cuda") -> tuple[Tensor, Tensor]:
    """(c, h), each (batch, H, dh) fp32."""
    H = cfg.n_heads
    dh = cfg.ssm_expand * cfg.d_model // H
    return (torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
            torch.zeros((batch, H, dh), dtype=torch.float32, device=device))
