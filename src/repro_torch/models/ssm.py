"""State-space / linear-recurrence blocks: Mamba2 (SSD) + generic machinery.

The port of ``repro.models.ssm``. ``chunked_linear_recurrence`` is the
shared engine: it computes

    y_i = q_i . ( sum_{j<=i} exp(cum_i - cum_j) * k_j (x) v_j )

for per-head log-decays <= 0 — the SSD dual form of Mamba2 *and* (with the
input gate folded into k) the chunkwise mLSTM of xLSTM. Intra-chunk is a
masked decay-weighted attention product, inter-chunk a loop over the
chunks carrying the (H, dk, dv) state — O(S) time, O(chunk^2) memory,
numerically safe because every exponent that is kept is <= 0. Everything
runs in fp32; each chunk's output is cast to ``v``'s dtype.

Decode is the O(1) recurrent step on the same state, so prefill -> decode
handoff is exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import base, layers
from repro_torch.models.base import pdef

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Generic chunked linear recurrence (SSD dual form)
# ---------------------------------------------------------------------------


def chunked_linear_recurrence(
    q: Tensor,  # (B, S, H, dk)
    k: Tensor,  # (B, S, H, dk)
    v: Tensor,  # (B, S, H, dv)
    log_decay: Tensor,  # (B, S, H), <= 0; step i decays state *before* adding k_i(x)v_i
    chunk: int = 128,
    state0: Tensor | None = None,  # (B, H, dk, dv)
) -> tuple[Tensor, Tensor]:
    """Returns (y (B, S, H, dv), final_state (B, H, dk, dv) fp32)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    nC = S // Q

    qr = q.reshape(B, nC, Q, H, dk)
    kr = k.reshape(B, nC, Q, H, dk)
    vr = v.reshape(B, nC, Q, H, dv)
    cum = torch.cumsum(log_decay.reshape(B, nC, Q, H).float(), dim=2)  # inclusive of own decay
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))

    state = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
             if state0 is None else state0)
    ys = []
    for c in range(nC):
        qc = qr[:, c].float().transpose(1, 2)  # (B, H, Q, dk)
        kc = kr[:, c].float().transpose(1, 2)
        vc = vr[:, c].float().transpose(1, 2)  # (B, H, Q, dv)
        cc = cum[:, c].transpose(1, 2)  # (B, H, Q)
        last = cc[:, :, -1]  # (B, H)

        # intra-chunk: scores (B, H, Q, Q) weighted by exp(cc_i - cc_j), j <= i
        decay = torch.where(tri, torch.exp(cc[:, :, :, None] - cc[:, :, None, :]), 0.0)
        y = (qc @ kc.transpose(-1, -2) * decay) @ vc  # (B, H, Q, dv)

        # inter-chunk: read old state, then fold this chunk into it
        y = y + (qc * torch.exp(cc)[..., None]) @ state
        write = torch.exp(last[:, :, None] - cc)  # (B, H, Q) decay to chunk end
        kw = (kc * write[..., None]).transpose(-1, -2)  # (B, H, dk, Q)
        state = state * torch.exp(last)[:, :, None, None] + kw @ vc
        ys.append(y.transpose(1, 2).to(v.dtype))  # (B, Q, H, dv)
    return torch.stack(ys, dim=1).reshape(B, S, H, dv), state


def linear_recurrence_step(
    state: Tensor,  # (B, H, dk, dv)
    q: Tensor,  # (B, H, dk)
    k: Tensor,
    v: Tensor,  # (B, H, dv)
    log_decay: Tensor,  # (B, H)
) -> tuple[Tensor, Tensor]:
    """One decode step; state is decayed then written, matching the chunked
    form's inclusive cumsum."""
    a = torch.exp(log_decay.float())[..., None, None]
    state = state * a + k.float()[..., :, None] * v.float()[..., None, :]
    y = (q.float()[..., None, :] @ state)[..., 0, :]
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def mamba2_defs(cfg) -> dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N
    return {
        "in_proj": pdef((d, 2 * d_in + 2 * N + H), ("embed", "mlp"), init="scaled"),
        "conv_w": pdef((cfg.conv_width, conv_dim), (None, "mlp"), init="scaled", scale=0.5),
        "conv_b": pdef((conv_dim,), ("mlp",), init="zeros"),
        "A_log": pdef((H,), ("heads",), init="zeros"),
        "D": pdef((H,), ("heads",), init="ones"),
        "dt_bias": pdef((H,), ("heads",), init="zeros"),
        "norm": layers.rmsnorm_defs(d_in),
        "out_proj": pdef((d_in, d), ("mlp", "embed"), init="scaled"),
    }


def _split_inproj(cfg, zxbcdt: Tensor):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : 2 * d_in + 2 * N]
    dt = zxbcdt[..., 2 * d_in + 2 * N :]  # (..., H)
    return z, xbc, dt, d_in, H, N


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor, state: Tensor | None):
    """Depthwise causal conv over (B, S, C). state: (B, W-1, C) history,
    read in ``xbc``'s dtype. Returns (silu(out), the new history in
    ``xbc``'s dtype)."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], W - 1, xbc.shape[-1]), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    out = sum(full[:, i : i + S] * w[i].to(xbc.dtype) for i in range(W)) + b.to(xbc.dtype)
    new_state = full[:, -(W - 1):] if W > 1 else pad
    return F.silu(out), new_state


def mamba2_block(
    params: dict,
    x: Tensor,  # (B, S, d)
    cfg,
    *,
    state: dict | None = None,  # {"conv": (B,W-1,C), "ssd": (B,H,N,P)}
) -> tuple[Tensor, dict]:
    """Mamba2 sub-block (no residual). Decode when S == 1 and state given.
    ``A_log``, ``D`` and ``dt_bias`` are read in fp32, as the reference
    reads them."""
    B, S, d = x.shape
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt, d_in, H, N = _split_inproj(cfg, zxbcdt)
    P = cfg.ssm_head_dim

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    xs = xbc[..., :d_in].reshape(B, S, H, P)
    Bmat = xbc[..., d_in : d_in + N]  # (B, S, N) shared across heads (MVA)
    Cmat = xbc[..., d_in + N :]  # (B, S, N)

    dt = F.softplus(dt.float() + params["dt_bias"])  # (B, S, H)
    a = -torch.exp(params["A_log"].float())  # (H,) < 0
    log_decay = dt * a  # (B, S, H) <= 0
    xbar = xs.float() * dt[..., None]

    kq_k = Bmat[:, :, None, :].expand(B, S, H, N)
    kq_q = Cmat[:, :, None, :].expand(B, S, H, N)

    if state is None:
        y, ssd_state = chunked_linear_recurrence(kq_q, kq_k, xbar, log_decay, chunk=128)
    else:
        yv, ssd_state = linear_recurrence_step(
            state["ssd"], kq_q[:, 0], kq_k[:, 0], xbar[:, 0], log_decay[:, 0]
        )
        y = yv[:, None]
    new_state = {"conv": new_conv, "ssd": ssd_state}

    y = y + params["D"].float()[None, None, :, None] * xs.float()
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = layers.rmsnorm(params["norm"], y * F.silu(z))
    return y @ params["out_proj"].to(x.dtype), new_state


def mamba2_state_init(cfg, batch: int, device: torch.device | str = "cuda") -> dict:
    """{"conv": (batch, W-1, C) bf16 history, "ssd": (batch, H, N, P) fp32}:
    the reference's layout and dtypes (its step returns the history in the
    activation dtype)."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N
    return {
        "conv": base.shard_act(
            torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=torch.bfloat16, device=device),
            ("act_batch", None, "act_model"),
        ),
        "ssd": base.shard_act(
            torch.zeros((batch, H, N, cfg.ssm_head_dim), dtype=torch.float32, device=device),
            ("act_batch", "act_model", None, None),
        ),
    }
