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

from repro_torch.models import base, collectives, layers
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


def mixer_split(cfg, sp):
    """The split a Mamba2 or xLSTM mixer computes its share under: ``sp``
    when "model" divides the mixer's inner width d_in (the rows of
    ``out_proj`` / ``down``), else None: the mixer is computed whole on
    every rank, its leaves gathered whole along "model"."""
    return sp if sp is not None and sp.splits(cfg.ssm_expand * cfg.d_model) else None


def inner_span(d_in: int, dh: int, sp) -> tuple[int, int, int, int]:
    """(lo, hi, h0, h1): this rank's columns [lo, hi) of a mixer's inner
    width (its rows of the output projection) and the heads [h0, h1) of
    width ``dh`` they touch; every column and head without a split."""
    if sp is None:
        return 0, d_in, 0, d_in // dh
    lo, hi = sp.span(d_in)
    return lo, hi, lo // dh, -(-hi // dh)


def head_rows(w: Tensor, H: int, h0: int, h1: int, sp) -> Tensor:
    """Rows [h0, h1) of a per-head leaf (leading dim H) for this rank's
    share: its block where "model" splits the heads (held so, or cut from
    the whole leaf), else those rows of the whole leaf, its gradient
    summed over "model"."""
    if sp is None:
        return w
    if sp.splits(H):
        return sp.block(w, 0, H)
    return collectives.copy_to(w, sp.groups)[h0:h1]


def mamba2_block(
    params: dict,
    x: Tensor,  # (B, S, d)
    cfg,
    *,
    state: dict | None = None,  # {"conv": (B,W-1,C), "ssd": (B,H,N,P)}
) -> tuple[Tensor, dict]:
    """Mamba2 sub-block (no residual). Decode when S == 1 and state given.
    ``A_log``, ``D`` and ``dt_bias`` are read in fp32, as the reference
    reads them. Under a split that shards d_in (``mixer_split``) each rank
    computes its share (``mamba2_share``) and the partial outputs are
    summed over "model"; ``state`` is then the rank's share of it
    (``mamba2_state_init``)."""
    sp = mixer_split(cfg, collectives.model_split())
    if sp is None:
        return mamba2_share(params, x, cfg, state=state)
    y, st = mamba2_share(params, collectives.copy_to(x, sp.groups), cfg, sp, state=state)
    return collectives.reduce_sum(y, sp.groups), st


def mamba2_share(params: dict, x: Tensor, cfg, sp=None, *, state: dict | None = None) -> tuple[Tensor, dict]:
    """This rank's share of the Mamba2 block (``sp``: a split of d_in), the
    partial output before the sum over "model"; without ``sp`` the whole
    block. Rank r of m owns the columns [lo, hi) of d_in (its rows of
    ``out_proj``) and computes the heads [h0, h1) they touch: its own
    heads when m divides H; where it does not (heads straddling two
    ranks) the straddled heads on both, each rank using only its columns.

    ``in_proj``'s column blocks do not line up with its z | x | B | C | dt
    segments, so the rank projects on its columns and gathers the
    projection whole along "model" (``layers.gathered_linear``), then
    takes its heads' z, x and dt and all of B and C (every head reads
    them). ``conv_w``/``conv_b`` are gathered whole (their channel blocks
    do not line up with the heads either) and the conv runs on the rank's
    x channels and on B and C; the SSD on its heads (``A_log``, ``D``,
    ``dt_bias``: its rows); the gated RMSNorm over the whole d_in from
    the ranks' partial means (``layers.rmsnorm`` with ``sp``); ``out_proj``
    on its rows. ``state``: {"conv": (B, W-1, x channels of the heads +
    2N), "ssd": (B, heads, N, P)}."""
    B, S, d = x.shape
    d_in = cfg.ssm_expand * cfg.d_model
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    H = d_in // P
    F_all, C_all = 2 * d_in + 2 * N + H, d_in + 2 * N
    lo, hi, h0, h1 = inner_span(d_in, P, sp)
    c0, c1 = h0 * P, h1 * P
    nh = h1 - h0
    if sp is None:
        zxbcdt = x @ params["in_proj"].to(x.dtype)
        conv_w, conv_b = params["conv_w"], params["conv_b"]
    else:
        zxbcdt = layers.gathered_linear(x, params["in_proj"], None, F_all, sp)
        conv_w, conv_b = sp.whole(params["conv_w"], C_all), sp.whole(params["conv_b"], C_all)
    z = zxbcdt[..., c0:c1]
    dt = zxbcdt[..., 2 * d_in + 2 * N + h0 : 2 * d_in + 2 * N + h1]  # (..., nh)
    if nh == H:
        xbc = zxbcdt[..., d_in : 2 * d_in + 2 * N]
    else:  # the heads' x channels, then B and C
        def chans(t: Tensor, off: int) -> Tensor:
            return torch.cat([t[..., off + c0 : off + c1], t[..., off + d_in : off + C_all]], -1)

        xbc = chans(zxbcdt, d_in)
        conv_w, conv_b = chans(conv_w, 0), chans(conv_b, 0)

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, conv_state)
    xs = xbc[..., : nh * P].reshape(B, S, nh, P)
    Bmat = xbc[..., nh * P : nh * P + N]  # (B, S, N) shared across heads (MVA)
    Cmat = xbc[..., nh * P + N :]  # (B, S, N)

    dt = F.softplus(dt.float() + head_rows(params["dt_bias"], H, h0, h1, sp))  # (B, S, nh)
    a = -torch.exp(head_rows(params["A_log"], H, h0, h1, sp).float())  # (nh,) < 0
    log_decay = dt * a  # (B, S, nh) <= 0
    xbar = xs.float() * dt[..., None]

    kq_k = Bmat[:, :, None, :].expand(B, S, nh, N)
    kq_q = Cmat[:, :, None, :].expand(B, S, nh, N)

    if state is None:
        y, ssd_state = chunked_linear_recurrence(kq_q, kq_k, xbar, log_decay, chunk=128)
    else:
        yv, ssd_state = linear_recurrence_step(
            state["ssd"], kq_q[:, 0], kq_k[:, 0], xbar[:, 0], log_decay[:, 0]
        )
        y = yv[:, None]
    new_state = {"conv": new_conv, "ssd": ssd_state}

    y = y + head_rows(params["D"], H, h0, h1, sp).float()[None, None, :, None] * xs.float()
    y = y.reshape(B, S, nh * P).to(x.dtype) * F.silu(z)
    if sp is None:
        return layers.rmsnorm(params["norm"], y) @ params["out_proj"].to(x.dtype), new_state
    y = layers.rmsnorm(params["norm"], y[..., lo - c0 : hi - c0], sp=sp)
    return y @ sp.block(params["out_proj"], 0, d_in).to(x.dtype), new_state


def mamba2_state_init(cfg, batch: int, device: torch.device | str = "cuda", sp=None) -> dict:
    """{"conv": (batch, W-1, C) bf16 history, "ssd": (batch, H, N, P) fp32}:
    the reference's layout and dtypes (its step returns the history in the
    activation dtype). ``sp``: a rank's share under a split
    (``mamba2_share``): the x channels of its heads plus B and C, and
    the SSD state of its heads."""
    d_in = cfg.ssm_expand * cfg.d_model
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    _, _, h0, h1 = inner_span(d_in, P, mixer_split(cfg, sp))
    return {
        "conv": base.shard_act(
            torch.zeros((batch, cfg.conv_width - 1, (h1 - h0) * P + 2 * N), dtype=torch.bfloat16,
                        device=device),
            ("act_batch", None, "act_model"),
        ),
        "ssd": base.shard_act(
            torch.zeros((batch, h1 - h0, N, P), dtype=torch.float32, device=device),
            ("act_batch", "act_model", None, None),
        ),
    }
