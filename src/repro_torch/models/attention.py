"""GQA attention: chunked (flash-style) training/prefill + cached decode.

The port of ``repro.models.attention``. Full-sequence attention runs over
query and KV chunks carrying the online-softmax state (m, l, acc), the
reference's two-level scan written as Python loops over the chunks:

  "rect"       every KV chunk for every query chunk, causality by masking;
  "blocklist"  only the lower-triangular (qi, kj) block pairs, row-major,
               so one query chunk's state is finished before the next.

Both compute in plain products, as the reference's einsums do: logits
accumulate in fp32 over inputs upcast to fp32 (the reference's
``preferred_element_type=jnp.float32``), and the probabilities are cast to
the value dtype before the value product. Decode reads the whole bf16 KV
cache with a length mask, one (B, KV, G, S) logits tensor.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import base, layers
from repro_torch.models.base import pdef

Tensor = torch.Tensor

NEG = -2.0e38


def attn_defs(cfg) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out = {
        "wq": pdef((d, H * hd), ("embed", "heads"), init="scaled"),
        "wk": pdef((d, KV * hd), ("embed", "kv"), init="scaled"),
        "wv": pdef((d, KV * hd), ("embed", "kv"), init="scaled"),
        "wo": pdef((H * hd, d), ("heads", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        out["bq"] = pdef((H * hd,), ("heads",), init="zeros")
        out["bk"] = pdef((KV * hd,), ("kv",), init="zeros")
        out["bv"] = pdef((KV * hd,), ("kv",), init="zeros")
    return out


def _project_qkv(params, x, cfg, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Full-sequence chunked attention (train / prefill)
# ---------------------------------------------------------------------------


def _block(qc_, kc_, vc_, mask, scale):
    """One flash block: returns (m, l, acc) contribution.

    qc_: (B, qc, KV, G, hd); kc_/vc_: (B, kc, KV, hd); mask: (qc, kc) bool.
    """
    logits = torch.einsum("bqkgd,bskd->bqkgs", qc_.float(), kc_.float()) * scale
    logits = torch.where(mask[None, :, None, None, :], logits, NEG)
    m = logits.amax(-1)  # (B, qc, KV, G)
    p = torch.exp(logits - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bqkgs,bskd->bqkgd", p.to(vc_.dtype), vc_)
    return m, l, acc.float()


def _merge(state, m2, l2, a2):
    m1, l1, a1 = state
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return m, l1 * c1 + l2 * c2, a1 * c1[..., None] + a2 * c2[..., None]


def chunked_attention(
    q: Tensor,  # (B, S, H, hd)
    k: Tensor,  # (B, S, KV, hd)
    v: Tensor,
    *,
    causal: bool,
    q_chunk: int,
    kv_chunk: int,
    causal_mode: str = "blocklist",
) -> Tensor:
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qc = min(q_chunk, S)
    kc = min(kv_chunk, S)
    assert S % qc == 0 and S % kc == 0, (S, qc, kc)
    nq, nk = S // qc, S // kc
    if causal and causal_mode != "rect":
        assert qc == kc, "blocklist schedule wants q_chunk == kv_chunk"

    qr = q.reshape(B, nq, qc, KV, G, hd)
    kr = k.reshape(B, nk, kc, KV, hd)
    vr = v.reshape(B, nk, kc, KV, hd)
    pos = torch.arange(S, device=q.device)
    q_pos = pos.reshape(nq, qc)
    k_pos = pos.reshape(nk, kc)
    full = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
    tri = torch.tril(full)

    def mask_of(qi: int, kj: int) -> Tensor:
        if not causal:
            return full
        if causal_mode == "rect":
            return k_pos[kj][None, :] <= q_pos[qi][:, None]
        return tri if qi == kj else full

    out = []
    for qi in range(nq):
        # blocklist: the causal triangle's pairs only, all kj of one qi in turn
        kjs = range(qi + 1) if causal and causal_mode != "rect" else range(nk)
        state = (
            torch.full((B, qc, KV, G), NEG, dtype=torch.float32, device=q.device),
            torch.zeros((B, qc, KV, G), dtype=torch.float32, device=q.device),
            torch.zeros((B, qc, KV, G, hd), dtype=torch.float32, device=q.device),
        )
        for kj in kjs:
            blk = _block(qr[:, qi], kr[:, kj], vr[:, kj], mask_of(qi, kj), scale)
            state = _merge(state, *blk)
        _, l, acc = state
        out.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(out, dim=1)  # (B, nq, qc, KV, G, hd)
    return out.reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device: torch.device | str = "cuda") -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    # Shard KV heads over the model axis when they divide; otherwise shard
    # the sequence (MQA).
    axes = ("act_batch", None, "act_model", None)
    return {
        "k": base.shard_act(torch.zeros(shape, dtype=dtype, device=device), axes),
        "v": base.shard_act(torch.zeros(shape, dtype=dtype, device=device), axes),
    }


def decode_attention(
    params: dict,
    x: Tensor,  # (B, 1, d)
    cache: dict,
    length: int | Tensor,  # tokens already in cache (int or 0-dim tensor)
    cfg,
) -> tuple[Tensor, dict]:
    """One token against the cache. Writes the token's k and v into
    ``cache`` at ``length`` in place and returns (output, cache)."""
    B, S1, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    positions = torch.zeros((B, 1), dtype=torch.int64, device=x.device) + length
    q, k, v = _project_qkv(params, x, cfg, positions)

    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, length] = k[:, 0].to(k_cache.dtype)
    v_cache[:, length] = v[:, 0].to(v_cache.dtype)
    S = k_cache.shape[1]

    qg = q.reshape(B, KV, G, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) / math.sqrt(hd)
    valid = torch.arange(S, device=x.device)[None, None, None, :] <= length
    logits = torch.where(valid, logits, NEG)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    o = o.reshape(B, 1, H * hd)
    y = o @ params["wo"].to(o.dtype)
    return y, cache


# ---------------------------------------------------------------------------
# Full block entry point
# ---------------------------------------------------------------------------


def attention_block(
    params: dict,
    x: Tensor,  # (B, S, d)
    cfg,
    *,
    positions: Tensor | None = None,
    cache: dict | None = None,
    cache_length: int | Tensor | None = None,
    causal_mode: str = "blocklist",
) -> tuple[Tensor, dict | None]:
    """Self-attention sub-block (no residual, no norm — the caller owns those).

    Returns (output (B, S, d), updated cache or None)."""
    if cache is not None:
        return decode_attention(params, x, cache, cache_length, cfg)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = _project_qkv(params, x, cfg, positions)
    y = chunked_attention(
        q,
        k,
        v,
        causal=cfg.causal,
        q_chunk=cfg.attn_q_chunk,
        kv_chunk=cfg.attn_kv_chunk,
        causal_mode=causal_mode,
    )
    y = y.reshape(B, S, cfg.n_heads * cfg.hd)
    return y @ params["wo"].to(y.dtype), None
