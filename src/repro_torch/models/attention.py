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

Under a split (``collectives.model_split``: the mesh step under "tp") the
block is split by heads where the rules shard ``wq``/``wo`` over "model"
(``head_split``): each rank projects its q heads and the kv heads they
read, attends with them, multiplies its rows of ``wo``, and one
``reduce_sum`` adds the ranks' outputs. A projection whose rank block is
not whole heads (``wk``/``wv`` of an MQA model, ``wq`` where the heads do
not divide) is computed on the rank's columns and gathered whole along
"model" (``collectives.gather_last``); a kv projection the rules replicate
is computed whole. The KV cache then holds the rank's kv heads where they
are split by heads, else every kv head.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import base, collectives, layers
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


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """One rank's share of an attention block on ``m`` ranks along "model".

    q, kv    how its ``wq`` and ``wk``/``wv`` columns lie: "heads" (the
             rank's block is whole heads), "cols" (it is not: the
             projection is gathered whole along "model"), "whole" (the
             rules replicate the leaf: computed whole on every rank)
    heads    the q heads [h0, h1) it attends with: those its rows of
             ``wo`` read (its own heads under "heads")
    kv_heads the kv heads [k0, k1) they read
    cols     its rows of ``wo`` as columns of the heads' output, from head
             h0's first column"""

    q: str
    kv: str
    heads: tuple[int, int]
    kv_heads: tuple[int, int]
    cols: tuple[int, int]

    @property
    def gathered(self) -> tuple[str, ...]:
        """The leaves whose projection is gathered whole along "model"."""
        return (("wq",) if self.q == "cols" else ()) + (("wk", "wv") if self.kv == "cols" else ())

    def cache_heads(self, cfg) -> int:
        """The kv heads a KV cache of this rank holds."""
        return self.kv_heads[1] - self.kv_heads[0] if self.kv == "heads" else cfg.n_kv_heads


def head_split(cfg, m: int, r: int) -> HeadSplit | None:
    """Rank ``r``'s share of the attention on ``m`` ranks along "model", as
    the rules place its leaves (a dim is sharded when ``m`` divides it);
    None when ``wq``/``wo`` are replicated (the block is computed whole)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if (H * hd) % m:
        return None
    c = H * hd // m
    lo = r * c
    h0, h1 = lo // hd, -(-(lo + c) // hd)
    G = H // KV
    kv = "whole" if (KV * hd) % m else ("heads" if KV % m == 0 else "cols")
    return HeadSplit(q="heads" if H % m == 0 else "cols", kv=kv, heads=(h0, h1),
                     kv_heads=(h0 // G, (h1 - 1) // G + 1), cols=(lo - h0 * hd, lo - h0 * hd + c))


def _split_of(cfg):
    """(the split in force, this rank's ``HeadSplit``) or (None, None)."""
    sp = collectives.model_split()
    hs = None if sp is None else head_split(cfg, sp.size, sp.rank)
    return (sp, hs) if hs is not None else (None, None)


def _projection(params, x, w: str, b: str, full: int, mode: str, sp, cfg):
    """``x @ w (+ b)`` as the split places the leaf: this rank's columns
    ("heads"), its columns gathered whole ("cols"), or the leaf whole, its
    gradient summed over "model" ("whole"); without a split the leaf whole."""
    wt, bt = params[w], (params[b] if cfg.qkv_bias else None)
    if sp is not None and mode == "whole":
        wt = collectives.copy_to(wt, sp.groups)
        bt = None if bt is None else collectives.copy_to(bt, sp.groups)
    elif sp is not None:
        wt = sp.block(wt, 1, full)
        bt = None if bt is None else sp.block(bt, 0, full)
    y = x @ wt.to(x.dtype)
    if bt is not None:
        y = y + bt.to(x.dtype)
    if sp is not None and mode == "cols":
        y = collectives.gather_last(y, sp.group)
    return y


def _project_qkv(params, x, cfg, positions, sp=None, hs=None):
    """q (B, S, h, hd) of the heads this rank attends with, k and v (B, S,
    kv, hd) of the kv heads it holds (``HeadSplit``: its own under "heads",
    else every kv head); without a split every head."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q_mode, kv_mode = (hs.q, hs.kv) if hs is not None else (None, None)
    q = _projection(params, x, "wq", "bq", H * hd, q_mode, sp, cfg)
    k = _projection(params, x, "wk", "bk", KV * hd, kv_mode, sp, cfg)
    v = _projection(params, x, "wv", "bv", KV * hd, kv_mode, sp, cfg)
    if hs is not None and hs.q == "cols":
        q = q[..., hs.heads[0] * hd : hs.heads[1] * hd]
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped(k: Tensor, v: Tensor, hs: HeadSplit | None, cfg) -> tuple[Tensor, Tensor]:
    """k and v (..., kv, hd) as the kv heads the rank's q heads read, in
    the grouping ``chunked_attention`` and the decode take (q head j reads
    kv head j // (h / kv)): the held kv heads [k0, k1) where they line up
    so, else each q head's own kv head."""
    if hs is None:
        return k, v
    (h0, h1), (k0, k1) = hs.heads, hs.kv_heads
    if hs.kv != "heads":
        k, v = k[..., k0:k1, :], v[..., k0:k1, :]
    G, nq, nk = cfg.n_heads // cfg.n_kv_heads, h1 - h0, k1 - k0
    if nq % nk == 0 and all((h0 + j) // G - k0 == j // (nq // nk) for j in range(nq)):
        return k, v
    idx = torch.arange(h0, h1, device=k.device) // G - k0
    return k.index_select(-2, idx), v.index_select(-2, idx)


def _out_proj(params, o: Tensor, cfg, sp, hs) -> Tensor:
    """The heads' output (B, S, h · hd) through ``wo``: under a split this
    rank's rows of it (the partial output)."""
    if hs is None:
        return o @ params["wo"].to(o.dtype)
    o = o[..., hs.cols[0] : hs.cols[1]]
    return o @ sp.block(params["wo"], 0, cfg.n_heads * cfg.hd).to(o.dtype)


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
                  device: torch.device | str = "cuda", kv_heads: int | None = None) -> dict:
    """``kv_heads``: the kv heads the cache holds (a rank's share, ``HeadSplit.cache_heads``;
    default every one)."""
    shape = (batch, max_len, kv_heads or cfg.n_kv_heads, cfg.hd)
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
    hd = cfg.hd
    sp, hs = _split_of(cfg)
    if sp is not None:
        x = collectives.copy_to(x, sp.groups)
    positions = torch.zeros((B, 1), dtype=torch.int64, device=x.device) + length
    q, k, v = _project_qkv(params, x, cfg, positions, sp, hs)

    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, length] = k[:, 0].to(k_cache.dtype)
    v_cache[:, length] = v[:, 0].to(v_cache.dtype)
    S = k_cache.shape[1]
    kc, vc = _grouped(k_cache, v_cache, hs, cfg)

    nq, nk = q.shape[2], kc.shape[2]
    qg = q.reshape(B, nk, nq // nk, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), kc.float()) / math.sqrt(hd)
    valid = torch.arange(S, device=x.device)[None, None, None, :] <= length
    logits = torch.where(valid, logits, NEG)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(vc.dtype), vc)
    y = _out_proj(params, o.reshape(B, 1, nq * hd), cfg, sp, hs)
    return (y if sp is None else collectives.reduce_sum(y, sp.groups)), cache


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
    sp, hs = _split_of(cfg)
    if sp is None:
        return attention_share(params, x, cfg, positions, causal_mode=causal_mode), None
    y = attention_share(params, collectives.copy_to(x, sp.groups), cfg, positions, sp, hs, causal_mode)
    return collectives.reduce_sum(y, sp.groups), None


def attention_share(params: dict, x: Tensor, cfg, positions: Tensor, sp=None, hs: HeadSplit | None = None,
                    causal_mode: str = "blocklist") -> Tensor:
    """The full-sequence attention's output (B, S, d) from rank ``hs``'s
    share (``sp``: its ``collectives.Split``): its q heads against the kv
    heads they read, through its rows of ``wo``; the partial output before
    the sum over "model". Without ``hs`` the whole block."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions, sp, hs)
    k, v = _grouped(k, v, hs, cfg)
    y = chunked_attention(
        q,
        k,
        v,
        causal=cfg.causal,
        q_chunk=cfg.attn_q_chunk,
        kv_chunk=cfg.attn_kv_chunk,
        causal_mode=causal_mode,
    )
    return _out_proj(params, y.reshape(B, S, q.shape[2] * cfg.hd), cfg, sp, hs)
