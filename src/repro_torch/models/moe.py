"""Mixture-of-Experts FFN with capacity-bounded dispatch.

The port of ``repro.models.moe``'s single-card path. Tokens are processed
in groups of ~``group_size``; in each group the router picks every token's
top-k experts, each (token, choice) assignment takes the next slot of its
expert's static capacity C (a running count over the group, token-major),
assignments past C are dropped, and every expert runs its SwiGLU FFN over
its (B, C, d) slice of the dispatch buffer — skew costs padding, not
stragglers. Both llama4-scout (16e top-1 + shared) and deepseek-moe (64e
top-6 + 2 shared, fine-grained) are instances of this one module.

Expert parallelism (the reference's ``_dispatch_group_ep`` and
``moe_block``'s ``shard_map`` branch): under a mesh whose "model" axis
divides ``n_experts`` (and whose activation rules replicate activations
over "model"), each rank routes every token of its batch rows, computes
only its ``n_experts / n_model`` experts (non-local assignments go to the
dropped bucket), and one all-reduce SUM over the "model" group combines the
partial outputs; the load-balance loss is averaged over the batch axes.
The reference's ``compat.shard_map`` has no torch counterpart: the branch
calls the mesh's process groups itself (``collectives``). Under any other
mesh the local path runs on the rank's batch rows, with the load-balance
loss's means taken over the global batch, as GSPMD gives the reference.
Without a mesh the path is the single-card one, op for op.

Under a split (``collectives.model_split``: the mesh step under "tp",
which hands down each rank's blocks along "model") the shared experts take
the MLP's column and row split, their partial output added to the routed
partials before the one all-reduce; where "model" does not divide
``n_experts`` the rules put it on the experts' FFN dim instead, and each
rank computes every expert on its columns and rows (``_moe_split``), the
router replicated.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import base, collectives, layers
from repro_torch.models.base import pdef

Tensor = torch.Tensor
ROUTED = ("gate", "up", "down")  # the routed experts' leaves, (E, ...) each


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


def _dispatch_group(params, xg: Tensor, cfg, batch_mean=None) -> tuple[Tensor, Tensor]:
    """One token group. xg: (B, gs, d) -> (y (B, gs, d), aux_loss scalar).
    ``batch_mean``: see ``_dispatch_group_ep``."""
    y, aux = _dispatch_group_ep(params, xg, cfg, 0, cfg.n_experts, batch_mean)
    if cfg.n_shared_experts:
        y = y + layers.mlp(params["shared"], xg, "swiglu")
    return y, aux


def _dispatch_group_ep(params, xg: Tensor, cfg, e_offset: int, n_local: int,
                       batch_mean=None) -> tuple[Tensor, Tensor]:
    """One token group through experts [e_offset, e_offset + n_local) only
    (``params``' gate/up/down hold those ``n_local`` experts): routing is
    computed in full, assignments to other experts go to the dropped
    bucket with those past capacity, and the output is this slice's
    partial combine (no shared experts). Summed over a partition of the
    experts it is ``_dispatch_group``'s routed output; with
    ``(0, n_experts)`` it is that output op for op. ``batch_mean``, when
    given, maps this rank's (2E,) ``me ‖ ce`` to their means over the
    batch shards (``xg`` is then one shard of the global batch), so the
    aux loss is the global batch's product of means.
    xg: (B, gs, d) -> (y (B, gs, d), aux_loss scalar)."""
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
    if batch_mean is not None:
        me, ce = batch_mean(torch.cat([me, ce])).split(E)
    aux = E * (me * ce).sum()

    # ---- rank of each (token, choice) within its expert ------------------
    flat_e = idx.reshape(B, gs * k)  # (B, T') expert id per assignment
    rank = torch.cumsum(F.one_hot(flat_e, E), dim=1) - 1  # (B, T', E)
    rank_of = rank.gather(2, flat_e[..., None])[..., 0]  # (B, T')
    keep = rank_of < C  # dropped assignments beyond capacity
    if n_local != E:
        keep = keep & (flat_e >= e_offset) & (flat_e < e_offset + n_local)
    # row n_local collects the drops (and the other ranks' assignments), then goes
    ee = torch.where(keep, flat_e - e_offset if e_offset else flat_e, n_local)
    cc = torch.clamp(rank_of, 0, C - 1)

    # ---- dispatch: each kept assignment copies its token into its slot ----
    tok = torch.arange(gs, device=xg.device).repeat_interleave(k)  # (T',)
    slot = (torch.arange(B, device=xg.device)[:, None] * (n_local + 1) + ee) * C + cc  # (B, T')
    buf = torch.zeros((B * (n_local + 1) * C, d), dtype=xg.dtype, device=xg.device)
    buf.index_add_(0, slot.reshape(-1), xg[:, tok].reshape(B * gs * k, d))
    buf = buf.view(B, n_local + 1, C, d)[:, :n_local]  # (B, n_local, C, d)
    buf = base.shard_act(buf, ("act_batch", "act_model", None, None))

    # ---- expert FFN: one batched product per expert -----------------------
    xe = buf.transpose(0, 1).reshape(n_local, B * C, d)
    g = torch.bmm(xe, params["gate"].to(xe.dtype))
    u = torch.bmm(xe, params["up"].to(xe.dtype))
    o = torch.bmm(F.silu(g) * u, params["down"].to(xe.dtype))  # (n_local, B*C, d)
    o = o.view(n_local, B, C, d).transpose(0, 1)  # (B, n_local, C, d)
    o = base.shard_act(o, ("act_batch", "act_model", None, None))

    # ---- combine: weighted sum back in token order ------------------------
    # The reference scatter-adds the k weighted rows of each token in
    # assignment order in the output dtype; summing choice by choice keeps
    # that order (and each rounding) without an atomic scatter.
    bi = torch.arange(B, device=xg.device)[:, None]
    gathered = o[bi, torch.clamp(ee, max=n_local - 1), cc]  # (B, T', d)
    gathered = gathered.masked_fill((ee == n_local)[..., None], 0)  # the dropped contribute 0
    part = (gathered * w.reshape(B, gs * k, 1).to(o.dtype)).view(B, gs, k, d)
    y = torch.zeros((B, gs, d), dtype=o.dtype, device=o.device)
    for j in range(k):
        y = y + part[:, :, j]
    return y.to(xg.dtype), aux


def _moe_groups(params, x: Tensor, cfg, group_size: int, dispatch_fn) -> tuple[Tensor, Tensor]:
    """``dispatch_fn`` over the groups of ``min(group_size, S)`` tokens one
    after another; their aux losses averaged."""
    B, S, d = x.shape
    gs = min(group_size, S)
    assert S % gs == 0, (S, gs)
    nG = S // gs
    if nG == 1:
        return dispatch_fn(params, x, cfg)
    xr = x.reshape(B, nG, gs, d)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for g in range(nG):
        y, a = dispatch_fn(params, xr[:, g], cfg)
        aux = aux + a
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, d), aux / nG


def ep_model_size(cfg) -> int | None:
    """The "model" axis' size when ``moe_block`` takes the expert-parallel
    branch: a current mesh with a "model" axis that divides ``n_experts``
    and activation rules that replicate activations over it (under the
    FSDP profile "model" carries batch, and the local path runs)."""
    mesh = base.current_mesh()
    if mesh is None or base.current_act_rules().get("act_model") is None:
        return None
    n_model = base.axis_sizes(mesh).get("model")
    if n_model is None or cfg.n_experts % n_model or cfg.n_experts < n_model:
        return None
    return n_model


def _local_experts(w: Tensor, e_offset: int, n_local: int) -> Tensor:
    """This rank's experts of a routed weight held whole or as its shard
    (the mesh step hands down the shard)."""
    return w if w.shape[0] == n_local else w[e_offset : e_offset + n_local]


def moe_block(params: dict, x: Tensor, cfg, group_size: int = 2048) -> tuple[Tensor, Tensor]:
    """MoE FFN over (B, S, d). Returns (y, aux_loss): the groups of
    ``min(group_size, S)`` tokens are dispatched one after another and
    their aux losses averaged.

    Under a mesh (``base.use_mesh``) whose "model" axis divides
    ``n_experts``, the expert-parallel branch: ``x`` is this rank's batch
    rows (replicated over "model"), the rank dispatches to its experts
    only, one all-reduce SUM over "model" combines the partial outputs,
    the aux loss is averaged over the batch axes (the reference ``pmean``s
    each shard's loss there), and the shared experts run on ``x`` after
    the combine.

    Under any other mesh the local path runs on the rank's batch rows. As
    under the reference's GSPMD, each group's ``me`` and ``ce`` are means
    over the global batch: one all-reduce SUM of the 2E floats ``me ‖ ce``
    per group and per mesh axis of "act_batch" (``collectives.batch_mean``),
    before the product. Every rank then holds the global aux loss, and its
    backward gives its own rows' share (the all-reduce's gradient is the
    identity, and ``collectives.LayerGather``'s backward sums each
    parameter's gradient over the batch axes)."""
    mesh = base.current_mesh()
    n_model = ep_model_size(cfg)
    sp = collectives.model_split()
    if n_model is None:
        if mesh is None:
            return _moe_groups(params, x, cfg, group_size, _dispatch_group)
        axes = base.current_act_rules()["act_batch"]

        def batch_mean(t):
            return collectives.batch_mean(t, mesh, axes)

        if sp is not None and sp.splits(cfg.d_ff_expert):
            return _moe_split(params, x, cfg, group_size, sp, batch_mean)

        def local(pp, xg, cfg_):
            return _dispatch_group(pp, xg, cfg_, batch_mean)

        return _moe_groups(params, x, cfg, group_size, local)
    n_local = cfg.n_experts // n_model
    e_off = collectives.coordinate(mesh, "model") * n_local
    model = collectives.axis_groups(mesh, ("model",))
    routed = {"router": collectives.copy_to(params["router"], model)}
    for key in ROUTED:
        routed[key] = _local_experts(params[key], e_off, n_local)

    def dispatch(pp, xg, cfg_):
        return _dispatch_group_ep(pp, xg, cfg_, e_off, n_local)

    xc = collectives.copy_to(x, model)
    y, aux = _moe_groups(routed, xc, cfg, group_size, dispatch)
    y = _shared_sum(params, x, xc, y, cfg, sp, model)
    # every "model" rank computes the same aux: its gradient is shared out
    aux = collectives.batch_mean(collectives.scale_grad(aux, 1.0 / n_model), mesh, ("pod", "data"))
    return y, aux


def _shared_sum(params, x: Tensor, xc: Tensor, y: Tensor, cfg, sp, model: list) -> Tensor:
    """The routed partial ``y`` summed over "model" with the shared
    experts: under a split that shards them their share is added to ``y``
    first (on ``xc``, ``x`` after ``copy_to``), so one all-reduce sums
    both; else they run whole on ``x`` after the sum."""
    d_sh = cfg.n_shared_experts * cfg.d_ff_expert
    if cfg.n_shared_experts and sp is not None and sp.splits(d_sh):
        y = collectives.reduce_sum(y + layers.mlp_share(params["shared"], xc, "swiglu", sp, d_sh), model)
        return layers.row_bias(params["shared"]["down"], y)
    y = collectives.reduce_sum(y, model)
    if cfg.n_shared_experts:
        y = y + layers.mlp(params["shared"], x, "swiglu")
    return y


def _moe_split(params, x: Tensor, cfg, group_size: int, sp, batch_mean) -> tuple[Tensor, Tensor]:
    """``moe_block`` under a split where "model" does not divide
    ``n_experts``: the rules shard each routed expert's FFN dim over
    "model", so every rank routes every token of its rows (the router
    replicated: its gradient summed over "model"), runs every expert on its
    columns of ``gate``/``up`` and rows of ``down``, and the partial
    outputs are summed over "model" with the shared experts' (one
    all-reduce). The aux loss is the local path's (means over the global
    batch), its gradient shared out over the "model" ranks that each
    compute it."""
    f = cfg.d_ff_expert
    pp = {"router": collectives.copy_to(params["router"], sp.groups),
          "gate": sp.block(params["gate"], 2, f), "up": sp.block(params["up"], 2, f),
          "down": sp.block(params["down"], 1, f)}

    def dispatch(pp_, xg, cfg_):
        return _dispatch_group_ep(pp_, xg, cfg_, 0, cfg.n_experts, batch_mean)

    xc = collectives.copy_to(x, sp.groups)
    y, aux = _moe_groups(pp, xc, cfg, group_size, dispatch)
    return _shared_sum(params, x, xc, y, cfg, sp, sp.groups), collectives.scale_grad(aux, 1.0 / sp.size)
