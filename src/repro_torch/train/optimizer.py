"""AdamW + cosine schedule + clipping, plus int8 error-feedback gradient
compression (the port of ``repro.train.optimizer``; no optimizer library).

The trees are the reference's: nested dicts of tensors in the
``model_defs`` layout (layer params stacked on leading axes), visited in
sorted key order (``base.tree_map``), so ``mu``, ``nu`` and
``ef_residual`` line up leaf for leaf with the reference's ``AdamState``.

Every scalar that the reference computes as a JAX array (the learning
rate, the bias corrections ``1 - b ** step`` and the clip scale) is an
fp32 tensor here too, on the parameters' device: Python doubles round
differently in the last bits, and Adam's ``m / sqrt(v)`` amplifies that
where ``v`` is small. Each expression keeps the reference's order of
operations.

The compressor is the distributed-optimization hook: quantizing the
gradient to int8 (per-leaf absmax scale) with error feedback (the residual
carried to the next step) is what a data-parallel all-reduce would move;
the quantized stream plus the residual equals the true stream.

Over a device mesh the trees hold this rank's shard of every leaf
(``transformer.ShardedTransformer``), and ``shards`` (its
``collectives.LeafShards``) supplies the two reductions that see a whole
leaf: the global norm sums every shard's squares, and the compressor's
absmax scale is the whole leaf's maximum. Everything else is elementwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models import base
from repro_torch.models.base import PyTree

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False  # int8 error-feedback DP compression


class AdamState(NamedTuple):
    step: Tensor  # scalar int32
    mu: PyTree
    nu: PyTree
    ef_residual: PyTree | None  # error-feedback residual (when compressing)


def _fp32_zeros(p: Tensor) -> Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_opt_state(params: PyTree, cfg: OptConfig) -> AdamState:
    """Zero moments (and residual when compressing) in fp32, step 0, on
    the parameters' device."""
    dev = base.tree_leaves(params)[0].device
    ef = base.tree_map(_fp32_zeros, params) if cfg.compress_grads else None
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                     base.tree_map(_fp32_zeros, params), base.tree_map(_fp32_zeros, params), ef)


def _f32(x: float, like: Tensor) -> Tensor:
    """``x`` as an fp32 tensor on ``like``'s device (a fill, no host copy).
    Dividing by it is a true division on the card too, where torch turns a
    division by a Python number into a product with its reciprocal."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def lr_at(step: Tensor, cfg: OptConfig) -> Tensor:
    """Linear warm-up to ``lr``, then cosine to ``lr * min_lr_ratio`` at
    ``total_steps``; an fp32 tensor on ``step``'s device."""
    s = step.to(torch.float32)
    warm = s / _f32(max(cfg.warmup_steps, 1), s)
    prog = torch.clamp(
        (s - cfg.warmup_steps) / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s), 0.0, 1.0
    )
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree: PyTree, shards=None) -> Tensor:
    """sqrt of the sum of squares, the leaves summed in tree order.
    ``shards``: the leaves are shards, each leaf's sum is taken over all
    of them (``collectives.LeafShards``)."""
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in base.tree_leaves(tree)]
    if shards is not None:
        sq = shards.sum_over_shards(sq)
    return torch.sqrt(sum(sq))


def _int8_ef(g: Tensor, r: Tensor, amax: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """``amax``: the whole leaf's max |g + r| when ``g`` is one shard."""
    t = g.to(torch.float32) + r
    scale = torch.clamp(torch.max(torch.abs(t)) if amax is None else amax, min=1e-12) / _f32(127.0, t)
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, t - deq


def compress_int8_ef(grads: PyTree, residual: PyTree) -> tuple[PyTree, PyTree]:
    """int8 quantize (per-leaf absmax scale) with error feedback.

    Returns (dequantized grads — what the all-reduce would carry, new
    residual). ``torch.round`` rounds half to even, as ``jnp.round``."""
    out = [_int8_ef(g, r) for g, r in zip(base.tree_leaves(grads), base.tree_leaves(residual))]
    return (base.tree_unflatten(grads, [d for d, _ in out]),
            base.tree_unflatten(grads, [r for _, r in out]))


@torch.no_grad()
def apply_updates(
    params: PyTree, grads: PyTree, state: AdamState, cfg: OptConfig, shards=None
) -> tuple[PyTree, AdamState, dict]:
    """Clip by the global norm, (compress,) then one AdamW step with bias
    correction. Works in place: each parameter, ``mu``, ``nu`` and the
    residual are overwritten leaf by leaf (one leaf's temporaries alive at
    a time). Returns (params, the state with the new step, {"grad_norm",
    "lr"}). ``shards``: every tree holds shards (``collectives.LeafShards``
    gives the norm and the absmax scales over whole leaves)."""
    gnorm = global_norm(grads, shards)
    scale = torch.minimum(_f32(1.0, gnorm),
                          torch.div(_f32(cfg.clip_norm, gnorm), torch.clamp(gnorm, min=1e-12)))

    step = state.step + 1
    lr = lr_at(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    p_l, m_l, v_l = (base.tree_leaves(t) for t in (params, state.mu, state.nu))
    g_l = base.tree_leaves(grads)
    r_l = base.tree_leaves(state.ef_residual) if cfg.compress_grads else [None] * len(p_l)
    amax = [None] * len(p_l)
    if cfg.compress_grads and shards is not None:  # each leaf's max |t| over all its shards
        amax = shards.max_over_shards([torch.max(torch.abs(g.to(torch.float32) * scale + r))
                                       for g, r in zip(g_l, r_l)])
    for p, g, m, v, r, a in zip(p_l, g_l, m_l, v_l, r_l, amax):
        g = g.to(torch.float32) * scale
        if cfg.compress_grads:
            g, new_r = _int8_ef(g, r, a)
            r.copy_(new_r)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
    return params, AdamState(step, state.mu, state.nu, state.ef_residual), {"grad_norm": gnorm, "lr": lr}


def abstract_opt_state(abstract_params: PyTree, cfg: OptConfig) -> AdamState:
    """``init_opt_state``'s shapes and dtypes on the ``meta`` device (no
    allocation)."""
    def z(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    ef = base.tree_map(z, abstract_params) if cfg.compress_grads else None
    return AdamState(torch.empty((), dtype=torch.int32, device="meta"),
                     base.tree_map(z, abstract_params), base.tree_map(z, abstract_params), ef)
