"""Loss + train/serve step factories.

The port of ``repro.train.train_step``. The step functions take a
``transformer.Transformer`` where the reference passes its params pytree:
the training steps a trainable holding (``Transformer(cfg, params,
trainable=True)``), the serve and prefill steps either holding.

``make_train_step`` returns a (model, opt_state, batch) -> (model,
opt_state, metrics) function with microbatched gradient accumulation: the
global batch is split into ``n_micro`` chunks run one after another, so
live activations stay at one microbatch whatever the global batch; their
gradients are averaged in fp32 (each divided by ``n_micro`` before it is
added, the reference's order). As in the reference, with ``n_micro > 1``
the metrics report ``aux`` = 0 and ``n_tokens`` = 0, and ``loss`` is the
microbatches' mean total.

Losses:
  decoder families — next-token CE (labels shifted inside), label -1 masks
  encoder (audio)  — per-frame CE, no shift
MoE aux (load-balance) loss is added with weight ``aux_weight``.

``make_mesh_train_step`` is the same step over a device mesh (DP × TP): the
model a ``transformer.ShardedTransformer``, the batch this rank's rows
(``TokenPipeline.device_batch``). Each rank computes the global loss (the
masked token sum and count all-reduced over the batch axes) on its rows,
gathering one layer's weights at a time (under "tp" only along the batch
axes: each rank computes its share along "model", the CE vocabulary-
parallel); each layer's gradients are summed over the batch axes straight into each rank's shards
(reduce-scatters), and ``apply_updates`` updates the shards with the norm
and the compressor's scales taken over whole leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import base, collectives
from repro_torch.models.config import ArchConfig
from repro_torch.train import optimizer as opt_lib

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StepConfig:
    n_micro: int = 1
    aux_weight: float = 0.01
    causal_mode: str = "blocklist"
    grad_dtype: str = "float32"  # declared by the reference, read by neither package


def cross_entropy(logits: Tensor, labels: Tensor, shift: bool) -> tuple[Tensor, Tensor]:
    """Masked mean CE. labels < 0 are ignored. Returns (loss, n_tokens)."""
    nll, mask = _masked_nll(logits, labels, shift)
    n = torch.clamp(mask.sum(), min=1)
    return nll.sum() / n, n


def _masked_nll(logits: Tensor, labels: Tensor, shift: bool, split=None) -> tuple[Tensor, Tensor]:
    """(per-position CE, 0 where masked; the mask of labels >= 0).
    ``split``: the ``collectives.Split`` whose vocabulary columns
    ``logits`` are (the mesh step under "tp"): the CE over the whole
    vocabulary from them (``collectives.vocab_nll``)."""
    if shift:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    # Pad/patch positions may make labels longer/shorter than logits (vlm
    # prepends patches); align on the right.
    S = min(logits.shape[1], labels.shape[1])
    logits = logits[:, logits.shape[1] - S:].float()
    labels = labels[:, labels.shape[1] - S:]
    mask = labels >= 0
    if split is not None:
        return collectives.vocab_nll(logits, labels, split) * mask, mask
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    return (lse - ll) * mask, mask


def make_loss_fn(cfg: ArchConfig, scfg: StepConfig) -> Callable:
    def loss_fn(model, batch: dict) -> tuple[Tensor, dict]:
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, aux = model(inputs, causal_mode=scfg.causal_mode)
        loss, n_tok = cross_entropy(logits, batch["labels"], shift=not cfg.is_encoder)
        total = loss + scfg.aux_weight * aux
        return total, {"loss": loss, "aux": aux, "n_tokens": n_tok}

    return loss_fn


def _grads(loss_fn: Callable, model, batch: dict) -> tuple[Tensor, dict, list]:
    """(total, metrics, the gradient of each leaf of ``model.param_tree()``
    in tree order; zeros where the loss does not reach a leaf, as
    ``jax.grad`` gives)."""
    leaves = base.tree_leaves(model.param_tree())
    with torch.enable_grad():
        total, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_grad_fn(cfg: ArchConfig, scfg: StepConfig, loss_fn: Callable | None = None) -> Callable:
    """(model, batch) -> (total, metrics, grads): the gradient half of the
    train step, ``grads`` a list in ``model.param_tree()`` leaf order.
    ``n_micro > 1``: the microbatches' gradients averaged in fp32, each
    divided by ``n_micro`` before it is added (the reference's scan), and
    the metrics ``loss`` = the mean total, ``aux`` = 0, ``n_tokens`` = 0
    (the reference's report). ``loss_fn``: ``make_loss_fn``'s by default."""
    loss_fn = loss_fn or make_loss_fn(cfg, scfg)
    n_micro = scfg.n_micro

    def grad_fn(model, batch: dict):
        if n_micro == 1:
            return _grads(loss_fn, model, batch)
        B = next(iter(batch.values())).shape[0]
        if B % n_micro:
            raise ValueError(f"global batch {B} does not split into {n_micro} microbatches")
        mb = B // n_micro
        grads, total = None, None
        for i in range(n_micro):
            micro = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
            t, _, g = _grads(loss_fn, model, micro)
            if grads is None:
                grads = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in g]
                total = torch.zeros((), dtype=torch.float32, device=t.device)
            for a, b in zip(grads, g):
                a.add_(b.to(torch.float32) / n_micro)
            del g
            total = total + t / n_micro
        metrics = {"loss": total,
                   "aux": torch.zeros((), dtype=torch.float32, device=total.device),
                   "n_tokens": torch.zeros((), dtype=torch.int32, device=total.device)}
        return total, metrics, grads

    return grad_fn


def make_train_step(
    cfg: ArchConfig, opt_cfg: opt_lib.OptConfig, scfg: StepConfig
) -> Callable:
    grad_fn = make_grad_fn(cfg, scfg)

    def train_step(model, opt_state: opt_lib.AdamState, batch: dict):
        total, metrics, grads = grad_fn(model, batch)
        params = model.param_tree()
        _, opt_state, om = opt_lib.apply_updates(
            params, base.tree_unflatten(params, grads), opt_state, opt_cfg)
        return model, opt_state, dict(metrics, **om, total=total)

    return train_step


def make_mesh_loss_fn(cfg: ArchConfig, scfg: StepConfig) -> Callable:
    """``make_loss_fn`` for a ``ShardedTransformer`` on this rank's batch
    rows: the masked CE summed over the rows and all-reduced over the
    batch axes, over the all-reduced token count, so every rank holds the
    global loss and its backward gives its own rows' share. Under "tp" the
    logits are the rank's vocabulary columns (``model.logits_split``) and
    the CE is vocabulary-parallel; whole logits are never formed. The
    model's aux loss is already the mean over the batch axes
    (``moe.moe_block`` under a mesh)."""

    def loss_fn(model, batch: dict) -> tuple[Tensor, dict]:
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, aux = model(inputs, causal_mode=scfg.causal_mode)
        nll, mask = _masked_nll(logits, batch["labels"], not cfg.is_encoder, model.logits_split)
        n = torch.clamp(collectives.reduce_sum(mask.sum(), model.batch_groups), min=1)
        loss = collectives.reduce_sum(nll.sum(), model.batch_groups) / n
        total = loss + scfg.aux_weight * aux
        return total, {"loss": loss, "aux": aux, "n_tokens": n}

    return loss_fn


def make_mesh_train_step(
    cfg: ArchConfig, opt_cfg: opt_lib.OptConfig, scfg: StepConfig
) -> Callable:
    """``make_train_step`` over a device mesh: (ShardedTransformer, its
    optimizer state, this rank's batch rows — tensors or
    ``device_batch``'s DTensors) -> (model, opt_state, metrics), the
    metrics global (the same on every rank)."""
    grad_fn = make_grad_fn(cfg, scfg, make_mesh_loss_fn(cfg, scfg))

    def train_step(model, opt_state: opt_lib.AdamState, batch: dict):
        batch = {k: v.to_local() if hasattr(v, "to_local") else v for k, v in batch.items()}
        total, metrics, grads = grad_fn(model, batch)
        params = model.param_tree()
        _, opt_state, om = opt_lib.apply_updates(
            params, base.tree_unflatten(params, grads), opt_state, opt_cfg, shards=model.shards)
        return model, opt_state, dict(metrics, **om, total=total)

    return train_step


def make_eval_step(cfg: ArchConfig, scfg: StepConfig | None = None) -> Callable:
    loss_fn = make_loss_fn(cfg, scfg or StepConfig())

    def eval_step(model, batch: dict) -> dict:
        _, metrics = loss_fn(model, batch)
        return metrics

    return eval_step


def make_serve_step(cfg: ArchConfig, sample: str = "greedy", temperature: float = 1.0):
    """One decode step: (model, token, state, length[, generator]) ->
    (next_token, logits, state). Greedy takes the argmax of the fp32
    logits (the first index on ties); "sample" draws from
    softmax(logits / temperature) with ``generator`` (the reference's key)."""

    def serve_step(model, token: Tensor, state, length, generator: torch.Generator | None = None):
        logits, state = model.decode_step(token, state, length)
        last = logits[:, -1].float()
        if sample == "greedy":
            nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
        else:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator).to(torch.int32)
        return nxt, logits, state

    return serve_step


def make_prefill_step(cfg: ArchConfig, scfg: StepConfig | None = None):
    """Full-sequence forward returning LAST-position logits (B, 1, vocab) —
    what serving prefill emits (the first sampled token). Slicing before
    the unembed keeps the (B, S, vocab) logits tensor out of memory."""
    scfg = scfg or StepConfig()

    def prefill_step(model, batch: dict) -> Tensor:
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, _ = model(inputs, causal_mode=scfg.causal_mode, last_only=True)
        return logits

    return prefill_step
