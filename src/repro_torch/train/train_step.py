"""Loss + serve step factories, forward only.

The port of the forward half of ``repro.train.train_step``: the serve and
prefill steps, the masked cross-entropy and the eval step over it. The step
functions take a ``transformer.Transformer`` where the reference passes its
params pytree. ``make_train_step`` (gradients, microbatching, the
optimizer) waits for the training slice (ROADMAP §1 item 5).

Losses:
  decoder families — next-token CE (labels shifted inside), label -1 masks
  encoder (audio)  — per-frame CE, no shift
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.config import ArchConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The reference's step settings that a forward step reads
    (``n_micro`` and ``grad_dtype`` come with the training slice)."""

    aux_weight: float = 0.01
    causal_mode: str = "blocklist"


def cross_entropy(logits: Tensor, labels: Tensor, shift: bool) -> tuple[Tensor, Tensor]:
    """Masked mean CE. labels < 0 are ignored. Returns (loss, n_tokens)."""
    if shift:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    # Pad/patch positions may make labels longer/shorter than logits (vlm
    # prepends patches); align on the right.
    S = min(logits.shape[1], labels.shape[1])
    logits = logits[:, logits.shape[1] - S:].float()
    labels = labels[:, labels.shape[1] - S:]
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = (lse - ll) * mask
    n = torch.clamp(mask.sum(), min=1)
    return nll.sum() / n, n


def make_loss_fn(cfg: ArchConfig, scfg: StepConfig) -> Callable:
    def loss_fn(model, batch: dict) -> tuple[Tensor, dict]:
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, aux = model(inputs, causal_mode=scfg.causal_mode)
        loss, n_tok = cross_entropy(logits, batch["labels"], shift=not cfg.is_encoder)
        total = loss + scfg.aux_weight * aux
        return total, {"loss": loss, "aux": aux, "n_tokens": n_tok}

    return loss_fn


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
