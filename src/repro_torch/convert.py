"""Carry control-plane state from the JAX package into the port.

torch cannot reproduce ``jax.random`` streams, so for the same seed the two
packages draw different pivots, anchors and plans. These plain functions
turn the reference's artifacts, given as numpy arrays (anything
``np.asarray`` takes), into the port's objects, so both packages compute
from the same control plane and each stage can be held to exact parity.
Like the rest of the port they put their tensors on the card unless the
caller passes ``device="cpu"``. Nothing here imports the JAX package.

``lm_params`` does the same for the LM stack: the reference's parameter
pytree (numpy arrays) becomes a ``Transformer`` holding the same weights,
placed for serving or held for training; ``adam_state`` carries the
reference's optimizer state over beside it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import expfam, mapping, partition, sampling
from repro_torch.kernels import ops

Tensor = torch.Tensor


def _t(a, device) -> Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=ops.resolve_device(device))


def pivots(pivots_np, device: torch.device | str = "cuda") -> Tensor:
    """(k, m) pivots as a float32 tensor."""
    return _t(pivots_np, device)


def space_map(anchors, metric: str, device: torch.device | str = "cuda") -> mapping.SpaceMap:
    """A ``SpaceMap`` from the reference's anchors (n, m) and metric."""
    return mapping.SpaceMap(_t(anchors, device), metric)


def partition_plan(
    kernel_lo, kernel_hi, whole_lo, whole_hi, delta: float,
    device: torch.device | str = "cuda",
) -> partition.PartitionPlan:
    """A ``PartitionPlan`` from the reference's (p, n) box edges and δ."""
    return partition.PartitionPlan(
        kernel_lo=_t(kernel_lo, device),
        kernel_hi=_t(kernel_hi, device),
        whole_lo=_t(whole_lo, device),
        whole_hi=_t(whole_hi, device),
        delta=float(delta),
    )


def node_stats(
    family: str, a, b, confidence: float, count: int,
    device: torch.device | str = "cuda",
) -> sampling.NodeStats:
    """One node's broadcast statistics ⟨family, η = (a, b), c⁰, N⟩."""
    return sampling.NodeStats(
        family=family,
        params=expfam.FamilyParams(family, _t(a, device), _t(b, device)),
        confidence=float(confidence),
        count=int(count),
    )


def generative_model(ref_model, device: torch.device | str = "cuda") -> sampling.GenerativeModel:
    """A ``GenerativeModel`` from the reference's (its families and its
    packed params, confidences and counts as arrays)."""
    return sampling.GenerativeModel(
        families=tuple(ref_model.families),
        packed_params=_t(ref_model.packed_params, device),
        confidence=_t(ref_model.confidence, device),
        counts=_t(ref_model.counts, device),
    )


def join_plan(
    anchors, metric: str, kernel_lo, kernel_hi, whole_lo, whole_hi, delta: float, p: int,
    device: torch.device | str = "cuda",
):
    """A ``distributed.JoinPlan`` from the reference's ``JoinPlan`` arrays
    (anchors (n, m), (p, n) box edges), metric, δ and p."""
    from repro_torch.core import distributed  # deferred: torch.distributed import

    return distributed.JoinPlan(
        anchors=_t(anchors, device),
        metric=metric,
        kernel_lo=_t(kernel_lo, device),
        kernel_hi=_t(kernel_hi, device),
        whole_lo=_t(whole_lo, device),
        whole_hi=_t(whole_hi, device),
        delta=float(delta),
        p=int(p),
    )


def _lm_tree(params_np, cfg, dev, what: str = "params"):
    """``params_np`` as fp32 tensors on ``dev`` after the checks that its
    names and shapes are ``model_defs(cfg)``'s."""
    from repro_torch.models import transformer  # deferred: LM stack

    want = transformer.model_defs(cfg)

    def place(defs, tree, path=""):
        if isinstance(defs, dict):
            if not isinstance(tree, dict) or set(tree) != set(defs):
                raise ValueError(f"{cfg.name}: {what} at {path or '/'} have keys "
                                 f"{sorted(tree) if isinstance(tree, dict) else type(tree)}, "
                                 f"want {sorted(defs)}")
            return {k: place(defs[k], tree[k], f"{path}/{k}") for k in defs}
        a = np.asarray(tree)
        if a.shape != defs.shape:
            raise ValueError(f"{cfg.name}: {what} {path} has shape {a.shape}, want {defs.shape}")
        return torch.as_tensor(np.array(a, np.float32), device=dev).to(defs.dtype)

    return place(want, params_np)


def lm_params(params_np, cfg, device: torch.device | str = "cuda", *, trainable: bool = False):
    """A ``models.transformer.Transformer`` holding the reference's LM
    parameters: ``params_np`` is the pytree of ``repro.models.base.
    init_params(key, model_defs(cfg))`` as numpy arrays (anything
    ``np.asarray`` takes), layer params stacked on the leading "layers"
    axis; names and shapes must be ``model_defs(cfg)``'s. Weights keep the
    reference's (d_in, d_out) layout (``x @ w``). ``trainable``: the
    training holding (each leaf one fp32 parameter, stacks whole), whose
    ``param_tree()`` is the reference's tree leaf for leaf."""
    from repro_torch.models import transformer  # deferred: LM stack

    dev = ops.resolve_device(device)
    return transformer.Transformer(cfg, _lm_tree(params_np, cfg, dev), trainable=trainable)


def adam_state(state_np, cfg, device: torch.device | str = "cuda"):
    """A ``train.optimizer.AdamState`` from the reference's: ``state_np``
    is its ``AdamState(step, mu, nu, ef_residual)`` (or a 4-tuple in that
    order) as numpy arrays; ``mu``, ``nu`` and a residual that is not
    None must have ``model_defs(cfg)``'s names and shapes (as in
    ``lm_params``). Moments in fp32, the step an int32 scalar."""
    from repro_torch.train import optimizer  # deferred: LM stack

    dev = ops.resolve_device(device)
    step, mu, nu, ef = state_np
    step = np.asarray(step)
    if step.shape != ():
        raise ValueError(f"{cfg.name}: opt state step has shape {step.shape}, want ()")
    return optimizer.AdamState(
        torch.as_tensor(np.array(step, np.int32), device=dev),
        _lm_tree(mu, cfg, dev, "mu"),
        _lm_tree(nu, cfg, dev, "nu"),
        None if ef is None else _lm_tree(ef, cfg, dev, "ef_residual"),
    )
