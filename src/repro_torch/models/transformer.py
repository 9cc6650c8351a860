"""Model assembly: the dense-body families of the zoo as one stack.

The port of ``repro.models.transformer`` for the families that share the
dense block body — embed -> residual blocks (pre-norm GQA attention +
(Swi)GLU MLP) -> final norm -> unembed:

  dense   standard decoder (stablelm / granite / phi3 / qwen1.5)
  vlm     decoder with prepended patch embeddings (llava-next)
  audio   encoder-only over frame embeddings (hubert)

``moe``, ``hybrid`` and ``ssm`` raise ``NotImplementedError``: they wait for
their own slices (ROADMAP §1).

``model_defs`` is the reference's ParamDef tree (the layer params stacked on
a leading "layers" axis), so ``base.init_params`` and ``convert.lm_params``
both give that layout. ``Transformer`` holds it for serving: the stack
becomes an ``nn.ModuleList`` with one entry per layer, and every weight the
reference casts to the activation dtype at each use is cast once (the norm
scales stay fp32, as the norms read them). The functions below take the
``Transformer``'s tree (``model.tree``: "layers" a sequence of per-layer
dicts).

Three entry points, matching the reference's shape kinds:
  forward()      full-sequence logits (train / prefill)
  init_state()   decode cache (bf16 KV caches stacked over layers)
  decode_step()  one token in, logits out, the cache written in place
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.models import attention, layers
from repro_torch.models.base import ParamDef, PyTree
from repro_torch.models.config import ArchConfig

Tensor = torch.Tensor

DENSE_BODY = ("dense", "vlm", "audio")
_LATER = {
    "moe": "ROADMAP §1 item 5, slice 1 (models/moe.py)",
    "hybrid": "ROADMAP §1 item 5, slice 2 (models/ssm.py)",
    "ssm": "ROADMAP §1 item 5, slice 2 (models/xlstm.py)",
}


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet ({_LATER[cfg.family]})"
        )
    if cfg.family not in DENSE_BODY:
        raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Param-def construction
# ---------------------------------------------------------------------------


def _stack_defs(defs: PyTree, n: int) -> PyTree:
    if isinstance(defs, dict):
        return {k: _stack_defs(v, n) for k, v in defs.items()}
    return ParamDef((n, *defs.shape), ("layers", *defs.axes), defs.init, defs.scale, defs.dtype)


def _attn_layer_defs(cfg) -> dict:
    return {
        "attn_norm": layers.rmsnorm_defs(cfg.d_model),
        "attn": attention.attn_defs(cfg),
        "mlp_norm": layers.rmsnorm_defs(cfg.d_model),
        "mlp": layers.mlp_defs(cfg),
    }


def model_defs(cfg: ArchConfig) -> dict:
    _check_family(cfg)
    d = cfg.d_model
    defs: dict = {"embed": layers.embed_defs(cfg), "final_norm": layers.rmsnorm_defs(d)}
    if cfg.frontend == "audio_frames":
        defs["frontend_proj"] = layers.linear_defs(cfg.frontend_dim, d, ("conv", "embed"))
    if cfg.frontend == "vision_patches":
        defs["patch_proj"] = layers.linear_defs(cfg.frontend_dim, d, ("conv", "embed"))
    defs["layers"] = _stack_defs(_attn_layer_defs(cfg), cfg.n_layers)
    return defs


# ---------------------------------------------------------------------------
# The module that holds the weights
# ---------------------------------------------------------------------------


def _unstack(stack: PyTree, i: int) -> PyTree:
    if isinstance(stack, dict):
        return {k: _unstack(v, i) for k, v in stack.items()}
    return stack[i]


def _as_module(tree: PyTree, dt: torch.dtype, norm: bool = False) -> nn.Module:
    """Nested dicts -> ModuleDicts, leaf dicts -> ParameterDicts (frozen).
    Every leaf but a norm's scale is cast to ``dt``."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(v if norm else v.to(dt), requires_grad=False)
            for k, v in tree.items()
        })
    return nn.ModuleDict({
        k: _as_module(v, dt, norm=k.endswith("norm")) for k, v in tree.items()
    })


class Transformer(nn.Module):
    """A dense-body model's weights, placed for serving.

    ``params`` is the reference's layout (``model_defs``: layer params
    stacked on a leading axis), from ``base.init_params`` or
    ``convert.lm_params``; the module holds them on their device, the layers
    as an ``nn.ModuleList``, cast to the activation dtype once."""

    def __init__(self, cfg: ArchConfig, params: PyTree):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        dt = layers.act_dt(cfg)
        top = {k: v for k, v in params.items() if k != "layers"}
        self.tree = _as_module(top, dt)
        self.tree["layers"] = nn.ModuleList(
            _as_module(_unstack(params["layers"], i), dt) for i in range(cfg.n_layers)
        )

    def forward(self, batch: dict, *, causal_mode: str = "blocklist", last_only: bool = False):
        return forward(self.tree, batch, self.cfg, causal_mode=causal_mode, last_only=last_only)

    def decode_step(self, token: Tensor, state: PyTree, length: int | Tensor):
        return decode_step(self.tree, token, state, length, self.cfg)

    def init_state(self, batch: int, max_len: int) -> PyTree:
        return init_state(self.cfg, batch, max_len, device=self.tree["final_norm"]["scale"].device)


# ---------------------------------------------------------------------------
# Block body
# ---------------------------------------------------------------------------


def _attn_mlp_body(lp, h, cfg, causal_mode):
    a, _ = attention.attention_block(
        lp["attn"], layers.rmsnorm(lp["attn_norm"], h), cfg, causal_mode=causal_mode
    )
    h = h + a
    return h + layers.mlp(lp["mlp"], layers.rmsnorm(lp["mlp_norm"], h), cfg.mlp_kind)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def embed_inputs(params: Any, batch: dict, cfg: ArchConfig) -> Tensor:
    """Token / frame / patch embedding -> (B, S, d) activations."""
    dt = layers.act_dt(cfg)
    if cfg.family == "audio":
        return layers.linear(params["frontend_proj"], batch["frames"].to(dt))
    if cfg.family == "vlm":
        patches = layers.linear(params["patch_proj"], batch["patches"].to(dt))
        tok = layers.embed(params["embed"], batch["tokens"], cfg)
        return torch.cat([patches, tok], dim=1)
    return layers.embed(params["embed"], batch["tokens"], cfg)


def forward(
    params: Any,
    batch: dict,
    cfg: ArchConfig,
    *,
    causal_mode: str = "blocklist",
    last_only: bool = False,
) -> tuple[Tensor, Tensor]:
    """Full-sequence forward. Returns (logits (B, S, vocab), aux_loss).

    ``last_only`` slices the hidden state to the final position BEFORE the
    unembed — serving prefill emits (B, 1, vocab) and the (B, S, vocab)
    logits tensor never exists."""
    h = embed_inputs(params, batch, cfg)
    for lp in params["layers"]:
        h = _attn_mlp_body(lp, h, cfg, causal_mode)
    if last_only:
        h = h[:, -1:]
    h = layers.rmsnorm(params["final_norm"], h)
    logits = layers.unembed(params["embed"], h, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


# ---------------------------------------------------------------------------
# Decode: state init + one-token step
# ---------------------------------------------------------------------------


def init_state(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device | str = "cuda") -> PyTree:
    """Decode state: the bf16 KV caches of every layer, stacked on a
    leading layer axis as in the reference ({"kv": {"k", "v"}} of shape
    (n_layers, batch, max_len, n_kv_heads, head_dim))."""
    _check_family(cfg)
    if cfg.family == "audio":
        raise ValueError(f"no decode state for family {cfg.family!r}")
    cache = attention.init_kv_cache(cfg, batch, max_len, device=device)
    return {"kv": {k: torch.zeros((cfg.n_layers, *x.shape), dtype=x.dtype, device=x.device)
                   for k, x in cache.items()}}


def decode_step(
    params: Any, token: Tensor, state: PyTree, length: int | Tensor, cfg: ArchConfig
) -> tuple[Tensor, PyTree]:
    """One decode step. token: (B, 1) int (or (B, 1, d_model) activations);
    length: tokens already cached. Returns (logits (B, 1, vocab), state),
    the state's caches written in place at ``length``."""
    h = layers.embed(params["embed"], token, cfg) if token.dim() == 2 else token
    kv = state["kv"]
    for i, lp in enumerate(params["layers"]):
        a, _ = attention.attention_block(
            lp["attn"],
            layers.rmsnorm(lp["attn_norm"], h),
            cfg,
            cache={"k": kv["k"][i], "v": kv["v"][i]},
            cache_length=length,
        )
        h = h + a
        h = h + layers.mlp(lp["mlp"], layers.rmsnorm(lp["mlp_norm"], h), cfg.mlp_kind)
    h = layers.rmsnorm(params["final_norm"], h)
    return layers.unembed(params["embed"], h, cfg), state
