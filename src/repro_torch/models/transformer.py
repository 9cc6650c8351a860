"""Model assembly: every architecture of the zoo as one composable stack.

The port of ``repro.models.transformer``. Families share a skeleton —
embed -> residual blocks -> final norm -> unembed — and differ only in the
block body:

  dense / vlm / audio   pre-norm GQA attention + (Swi)GLU MLP
  moe                   attention + capacity-dispatch MoE (optional dense L0)
  hybrid (zamba2)       Mamba2 backbone; a weight-SHARED attention+MLP block
                        is applied after every ``shared_attn_every`` layers
  ssm (xlstm)           groups of (slstm_every - 1) mLSTM + 1 sLSTM

``model_defs`` is the reference's ParamDef tree (layer params stacked on a
leading "layers" axis, twice — (groups, per group, ...) — for hybrid and
ssm), so ``base.init_params`` and ``convert.lm_params`` both give that
layout. ``Transformer`` holds it in one of two ways:

  serving     each stack becomes nested ``nn.ModuleList``s with one entry
              per layer, and every weight the reference casts to the
              activation dtype at each use is cast once; the leaves it
              reads in fp32 stay fp32 (``serving_dtype``);
  trainable   each leaf is ONE fp32 ``nn.Parameter`` in the reference's
              layout, stacks included; the forward takes per-layer views
              of each stack, all of them from one ``stack.unbind(0)`` (so
              the gradients land in the stacked leaves, leaf for leaf with
              the optimizer's state, and a stack's gradient is its layers'
              stacked once, never a zero-padded stack per layer) and casts
              each weight to the activation dtype at each use.
              ``cfg.remat`` wraps the layer bodies the reference wraps in
              ``jax.checkpoint`` in ``torch.utils.checkpoint``.

The functions below take the ``Transformer``'s tree (``model.tree``, or
for the trainable holding its per-layer views).

Three entry points, matching the reference's shape kinds:
  forward()      full-sequence logits (train / prefill) and the MoE aux loss
  init_state()   decode state (KV caches / SSM states / conv histories),
                 stacked over layers as in the reference
  decode_step()  one token in, logits out, the state written in place
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention, layers, moe, ssm, xlstm
from repro_torch.models import base, collectives
from repro_torch.models.base import ParamDef, PyTree
from repro_torch.models.config import ArchConfig

Tensor = torch.Tensor

DENSE_BODY = ("dense", "vlm", "audio")
FAMILIES = (*DENSE_BODY, "moe", "hybrid", "ssm")
# Leaves the reference reads in fp32 without a cast (besides the norms'
# scales), by their block and name: Mamba2's A_log, D, dt_bias and sLSTM's
# recurrent matrix r.
FP32_LEAVES = frozenset({("mamba", "A_log"), ("mamba", "D"), ("mamba", "dt_bias"), ("slstm", "r")})


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
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

    if cfg.family in DENSE_BODY:
        defs["layers"] = _stack_defs(_attn_layer_defs(cfg), cfg.n_layers)
    elif cfg.family == "moe":
        moe_layer = {
            "attn_norm": layers.rmsnorm_defs(d),
            "attn": attention.attn_defs(cfg),
            "mlp_norm": layers.rmsnorm_defs(d),
            "moe": moe.moe_defs(cfg),
        }
        defs["layers"] = _stack_defs(moe_layer, _n_moe(cfg))
        if cfg.first_layer_dense:
            defs["layer0"] = {
                "attn_norm": layers.rmsnorm_defs(d),
                "attn": attention.attn_defs(cfg),
                "mlp_norm": layers.rmsnorm_defs(d),
                "mlp": layers.mlp_defs(cfg, cfg.d_ff or 4 * d),
            }
    elif cfg.family == "hybrid":
        groups, per = cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every
        mamba_layer = {"norm": layers.rmsnorm_defs(d), "mamba": ssm.mamba2_defs(cfg)}
        defs["layers"] = _stack_defs(_stack_defs(mamba_layer, per), groups)
        defs["shared"] = _attn_layer_defs(cfg)  # ONE block, applied `groups` times
    else:  # ssm
        groups, per_m = cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1
        m_layer = {"norm": layers.rmsnorm_defs(d), "mlstm": xlstm.mlstm_defs(cfg)}
        s_layer = {"norm": layers.rmsnorm_defs(d), "slstm": xlstm.slstm_defs(cfg)}
        defs["layers"] = _stack_defs(_stack_defs(m_layer, per_m), groups)
        defs["slstm_layers"] = _stack_defs(s_layer, groups)
    return defs


def _n_moe(cfg: ArchConfig) -> int:
    return cfg.n_layers - (1 if cfg.first_layer_dense else 0)


def serving_dtype(cfg: ArchConfig) -> Callable[[tuple[str, ...]], torch.dtype]:
    """The dtype a leaf is held in for serving, by its key path: fp32 for
    a norm's scale and the ``FP32_LEAVES``, the activation dtype for every
    other leaf (the reference casts those to it at each use)."""
    act = layers.act_dt(cfg)

    def dtype_of(path: tuple[str, ...]) -> torch.dtype:
        if tuple(path[-2:]) in FP32_LEAVES or (len(path) > 1 and path[-2].endswith("norm")):
            return torch.float32
        return act

    return dtype_of


# ---------------------------------------------------------------------------
# The module that holds the weights
# ---------------------------------------------------------------------------


class Node(nn.Module):
    """One dict of the reference's tree: tensors as frozen parameters,
    sub-dicts as child modules, read as ``node[key]``."""

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def _unstack(stack: PyTree, i: int) -> PyTree:
    if isinstance(stack, dict):
        return {k: _unstack(v, i) for k, v in stack.items()}
    return stack[i]


def _first_leaf(tree: PyTree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _place(tree: PyTree, dtype_of, path: tuple[str, ...], depth: int) -> nn.Module:
    """``tree`` as modules: ``depth`` stacked axes become nested
    ``ModuleList``s (a view per layer, no copy), dicts ``Node``s, leaves
    frozen parameters cast to ``dtype_of(path)``."""
    if depth:
        n = _first_leaf(tree).shape[0]
        return nn.ModuleList(_place(_unstack(tree, i), dtype_of, path, depth - 1) for i in range(n))
    node = Node()
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            node.add_module(k, _place(v, dtype_of, (*path, k), 0))
        else:
            node.register_parameter(k, nn.Parameter(v.to(dtype_of((*path, k))), requires_grad=False))
    return node


def _hold(tree: PyTree) -> Node:
    """``tree`` as ``Node``s of trainable fp32 parameters, stacks whole."""
    node = Node()
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            node.add_module(k, _hold(v))
        else:
            node.register_parameter(k, nn.Parameter(v.detach().to(torch.float32)))
    return node


def _as_dict(node: Node) -> dict:
    """A ``Node`` of parameters as the reference's nested dicts."""
    out = {k: _as_dict(m) for k, m in node._modules.items()}
    out.update(node._parameters)
    return {k: out[k] for k in sorted(out)}


def _views(tree: PyTree, depth: int, wrap: Callable | None = None):
    """``depth`` stacked axes of ``tree`` as nested lists of per-layer
    dicts of views, each leaf unbound once (``leaf.unbind(0)``: no copy,
    one backward node per stack, which stacks the layers' gradients once);
    ``wrap`` maps each innermost dict."""
    if not depth:
        return tree if wrap is None else wrap(tree)
    paths = _paths(tree)
    cols = [leaf.unbind(0) for _, leaf in paths]
    return [_views(base.tree_unflatten(tree, [c[i] for c in cols]), depth - 1, wrap)
            for i in range(len(cols[0]))]


class _LayerShards:
    """One layer's leaves as this rank's blocks (per-layer views of the
    local stack ``key``) and the ``ShardedTransformer`` that gathers them;
    a body gathers them whole as it starts (``_whole``)."""

    __slots__ = ("local", "key", "model")

    def __init__(self, local: dict, key: str, model):
        self.local, self.key, self.model = local, key, model


def _whole(lp):
    """A layer's leaves whole: gathered when ``lp`` holds shards, else
    ``lp`` itself (a single-process view or a serving ``Node``)."""
    if isinstance(lp, _LayerShards):
        return lp.model.gather_layer(lp.local, lp.key)
    return lp


class Transformer(nn.Module):
    """A model's weights, placed for serving or held for training.

    ``params`` is the reference's layout (``model_defs``: layer params
    stacked on leading axes), from ``base.init_params`` or
    ``convert.lm_params``; the module holds them on their device.

    Serving (the default): each stack as nested ``nn.ModuleList``s (moe:
    ``layer0`` and the MoE layers; hybrid: groups of Mamba2 layers and the
    ``shared`` block; ssm: groups of mLSTM layers and ``slstm_layers``),
    each leaf a frozen parameter in its ``serving_dtype`` (a cast only
    where it is not held so already).

    ``trainable=True``: each leaf one fp32 ``nn.Parameter`` with
    ``requires_grad``, stacks whole (``param_tree``); the forward runs on
    per-layer views of the stacks (``_views``) and honours ``cfg.remat``."""

    def __init__(self, cfg: ArchConfig, params: PyTree, *, trainable: bool = False):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.trainable = trainable
        defs = model_defs(cfg)
        dtype_of = serving_dtype(cfg)
        self.tree = Node()
        self._depth = {k: _first_leaf(defs[k]).axes.count("layers") for k in params}
        for k in sorted(params):
            if trainable:
                self.tree.add_module(k, _hold(params[k]))
            else:
                self.tree.add_module(k, _place(params[k], dtype_of, (k,), self._depth[k]))

    def param_tree(self) -> dict:
        """The trainable holding's parameters as the reference's tree
        (nested dicts, stacked leaves, sorted keys)."""
        if not self.trainable:
            raise ValueError("param_tree needs the trainable holding (trainable=True)")
        return _as_dict(self.tree)

    @torch.no_grad()
    def load_param_tree(self, params: PyTree) -> None:
        """Copy ``params`` (the reference's tree, any device and float
        dtype) into the trainable holding's parameters, leaf for leaf."""
        want, leaves = _paths(self.param_tree()), base.tree_leaves(params)
        if len(leaves) != len(want):
            raise ValueError(f"{len(leaves)} leaves given, the model holds {len(want)}")
        for (path, p), v in zip(want, leaves):
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)} has shape {tuple(v.shape)}, want {tuple(p.shape)}")
            p.copy_(v)

    def _params(self):
        if not self.trainable:
            return self.tree
        return {k: _views(v, self._depth[k]) for k, v in self.param_tree().items()}

    def forward(self, batch: dict, *, causal_mode: str = "blocklist", last_only: bool = False):
        return forward(self._params(), batch, self.cfg, causal_mode=causal_mode,
                       last_only=last_only, remat=self.trainable)

    def decode_step(self, token: Tensor, state: PyTree, length: int | Tensor):
        return decode_step(self._params(), token, state, length, self.cfg)

    def init_state(self, batch: int, max_len: int) -> PyTree:
        return init_state(self.cfg, batch, max_len, device=self.tree["final_norm"]["scale"].device)


def _paths(tree: PyTree, path: tuple[str, ...] = ()) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], (*path, k))]
    return [(path, tree)]


def _layer_placement(placements: tuple, depth: int) -> tuple:
    """A stacked leaf's placements for one of its layers: the leading
    ``depth`` "layers" dims (never sharded) dropped."""
    from torch.distributed.tensor import Shard

    assert not any(p.is_shard() and p.dim < depth for p in placements), placements
    return tuple(Shard(p.dim - depth) if p.is_shard() else p for p in placements)


def _zip_map(fn, a: PyTree, b: PyTree) -> PyTree:
    """``fn(x, y)`` over the leaves of two nested dicts of one structure."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in sorted(a)}
    return fn(a, b)


# The Mamba2 and xLSTM mixers' blocks: split along "model" where it
# divides their inner width (``ssm.mixer_split``), else gathered whole.
MIXERS = frozenset({"mamba", "mlstm", "slstm"})


class ShardedTransformer(Transformer):
    """The trainable holding over a device mesh: each leaf is this rank's
    shard, placed by ``base.make_shardings(model_defs(cfg), mesh, rules)``.

    ``params`` is the full tree (the reference's layout), the same on every
    rank; each rank keeps a copy of its block of every leaf, so the
    parameters, their gradients and every optimizer state built from
    ``param_tree()`` hold only this rank's shards. The forward computes on
    the rank's batch rows under ``base.use_mesh(mesh, act_rules, split)``
    (``decode_step`` too) and holds at most one layer's leaves gathered:
    the leaves outside the layer stacks (``embed``, ``final_norm``,
    ``layer0``, ``shared``, the frontends) are gathered once, and each
    stack is handed down as per-layer views of this rank's blocks, which
    each layer body gathers as it starts (``gather_layer``) and drops when
    it ends. Under remat "full" and "dots" autograd keeps only the blocks,
    and the recompute gathers again (every rank recomputes in the same
    order, so the collectives stay matched); under remat "none" the
    gathered leaves are saved for the backward, as any saved input.

    The gathers run along the batch axes. Under "tp" (``split``) every dim
    the rules shard over "model" stays this rank's block, and the blocks
    compute their share (``collectives.model_split``): attention by heads,
    the MLPs and shared experts by column and row, routed experts by
    expert (or by column where "model" does not divide them), the Mamba2
    and xLSTM mixers by head and inner column (``ssm.mamba2_share``,
    ``xlstm.mlstm_share``, ``xlstm.slstm_share``), embedding, logits and
    cross entropy by vocabulary row; one all-reduce over "model"
    completes each. A mixer whose inner width "model" does not divide
    (``ssm.mixer_split``) is gathered whole and computed whole. Under
    "fsdp" and "fsdp_sp", where "model" carries batch, every leaf is
    gathered whole.
    The backward takes each gradient straight to this rank's block, summed
    over the batch axes (``collectives.LayerGather``: reduce-scatters along
    batch axes that shard a leaf), as soon as its layer's backward is done.

    Under "tp" the full-sequence forward returns this rank's vocabulary
    columns of the logits (``logits_split``), which the mesh loss takes as
    they are (``collectives.vocab_nll``); the serving entry points
    (``last_only``, ``decode_step``) gather them whole, the KV caches
    of ``init_state`` hold the rank's kv heads where the attention is split
    by heads (``kv_split``), and the recurrent states the rank's share of
    each mixer (``init_state``). ``profile`` picks the parameter rules, the
    activation rules and the batch axes (``base.rules_for_profile``: "tp",
    "fsdp" or "fsdp_sp")."""

    def __init__(self, cfg: ArchConfig, params: PyTree, mesh, *, profile: str = "tp"):
        rules, act_rules, batch_axes = base.rules_for_profile(profile)
        shardings = base.make_shardings(model_defs(cfg), mesh, rules)
        placements = {k: shardings[k] for k in sorted(params)}
        local = _zip_map(lambda t, pl: collectives.shard_local(t.detach(), pl, mesh).clone(),
                         params, placements)
        super().__init__(cfg, local, trainable=True)
        self.mesh = mesh
        self.placements = placements
        self.act_rules = act_rules
        self.split = act_rules.get("act_model") is not None and "model" in base.axis_sizes(mesh)
        self.batch_axes = tuple(a for a in batch_axes if a in base.axis_sizes(mesh))
        self.batch_groups = collectives.axis_groups(mesh, self.batch_axes)
        self.shards = collectives.LeafShards(mesh, [pl for _, pl in _paths(placements)])
        outside = {k: placements[k] for k in placements if not self._depth[k]}
        self._outside = collectives.LayerGather(outside, mesh, self.batch_axes, self._keep(outside))
        self._layer_gathers: dict[str, collectives.LayerGather] = {}

    def _keep(self, placements: dict) -> dict:
        """{leaf path: ("model",)} for the leaves kept as this rank's block
        along "model": under the split, every leaf but those of a mixer
        that is computed whole (``ssm.mixer_split``)."""
        if not self.split:
            return {}
        whole = frozenset() if ssm.mixer_split(self.cfg, self.model_axis) else MIXERS
        return {p: ("model",) for p, _ in _paths(placements) if not whole & set(p)}

    @property
    def model_axis(self):
        """The split along "model" (a ``collectives.Split``), or None."""
        return collectives.Split.of(self.mesh) if self.split else None

    @property
    def logits_split(self):
        """The ``collectives.Split`` whose vocabulary columns the full-sequence
        logits are, or None when they are whole."""
        sp = self.model_axis
        return sp if sp is not None and sp.splits(self.cfg.vocab) else None

    @property
    def kv_split(self):
        """This rank's ``attention.HeadSplit``, or None when every rank
        computes the attention whole."""
        sp = self.model_axis
        return None if sp is None else attention.head_split(self.cfg, sp.size, sp.rank)

    def _params(self):
        tree = self.param_tree()
        out = self._outside({k: v for k, v in tree.items() if not self._depth[k]})
        for k in tree:
            if self._depth[k]:
                out[k] = _views(tree[k], self._depth[k], lambda lp, k=k: _LayerShards(lp, k, self))
        return {k: out[k] for k in sorted(out)}

    def gather_layer(self, local: dict, key: str) -> dict:
        """One layer of stack ``key`` gathered from this rank's blocks: whole
        along the batch axes, and under the split still this rank's block
        along "model" (``_keep``)."""
        gather = self._layer_gathers.get(key)
        if gather is None:
            depth = self._depth[key]
            placements = base.tree_map(lambda pl: _layer_placement(pl, depth), self.placements[key])
            gather = self._layer_gathers[key] = collectives.LayerGather(placements, self.mesh, self.batch_axes,
                                                                         self._keep(placements))
        return gather(local)

    def forward(self, batch: dict, *, causal_mode: str = "blocklist", last_only: bool = False):
        with base.use_mesh(self.mesh, self.act_rules, self.split):
            return super().forward(batch, causal_mode=causal_mode, last_only=last_only)

    def decode_step(self, token: Tensor, state: PyTree, length: int | Tensor):
        with base.use_mesh(self.mesh, self.act_rules, self.split):
            return super().decode_step(token, state, length)

    def init_state(self, batch: int, max_len: int) -> PyTree:
        """This rank's decode state for ``batch`` rows: its kv heads in the
        KV caches where the attention is split by heads (``kv_split``), and
        under the split its share of each recurrent state (``init_state``'s
        ``split``)."""
        hs = self.kv_split
        return init_state(self.cfg, batch, max_len, device=self.tree["final_norm"]["scale"].device,
                          kv_heads=None if hs is None else hs.cache_heads(self.cfg),
                          split=self.model_axis)

    def shard_tree(self, tree: PyTree) -> PyTree:
        """This rank's shards of a full tree in the parameters' layout."""
        return _zip_map(lambda t, pl: collectives.shard_local(t, pl, self.mesh), tree, self.placements)

    @torch.no_grad()
    def gather_tree(self, tree: PyTree) -> PyTree:
        """The full tree from every rank's shards of a tree in the
        parameters' layout (``param_tree()``, ``mu``, ``nu``, a residual);
        every rank calls it."""
        return _zip_map(lambda t, pl: collectives.gather_full(t, pl, self.mesh), tree, self.placements)

    def full_param_tree(self) -> dict:
        """The parameters whole (every rank calls it)."""
        return self.gather_tree(self.param_tree())

    def load_param_tree(self, params: PyTree) -> None:
        """Copy this rank's shards of ``params`` (the full tree) in."""
        super().load_param_tree(self.shard_tree(params))


# ---------------------------------------------------------------------------
# Block bodies
# ---------------------------------------------------------------------------


# The matmuls with no batch dimension, the outputs remat="dots" keeps
# (``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``): every
# ``x @ w`` reaches aten as ``mm``/``addmm``; the attention einsums and the
# experts' products are batched (``bmm``) and recomputed.
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(f: Callable, cfg: ArchConfig, on: bool) -> Callable:
    """``f`` under ``cfg.remat`` when ``on`` and autograd records:
    "full" recomputes the whole body in the backward pass, "dots" keeps
    the unbatched matmul outputs and recomputes the rest, "none" keeps
    everything. The recompute runs under the mesh and activation rules
    that were current when the body was called (the backward pass runs
    after the forward's ``base.use_mesh`` has exited), so it takes the
    forward's branches: the MoE's expert-parallel dispatch, ``shard_act``."""
    if not on or cfg.remat == "none" or not torch.is_grad_enabled():
        return f
    kw = {"use_reentrant": False, "preserve_rng_state": False}  # the bodies draw no random numbers
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dots)

    def under_mesh(entry, *args):
        with base.use_mesh(*entry):
            return f(*args)

    def run(*args):
        return ckpt.checkpoint(under_mesh, base.current_mesh_entry(), *args, **kw)

    return run


def _d_ff(cfg: ArchConfig) -> int:
    """The hidden width of a dense MLP of the model (``layer0``'s, ``model_defs``)."""
    return cfg.d_ff or 4 * cfg.d_model


def _attn_mlp_body(lp, h, cfg, causal_mode):
    lp = _whole(lp)
    a, _ = attention.attention_block(
        lp["attn"], layers.rmsnorm(lp["attn_norm"], h), cfg, causal_mode=causal_mode
    )
    h = h + a
    h = h + layers.mlp(lp["mlp"], layers.rmsnorm(lp["mlp_norm"], h), cfg.mlp_kind, _d_ff(cfg))
    return base.shard_act(h, ("act_batch", "act_seq", None))


def _moe_body(lp, h, aux, cfg, causal_mode):
    lp = _whole(lp)
    a, _ = attention.attention_block(
        lp["attn"], layers.rmsnorm(lp["attn_norm"], h), cfg, causal_mode=causal_mode
    )
    h = h + a
    y, aux_l = moe.moe_block(lp["moe"], layers.rmsnorm(lp["mlp_norm"], h), cfg)
    return base.shard_act(h + y, ("act_batch", "act_seq", None)), aux + aux_l


def _mamba_body(lp, h, cfg):
    lp = _whole(lp)
    y, _ = ssm.mamba2_block(lp["mamba"], layers.rmsnorm(lp["norm"], h), cfg)
    return base.shard_act(h + y, ("act_batch", "act_seq", None))


def _mlstm_body(lp, h, cfg):
    lp = _whole(lp)
    y, _ = xlstm.mlstm_block(lp["mlstm"], layers.rmsnorm(lp["norm"], h), cfg)
    return base.shard_act(h + y, ("act_batch", "act_seq", None))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def embed_inputs(params: Any, batch: dict, cfg: ArchConfig) -> Tensor:
    """Token / frame / patch embedding -> (B, S, d) activations."""
    dt = layers.act_dt(cfg)
    if cfg.family == "audio":
        h = layers.linear(params["frontend_proj"], batch["frames"].to(dt))
    elif cfg.family == "vlm":
        patches = layers.linear(params["patch_proj"], batch["patches"].to(dt))
        tok = layers.embed(params["embed"], batch["tokens"], cfg)
        h = torch.cat([patches, tok], dim=1)
    else:
        h = layers.embed(params["embed"], batch["tokens"], cfg)
    return base.shard_act(h, ("act_batch", "act_seq", None))


def forward(
    params: Any,
    batch: dict,
    cfg: ArchConfig,
    *,
    causal_mode: str = "blocklist",
    last_only: bool = False,
    remat: bool = False,
) -> tuple[Tensor, Tensor]:
    """Full-sequence forward. Returns (logits (B, S, vocab), aux_loss: the
    MoE layers' load-balance losses summed, 0 for the other families).

    ``last_only`` slices the hidden state to the final position BEFORE the
    unembed — serving prefill emits (B, 1, vocab) and the (B, S, vocab)
    logits tensor never exists. ``remat``: wrap the bodies the reference
    wraps (every layer of a dense body, every MoE layer, every Mamba2 and
    mLSTM layer; not layer 0, the shared block or sLSTM) as ``cfg.remat``
    says, while autograd records."""
    h = embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family in DENSE_BODY:
        body = _remat(_attn_mlp_body, cfg, remat)
        for lp in params["layers"]:
            h = body(lp, h, cfg, causal_mode)
    elif cfg.family == "moe":
        if cfg.first_layer_dense:
            h = _attn_mlp_body(params["layer0"], h, cfg, causal_mode)
        body = _remat(_moe_body, cfg, remat)
        for lp in params["layers"]:
            h, aux = body(lp, h, aux, cfg, causal_mode)
    elif cfg.family == "hybrid":
        body = _remat(_mamba_body, cfg, remat)
        for glp in params["layers"]:
            for lp in glp:
                h = body(lp, h, cfg)
            h = _attn_mlp_body(params["shared"], h, cfg, causal_mode)
    else:  # ssm
        body = _remat(_mlstm_body, cfg, remat)
        for glp, slp in zip(params["layers"], params["slstm_layers"]):
            for lp in glp:
                h = body(lp, h, cfg)
            slp = _whole(slp)
            y, _ = xlstm.slstm_block(slp["slstm"], layers.rmsnorm(slp["norm"], h), cfg)
            h = base.shard_act(h + y, ("act_batch", "act_seq", None))
    if last_only:
        h = h[:, -1:]
    h = layers.rmsnorm(params["final_norm"], h)
    logits = layers.unembed(params["embed"], h, cfg)
    return (_whole_logits(logits, cfg) if last_only else logits), aux


def _whole_logits(logits: Tensor, cfg: ArchConfig) -> Tensor:
    """Serving's logits whole: under a split of the vocabulary the ranks'
    columns gathered along "model" (each rank's downstream is the same, so
    the gradient of its columns is its own)."""
    sp = layers.vocab_split(cfg)
    return logits if sp is None else collectives.gather_last(logits, sp.group, partial=False)


# ---------------------------------------------------------------------------
# Decode: state init + one-token step
# ---------------------------------------------------------------------------


def _stacked(x: Tensor, *lead: int) -> Tensor:
    return torch.zeros((*lead, *x.shape), dtype=x.dtype, device=x.device)


def init_state(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device | str = "cuda", kv_heads: int | None = None,
               split: collectives.Split | None = None) -> PyTree:
    """Decode state, the reference's pytree with its shapes and dtypes:
      dense / vlm  {"kv": {"k", "v"}} (n_layers, batch, max_len, n_kv_heads,
                   head_dim) bf16
      moe          "kv" over the MoE layers, plus "kv0" for a dense layer 0
      hybrid       {"mamba": {"conv" (groups, per, batch, W-1, C) bf16,
                   "ssd" (groups, per, batch, H, N, P) fp32}, "kv" (groups, ...)}
      ssm          {"mlstm": (groups, per_m, batch, H, dh, dh+1) fp32,
                   "slstm": (c, h), each (groups, batch, H, dh) fp32}
    ``kv_heads``: the kv heads each KV cache holds (a rank's share under a
    split, ``ShardedTransformer.init_state``; default every one).
    ``split``: the rank's ``collectives.Split`` along "model", whose share
    of each recurrent state it holds where the mixers split
    (``ssm.mixer_split``); rank r of m owns the columns [r·d_in/m,
    (r+1)·d_in/m) of d_in and the heads [h0, h1) they touch:
      Mamba2  "conv" (..., W-1, (h1-h0)·P + 2N): its heads' x channels,
              then B and C (every head reads them); "ssd" (..., h1-h0,
              N, P)
      mLSTM   (..., h1-h0, dh, dv+1): its heads' matrix memories, dv their
              value columns (dh, or its columns inside one head, m / H of
              them) plus the normalizer
      sLSTM   (c, h), each (..., H/m, dh) where m divides H, else
              (..., H, dh): the recurrence whole on every rank."""
    _check_family(cfg)
    if cfg.family in ("dense", "vlm", "moe"):
        cache = attention.init_kv_cache(cfg, batch, max_len, device=device, kv_heads=kv_heads)
        n = _n_moe(cfg) if cfg.family == "moe" else cfg.n_layers
        out = {"kv": {k: _stacked(x, n) for k, x in cache.items()}}
        if cfg.family == "moe" and cfg.first_layer_dense:
            out["kv0"] = attention.init_kv_cache(cfg, batch, max_len, device=device, kv_heads=kv_heads)
        return out
    if cfg.family == "hybrid":
        groups, per = cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every
        ms = ssm.mamba2_state_init(cfg, batch, device=device, sp=split)
        kv = attention.init_kv_cache(cfg, batch, max_len, device=device, kv_heads=kv_heads)
        return {"mamba": {k: _stacked(x, groups, per) for k, x in ms.items()},
                "kv": {k: _stacked(x, groups) for k, x in kv.items()}}
    if cfg.family == "ssm":
        groups, per_m = cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1
        m = xlstm.mlstm_state_init(cfg, batch, device=device, sp=split)
        s = xlstm.slstm_state_init(cfg, batch, device=device, sp=split)
        return {"mlstm": _stacked(m, groups, per_m), "slstm": tuple(_stacked(x, groups) for x in s)}
    raise ValueError(f"no decode state for family {cfg.family!r}")


def _attn_decode_body(lp, h, kv, length, cfg):
    lp = _whole(lp)
    a, _ = attention.attention_block(
        lp["attn"], layers.rmsnorm(lp["attn_norm"], h), cfg, cache=kv, cache_length=length
    )
    h = h + a
    if "mlp" in lp:
        return h + layers.mlp(lp["mlp"], layers.rmsnorm(lp["mlp_norm"], h), cfg.mlp_kind, _d_ff(cfg))
    y, _ = moe.moe_block(lp["moe"], layers.rmsnorm(lp["mlp_norm"], h), cfg)
    return h + y


def decode_step(
    params: Any, token: Tensor, state: PyTree, length: int | Tensor, cfg: ArchConfig
) -> tuple[Tensor, PyTree]:
    """One decode step. token: (B, 1) int (or (B, 1, d_model) activations);
    length: tokens already cached. Returns (logits (B, 1, vocab), state):
    each KV cache written in place at ``length``, each recurrent state
    overwritten in place with its next value. Mamba2's conv history is
    returned in the activation dtype, as the reference's step returns it:
    at act fp32 the bf16 history of ``init_state`` is replaced by an fp32
    one on the first step."""
    h = layers.embed(params["embed"], token, cfg) if token.dim() == 2 else token
    h = base.shard_act(h, ("act_batch", "act_seq", None))

    def kv_at(kv: dict, i: int) -> dict:
        return {"k": kv["k"][i], "v": kv["v"][i]}

    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.family == "moe" and cfg.first_layer_dense:
            h = _attn_decode_body(params["layer0"], h, state["kv0"], length, cfg)
        for i, lp in enumerate(params["layers"]):
            h = _attn_decode_body(lp, h, kv_at(state["kv"], i), length, cfg)
    elif cfg.family == "hybrid":
        mamba = state["mamba"]
        if mamba["conv"].dtype != h.dtype:
            mamba["conv"] = mamba["conv"].to(h.dtype)
        conv, ssd = mamba["conv"], mamba["ssd"]
        for g, glp in enumerate(params["layers"]):
            for i, lp in enumerate(glp):
                lp = _whole(lp)
                y, st = ssm.mamba2_block(lp["mamba"], layers.rmsnorm(lp["norm"], h), cfg,
                                         state={"conv": conv[g, i], "ssd": ssd[g, i]})
                conv[g, i] = st["conv"]
                ssd[g, i] = st["ssd"]
                h = h + y
            h = _attn_decode_body(params["shared"], h, kv_at(state["kv"], g), length, cfg)
    elif cfg.family == "ssm":
        m, (c, hs) = state["mlstm"], state["slstm"]
        for g, (glp, slp) in enumerate(zip(params["layers"], params["slstm_layers"])):
            for i, lp in enumerate(glp):
                lp = _whole(lp)
                y, m[g, i] = xlstm.mlstm_block(lp["mlstm"], layers.rmsnorm(lp["norm"], h), cfg,
                                               state=m[g, i])
                h = h + y
            slp = _whole(slp)
            y, (c[g], hs[g]) = xlstm.slstm_block(slp["slstm"], layers.rmsnorm(slp["norm"], h), cfg,
                                                 state=(c[g], hs[g]))
            h = h + y
    else:
        raise ValueError(f"no decode state for family {cfg.family!r}")
    h = layers.rmsnorm(params["final_norm"], h)
    return _whole_logits(layers.unembed(params["embed"], h, cfg), cfg), state
