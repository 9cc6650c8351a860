"""The rank side of ``tests/test_torch_mesh.py``: the jobs each rank of the
4-rank gloo world runs. This module imports neither ``jax`` nor ``repro``
(a spawned rank imports it afresh), and every rank calls ``rank_main``.
"""
import dataclasses
import datetime
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, convert
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as train_lib
from repro_torch.models import base, collectives, moe, transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

WORLD = 4
TIMEOUT_S = 300  # per rank


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _leaves(tree) -> list:
    return [_np(t) for t in base.tree_leaves(tree)]


def dp_tp_job(spec: dict) -> dict:
    """Reduced stablelm-3b on a (2, 2) ("data", "model") mesh: the
    spec's steps from its weights on ``device_batch`` rows, for each of
    its variants (``n_micro``, ``compress_grads``, the sharding profile)."""
    cfg = dataclasses.replace(configs.get_reduced(spec["arch"]), act_dtype="float32")
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=spec["seq"], global_batch=spec["batch"]))
    out = {}
    for variant, (n_micro, compress, profile) in spec["variants"].items():
        full = convert.lm_params(spec["params"], cfg, "cpu", trainable=True).param_tree()
        model = transformer.ShardedTransformer(cfg, full, mesh, profile=profile)
        ocfg = opt.OptConfig(**spec["opt"], compress_grads=compress)
        state = opt.init_opt_state(model.param_tree(), ocfg)
        step = ts.make_mesh_train_step(cfg, ocfg, ts.StepConfig(n_micro=n_micro))
        metrics, counts = [], []
        for i in range(spec["steps"]):
            collectives.reset_collective_counts()
            model, state, m = step(model, state, pipe.device_batch(i, mesh, model.batch_axes))
            counts.append(collectives.collective_counts())
            metrics.append({k: float(v) for k, v in m.items()})
        out[variant] = {
            "metrics": metrics,
            "collectives": counts,
            "shapes": {"/".join(p): tuple(t.shape) for p, t in transformer._paths(model.param_tree())},
            "state_shapes": [[tuple(t.shape) for t in base.tree_leaves(x)]
                             for x in (state.mu, state.nu, state.ef_residual)],
            "params": _leaves(model.full_param_tree()),
            "numel": sum(t.numel() for t in model.parameters()),
            "coord": tuple(mesh.get_coordinate()),
        }
    return out


def moe_remat_job(spec: dict) -> dict:
    """Reduced deepseek-moe-16b under each of the spec's ``remat`` modes on
    a (2, 2) ("data", "model") mesh ("tp" profile: the expert-parallel
    branch over "model"), the spec's steps from a seeded draw on
    ``device_batch`` rows: the metrics and final parameters of each."""
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for remat in spec["remats"]:
        cfg = dataclasses.replace(configs.get_reduced(spec["arch"]), **spec["cfg"], remat=remat)
        pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=spec["seq"], global_batch=spec["batch"]))
        full = train_lib.build_model(cfg, seed=spec["seed"], device="cpu").param_tree()
        model = transformer.ShardedTransformer(cfg, full, mesh, profile="tp")
        ocfg = opt.OptConfig(**spec["opt"])
        state = opt.init_opt_state(model.param_tree(), ocfg)
        step = ts.make_mesh_train_step(cfg, ocfg, ts.StepConfig(aux_weight=spec["aux_weight"]))
        metrics = []
        for i in range(spec["steps"]):
            model, state, m = step(model, state, pipe.device_batch(i, mesh, model.batch_axes))
            metrics.append({k: float(v) for k, v in m.items()})
        out[remat] = {"metrics": metrics, "params": _leaves(model.full_param_tree())}
    return out


def moe_aux_job(spec: dict) -> dict:
    """The MoE's local path under the "fsdp" profile on a (2, 2) mesh
    (batch rows over all 4 ranks; "model" carries batch, so no expert
    parallelism): (a) one gradient of the mesh loss of reduced
    deepseek-moe-16b at the spec's ``aux_weight``: loss, aux, the
    collectives of the step, and the routed weights' gradients gathered
    whole; (b) ``moe_block`` on this rank's rows of the spec's block
    inputs: output, aux, the collectives of the forward, and this rank's
    share of the gradients of sum(y · cot) + c · aux."""
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = dataclasses.replace(configs.get_reduced(spec["arch"]), **spec["cfg"])
    pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=spec["seq"], global_batch=spec["batch"]))
    full = train_lib.build_model(cfg, seed=spec["seed"], device="cpu").param_tree()
    model = transformer.ShardedTransformer(cfg, full, mesh, profile="fsdp")
    scfg = ts.StepConfig(aux_weight=spec["aux_weight"])
    grad_fn = ts.make_grad_fn(cfg, scfg, ts.make_mesh_loss_fn(cfg, scfg))
    batch = {k: v.to_local() for k, v in pipe.device_batch(0, mesh, model.batch_axes).items()}
    collectives.reset_collective_counts()
    total, metrics, grads = grad_fn(model, batch)
    step_counts = collectives.collective_counts()
    whole = dict(transformer._paths(model.gather_tree(base.tree_unflatten(model.param_tree(), grads))))
    out = {"step": {"total": float(total), "loss": float(metrics["loss"]), "aux": float(metrics["aux"]),
                    "collectives": step_counts,
                    "grads": {"/".join(p): _np(g) for p, g in whole.items() if p[:2] == ("layers", "moe")
                              and p[2] in ("router", "gate", "up", "down")}}}
    blk = spec["block"]
    bcfg = dataclasses.replace(configs.get_reduced(spec["arch"]), **blk["cfg"])
    d, m = mesh.get_coordinate()
    rows = blk["x"].shape[0] // 4
    lo = (d * 2 + m) * rows  # the batch axes ("data", "model") split the rows major to minor
    params = base.tree_map(lambda a: torch.tensor(a, requires_grad=True), blk["params"])
    x = torch.tensor(blk["x"][lo : lo + rows], requires_grad=True)
    collectives.reset_collective_counts()
    with base.use_mesh(mesh, base.FSDP_ACT_RULES):
        y, aux = moe.moe_block(params, x, bcfg, group_size=blk["group_size"])
    fwd_counts = collectives.collective_counts()
    (y * torch.as_tensor(blk["cot"][lo : lo + rows])).sum().add(blk["aux_c"] * aux).backward()
    out["block"] = {"rows": (lo, lo + rows), "y": _np(y), "aux": float(aux.detach()), "collectives": fwd_counts,
                    "bwd_collectives": collectives.collective_counts(), "x_grad": _np(x.grad),
                    "grads": {k: _np(params[k].grad) for k in ("router", "gate", "up", "down")}}
    return out


class _GatherParam(torch.autograd.Function):
    """The whole-leaf gather the mesh step made before it gathered layer by
    layer, kept as the oracle: the forward gathers a leaf whole, the
    backward all-reduces the leaf's whole gradient over the batch axes and
    keeps this rank's shard of it."""

    @staticmethod
    def forward(ctx, local, placements, mesh, batch_groups):
        ctx.placements, ctx.mesh, ctx.batch_groups = placements, mesh, batch_groups
        return collectives.gather_full(local, placements, mesh)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        for grp in ctx.batch_groups:
            collectives._all_reduce(g, grp)
        return collectives.shard_local(g, ctx.placements, ctx.mesh).contiguous(), None, None, None


class _WholeGather(transformer.ShardedTransformer):
    """The mesh model with every leaf gathered whole before the forward
    (``_GatherParam``) and the stacks taken apart into whole layers. Its
    blocks compute what the mesh model's do (under "tp" the rank's share,
    cut from the whole leaves)."""

    def _params(self):
        full = transformer._zip_map(lambda p, pl: _GatherParam.apply(p, pl, self.mesh, self.batch_groups),
                                    self.param_tree(), self.placements)
        return {k: transformer._views(v, self._depth[k]) for k, v in full.items()}


class _Unsplit(_WholeGather):
    """The whole-leaf step as it was before the split: every leaf gathered
    whole and every rank computing the whole of each block on its rows
    (no share along "model"; the expert-parallel MoE as before)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.split = False


def grads_job(spec: dict) -> dict:
    """One gradient of the mesh loss on a (2, 2) mesh for each of the
    spec's (arch, profile) cells, from a seeded draw at act fp32: through
    the mesh model (each layer gathered in its body, gradients reduced to
    the shards) and through ``_WholeGather`` on the same weights and rows.
    Per leaf the largest |difference| over the largest |oracle| value, and
    the mesh model's collectives."""
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for arch, profile in spec["cells"]:
        cfg = dataclasses.replace(configs.get_reduced(arch), act_dtype="float32")
        pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=spec["seq"], global_batch=spec["batch"]))
        full = train_lib.build_model(cfg, seed=spec["seed"], device="cpu").param_tree()
        scfg = ts.StepConfig(aux_weight=spec["aux_weight"])
        grad_fn = ts.make_grad_fn(cfg, scfg, ts.make_mesh_loss_fn(cfg, scfg))
        res = {}
        for name, cls in (("layer", transformer.ShardedTransformer), ("whole", _WholeGather)):
            model = cls(cfg, full, mesh, profile=profile)
            batch = {k: v.to_local() for k, v in pipe.device_batch(0, mesh, model.batch_axes).items()}
            collectives.reset_collective_counts()
            total, _, grads = grad_fn(model, batch)
            res[name] = (float(total), grads, collectives.collective_counts())
        paths = ["/".join(p) for p, _ in transformer._paths(model.param_tree())]
        rel = {p: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for p, a, b in zip(paths, res["layer"][1], res["whole"][1])}
        out[(arch, profile)] = {"rel": rel, "total": (res["layer"][0], res["whole"][0]),
                                "collectives": res["layer"][2],
                                "shapes": [tuple(g.shape) for g in res["layer"][1]] == [
                                    tuple(g.shape) for g in res["whole"][1]]}
    return out


def tp_split_job(spec: dict) -> dict:
    """One gradient of the mesh loss on a (2, 2) mesh under "tp" for each of
    the spec's archs, from a seeded draw at act fp32, through the mesh
    model (each rank computing its share of every block along "model")
    and through ``_Unsplit`` (every leaf gathered whole, every block
    computed whole) on the same weights and rows, each under
    ``FlopCounterMode``: the losses, per leaf and over the rank's whole
    gradient the largest |difference| over the largest |oracle| value, the
    mesh model's collectives, each step's FLOPs, and the rank's KV heads."""
    from torch.utils.flop_counter import FlopCounterMode

    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for arch in spec["archs"]:
        cfg = dataclasses.replace(configs.get_reduced(arch), act_dtype="float32")
        pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=spec["seq"], global_batch=spec["batch"]))
        full = train_lib.build_model(cfg, seed=spec["seed"], device="cpu").param_tree()
        scfg = ts.StepConfig(aux_weight=spec["aux_weight"])
        grad_fn = ts.make_grad_fn(cfg, scfg, ts.make_mesh_loss_fn(cfg, scfg))
        res = {}
        for name, cls in (("split", transformer.ShardedTransformer), ("whole", _Unsplit)):
            model = cls(cfg, full, mesh, profile="tp")
            batch = {k: v.to_local() for k, v in pipe.device_batch(0, mesh, model.batch_axes).items()}
            collectives.reset_collective_counts()
            with FlopCounterMode(display=False) as fc:
                total, _, grads = grad_fn(model, batch)
            res[name] = (float(total), grads, collectives.collective_counts(), fc.get_total_flops())
        paths = ["/".join(p) for p, _ in transformer._paths(model.param_tree())]
        diff = {p: float((a - b).abs().max()) for p, a, b in zip(paths, res["split"][1], res["whole"][1])}
        scale = {p: float(b.abs().max()) for p, b in zip(paths, res["whole"][1])}
        split = transformer.ShardedTransformer(cfg, full, mesh, profile="tp")
        out[arch] = {"total": (res["split"][0], res["whole"][0]), "collectives": res["split"][2],
                     "flops": (res["split"][3], res["whole"][3]),
                     "rel": {p: diff[p] / max(scale[p], 1e-30) for p in paths},
                     "rel_all": max(diff.values()) / max(scale.values()),
                     "rows": batch["tokens"].shape[0], "kv_heads": split.kv_split.cache_heads(cfg),
                     "gathered": split.kv_split.gathered}
    return out


def moe_split_job(spec: dict) -> dict:
    """``moe_block`` under the "tp" split on a (2, 2) mesh where "model"
    does not divide ``n_experts`` (so no expert parallelism): this rank's
    "data" rows of the spec's inputs, its columns of every expert's
    ``gate``/``up`` and rows of ``down`` and of the shared experts' (the
    router whole): output, aux, collectives, and the gradients of
    sum(y · cot) + c · aux for x and each held block."""
    cfg = dataclasses.replace(configs.get_reduced("deepseek-moe-16b"), **spec["cfg"])
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    d, m = mesh.get_coordinate()
    rows = spec["x"].shape[0] // 2
    f, fs = cfg.d_ff_expert, cfg.n_shared_experts * cfg.d_ff_expert
    cut = {"router": lambda a: a, "gate": lambda a: a[..., m * f // 2 : (m + 1) * f // 2],
           "up": lambda a: a[..., m * f // 2 : (m + 1) * f // 2],
           "down": lambda a: a[:, m * f // 2 : (m + 1) * f // 2]}
    params = {k: torch.tensor(cut[k](spec["params"][k]), requires_grad=True) for k in cut}
    params["shared"] = {
        "gate": {"w": torch.tensor(spec["params"]["shared"]["gate"]["w"][:, m * fs // 2 : (m + 1) * fs // 2],
                                   requires_grad=True)},
        "up": {"w": torch.tensor(spec["params"]["shared"]["up"]["w"][:, m * fs // 2 : (m + 1) * fs // 2],
                                 requires_grad=True)},
        "down": {"w": torch.tensor(spec["params"]["shared"]["down"]["w"][m * fs // 2 : (m + 1) * fs // 2],
                                   requires_grad=True)}}
    x = torch.tensor(spec["x"][d * rows : (d + 1) * rows], requires_grad=True)
    collectives.reset_collective_counts()
    with base.use_mesh(mesh, base.ACT_RULES, split=True):
        y, aux = moe.moe_block(params, x, cfg, group_size=spec["group_size"])
    fwd = collectives.collective_counts()
    (y * torch.as_tensor(spec["cot"][d * rows : (d + 1) * rows])).sum().add(spec["aux_c"] * aux).backward()
    return {"rows": (d * rows, (d + 1) * rows), "coord": (d, m), "y": _np(y), "aux": float(aux.detach()),
            "collectives": fwd, "x_grad": _np(x.grad),
            "grads": {"/".join(p): _np(t.grad) for p, t in transformer._paths(params)}}


def attn_modes_job(spec: dict) -> dict:
    """``attention_block`` (and 4 decode steps from an empty cache) under
    the split on a (1, 4) mesh for each of the spec's head layouts, the
    weights held whole (each rank takes its share of them): its output,
    the gradients of sum(y · cot) for x and every leaf, the rank's
    ``HeadSplit``, the decode outputs and the cache's kv heads."""
    from repro_torch.models import attention

    mesh = mesh_lib.make_mesh((1, 4), ("data", "model"), "cpu")
    out = {}
    for name, case in spec["cases"].items():
        cfg = dataclasses.replace(configs.get_reduced("qwen1.5-0.5b"), **case["cfg"])
        params = {k: torch.tensor(v, requires_grad=True) for k, v in case["params"].items()}
        x = torch.tensor(case["x"], requires_grad=True)
        with base.use_mesh(mesh, base.ACT_RULES, split=True):
            y, _ = attention.attention_block(params, x, cfg)
            hs = attention.head_split(cfg, 4, collectives.coordinate(mesh, "model"))
            (y * torch.as_tensor(case["cot"])).sum().backward()
            cache = attention.init_kv_cache(cfg, x.shape[0], 4, dtype=torch.float32, device="cpu",
                                            kv_heads=hs.cache_heads(cfg))
            with torch.no_grad():
                dec = [attention.decode_attention(params, x[:, i : i + 1].detach(), cache, i, cfg)[0]
                       for i in range(4)]
        out[name] = {"y": _np(y), "x_grad": _np(x.grad), "grads": {k: _np(v.grad) for k, v in params.items()},
                     "split": dataclasses.asdict(hs), "decode": _np(torch.cat(dec, 1)),
                     "cache_heads": tuple(cache["k"].shape)[2]}
    return out


def vocab_ce_job(spec: dict) -> dict:
    """The vocabulary-parallel cross entropy on a (2, 2) mesh: each rank
    takes its "model" half of the spec's logits' vocabulary
    (``collectives.Split``) and the whole batch, and computes the masked
    mean CE (``train_step._masked_nll`` with the split, the mean over the
    unmasked tokens as ``cross_entropy`` takes it) and the gradient of it
    for its columns."""
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    sp = collectives.Split.of(mesh)
    out = {}
    for name, (logits, labels) in spec["cases"].items():
        lo, hi = sp.span(logits.shape[-1])
        local = torch.tensor(logits[..., lo:hi], requires_grad=True)
        collectives.reset_collective_counts()
        nll, mask = ts._masked_nll(local, torch.as_tensor(labels), True, sp)
        loss = nll.sum() / torch.clamp(mask.sum(), min=1)
        loss.backward()
        out[name] = {"loss": float(loss.detach()), "grad": _np(local.grad), "span": (lo, hi),
                     "collectives": collectives.collective_counts()}
    return out


def tp_decode_job(spec: dict) -> dict:
    """Greedy decoding of reduced qwen1.5-0.5b under "tp" on a (2, 2) mesh
    (``_tp_decode``)."""
    return _tp_decode("qwen1.5-0.5b", spec)


def tp_decode_mixers_job(spec: dict) -> dict:
    """``_tp_decode`` of each of the spec's archs (the Mamba2 and xLSTM
    families: each rank holds its share of every recurrent state)."""
    return {arch: _tp_decode(arch, dict(spec, prompts=spec["prompts"][arch])) for arch in spec["archs"]}


def _tp_decode(arch: str, spec: dict) -> dict:
    """Greedy decoding of reduced ``arch`` under "tp" on a (2, 2) mesh
    from a seeded draw: each "data" rank's rows of the spec's prompts fed
    token by token through ``ShardedTransformer.decode_step``
    (``make_serve_step``), then ``n_gen`` greedy tokens; the ids, the
    decode state's shapes, and the prefill's last-position logits
    (``make_prefill_step``, gathered whole along "model")."""
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = dataclasses.replace(configs.get_reduced(arch), act_dtype="float32")
    full = train_lib.build_model(cfg, seed=spec["seed"], device="cpu").param_tree()
    model = transformer.ShardedTransformer(cfg, full, mesh, profile="tp")
    d, _ = mesh.get_coordinate()
    rows = spec["prompts"].shape[0] // 2
    prompts = torch.as_tensor(spec["prompts"][d * rows : (d + 1) * rows])
    n_prompt = prompts.shape[1]
    step = ts.make_serve_step(cfg)
    with torch.no_grad():
        last = ts.make_prefill_step(cfg)(model, {"tokens": prompts})
        state = model.init_state(rows, n_prompt + spec["n_gen"])
        shapes = [tuple(t.shape) for t in base.tree_leaves(state)]
        for i in range(n_prompt):
            nxt, _, state = step(model, prompts[:, i : i + 1], state, i)
        ids = [nxt]
        for i in range(spec["n_gen"] - 1):
            nxt, _, state = step(model, nxt, state, n_prompt + i)
            ids.append(nxt)
    return {"rows": (d * rows, (d + 1) * rows), "ids": torch.cat(ids, 1).numpy(), "cache_shapes": shapes,
            "prefill_last": _np(last)}


def _mixer_blocks(kind: str):
    """(defs, block, state init) of a mixer kind."""
    from repro_torch.models import ssm, xlstm

    return {"mamba": (ssm.mamba2_defs, ssm.mamba2_block, ssm.mamba2_state_init),
            "mlstm": (xlstm.mlstm_defs, xlstm.mlstm_block, xlstm.mlstm_state_init),
            "slstm": (xlstm.slstm_defs, xlstm.slstm_block, xlstm.slstm_state_init)}[kind]


def mixer_layouts_job(spec: dict) -> dict:
    """Each of the spec's mixer blocks under the split on a (2, 2) mesh,
    its leaves held as the rules place them along "model" (this rank's
    block where "model" divides the dim, else whole; "embed" left whole)
    and the whole batch on every rank: the output, the gradients of
    sum(y · cot) for x and every leaf, the dim along which each leaf is
    split over "model" (None: whole), 4 decode steps from the rank's share
    of the state (``*_state_init`` with the split) and that state's
    shapes."""
    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    rules = dict(base.LOGICAL_RULES, embed=None)
    out = {}
    for name, case in spec["cases"].items():
        cfg = dataclasses.replace(configs.get_reduced(case["arch"]), **case["cfg"])
        defs, block, init = _mixer_blocks(case["kind"])
        placements = base.make_shardings(defs(cfg), mesh, rules)
        params = transformer._zip_map(
            lambda a, pl: collectives.shard_local(torch.tensor(a), pl, mesh).clone().requires_grad_(),
            case["params"], placements)
        x = torch.tensor(case["x"], requires_grad=True)
        with base.use_mesh(mesh, base.ACT_RULES, split=True):
            y, _ = block(params, x, cfg)
            (y * torch.as_tensor(case["cot"])).sum().backward()
            state = init(cfg, x.shape[0], device="cpu", sp=collectives.Split.of(mesh))
            shapes = [tuple(t.shape) for t in base.tree_leaves(state)]
            with torch.no_grad():
                dec = []
                for i in range(4):
                    yi, state = block(params, x[:, i : i + 1].detach(), cfg, state=state)
                    dec.append(yi)
        out[name] = {"y": _np(y), "x_grad": _np(x.grad), "decode": _np(torch.cat(dec, 1)), "state": shapes,
                     "grads": {"/".join(p): _np(t.grad) for p, t in transformer._paths(params)},
                     "split_dim": {"/".join(p): (pl[1].dim if pl[1].is_shard() else None)
                                   for p, pl in transformer._paths(placements)}}
    return out


def ep_job(spec: dict) -> dict:
    """The expert-parallel ``moe_block`` on (1, 4) and (2, 2) meshes, on
    this rank's batch rows: its output, aux loss, and the gradients of
    sum(y * cot) + c · aux for x and the routed weights, with the weights
    held whole and as this rank's expert shard."""
    cfg = dataclasses.replace(configs.get_reduced("deepseek-moe-16b"), **spec["cfg"])
    out = {}
    for shape in ((1, 4), (2, 2)):
        mesh = mesh_lib.make_mesh(shape, ("data", "model"), "cpu")
        rows = shape[0]
        d, m = mesh.get_coordinate()
        n_local = cfg.n_experts // shape[1]
        lo = d * (spec["x"].shape[0] // rows)
        x_np = spec["x"][lo : lo + spec["x"].shape[0] // rows]
        for held in ("whole", "shard"):
            params = base.tree_map(lambda a: torch.tensor(a, requires_grad=True), spec["params"])
            if held == "shard":
                for k in ("gate", "up", "down"):
                    params[k] = torch.tensor(spec["params"][k][m * n_local : (m + 1) * n_local],
                                             requires_grad=True)
            x = torch.tensor(x_np, requires_grad=True)
            with base.use_mesh(mesh):
                y, aux = moe.moe_block(params, x, cfg, group_size=spec["group_size"])
            cot = torch.as_tensor(spec["cot"][lo : lo + x_np.shape[0]])
            (y * cot).sum().add(spec["aux_c"] * aux).backward()
            grads = {k: _np(params[k].grad) for k in ("router", "gate", "up", "down")}
            out[(shape, held)] = {"rows": (lo, lo + x_np.shape[0]), "y": _np(y), "aux": float(aux.detach()),
                                  "x_grad": _np(x.grad), "grads": grads, "coord": (d, m)}
    return out


def batch_job(spec: dict) -> dict:
    """``device_batch`` on a (4,) and a (2, 2) mesh against ``host_batch``."""
    cfg = configs.get_reduced("qwen1.5-0.5b")
    pipe = TokenPipeline(cfg, PipelineConfig(seed=3, seq_len=16, global_batch=8))
    out = {}
    for shape, axes in (((4,), ("data",)), ((2, 2), ("data", "model"))):
        mesh = mesh_lib.make_mesh(shape, axes, "cpu")
        for step in (0, 5):
            b = pipe.device_batch(step, mesh, ("pod", "data"))
            host_id, n_hosts = mesh.get_coordinate()[0], shape[0]
            want = pipe.host_batch(step, host_id, n_hosts)
            g = pipe.global_batch(step)
            out[(shape, step)] = all(
                np.array_equal(b[k].to_local().numpy(), want[k]) and tuple(b[k].shape) == g[k].shape
                and np.array_equal(b[k].full_tensor().numpy(), g[k]) for k in g)
    return out


def shard_act_job(spec: dict) -> dict:
    """``shard_act`` on a DTensor under a (2, 2) mesh redistributes to the
    activation rules' placements; a plain tensor passes unchanged."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    x = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    dx = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    with base.use_mesh(mesh):
        y = base.shard_act(dx, ("act_batch", "act_seq", None))
        e = base.shard_act(distribute_tensor(torch.zeros(4, 4, 3, 2), mesh, (Replicate(), Replicate())),
                           ("act_batch", "act_model", None, None))
        plain = base.shard_act(x, ("act_batch", "act_seq", None)) is x
    d, m = mesh.get_coordinate()

    def kinds(pls):
        return tuple(("shard", p.dim) if p.is_shard() else ("replicate",) for p in pls)

    return {"placements": kinds(y.placements),
            "local_ok": torch.equal(y.to_local(), x[2 * d : 2 * d + 2]),
            "full_ok": torch.equal(y.full_tensor(), x),
            "moe_placements": kinds(e.placements),
            "moe_local": tuple(e.to_local().shape), "plain": plain}


def guard_job(spec: dict) -> dict:
    """A mesh of the wrong backend or size is an error."""
    out = {}
    for name, build in (("cuda", lambda: mesh_lib.make_host_mesh(device="cuda")),
                        ("size", lambda: mesh_lib.make_mesh((2, 4), ("data", "model"), "cpu"))):
        try:
            build()
            out[name] = "built"
        except (RuntimeError, ValueError) as e:
            out[name] = str(e)
    return out


def launcher_job(spec: dict) -> dict:
    """``launch.train.train`` over the 1-D mesh of the world: a straight
    run, then a run that checkpoints every step and fails after step 1,
    then its resume."""
    ckpt = os.path.join(spec["tmp"], "ckpt")
    straight = train_lib.train(train_lib.parse_args(spec["argv"]))
    try:
        train_lib.train(train_lib.parse_args(spec["argv"] + ["--ckpt-dir", ckpt, "--ckpt-every", "1",
                                                          "--fail-at", "1"]))
        failed = False
    except RuntimeError:
        failed = True
    resumed = train_lib.train(train_lib.parse_args(spec["argv"] + ["--ckpt-dir", ckpt, "--resume"]))
    return {"straight": straight, "failed": failed, "resumed": resumed}


JOBS = {"dp_tp": dp_tp_job, "moe_remat": moe_remat_job, "moe_aux": moe_aux_job, "grads": grads_job,
        "tp_split": tp_split_job, "moe_split": moe_split_job, "attn_modes": attn_modes_job,
        "vocab_ce": vocab_ce_job, "tp_decode": tp_decode_job, "tp_decode_mixers": tp_decode_mixers_job,
        "mixer_layouts": mixer_layouts_job, "ep": ep_job,
        "batch": batch_job, "shard_act": shard_act_job, "guard": guard_job, "launcher": launcher_job}


def rank_main(rank: int, init_file: str, out_dir: str, specs: dict) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", world_size=WORLD, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S),
        )
        try:
            out = {name: JOBS[name](spec) for name, spec in specs.items()}
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
