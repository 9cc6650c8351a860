"""Layer 2: the run-time audit.

The AST layer proves things about source text; this layer runs the port on
the CPU at small sizes (a few seconds) and compares what it does with
budgets:

  (a) **no float64**: a ``TorchDispatchMode`` records the output dtype of
      every op while each public ``ops.*`` wrapper and one verify tile of
      each emit mode run on the torch backend. Any float64 output fails.
      Every public ``backend=`` function of ``kernels/ops.py`` must be
      driven, so a new wrapper cannot escape the check.
  (b) **collective budgets**: the distributed stages (stats, counts, verify
      self and R×S, serve through ``DistIndex.query_batch``) and the MoE's
      local path under a mesh run in an in-process gloo world of 1 (a file
      rendezvous under a temporary directory, destroyed in ``finally``).
      Each stage's ``collective_counts()`` must equal the reference's
      baseline entry (``budgets.stage_budget``), plus the port's own
      entries (``budgets.port_budget``).

The reference's jaxpr checks (c) static shapes and (d) the recompile budget
have no counterpart in eager PyTorch: nothing is traced, the kernels are
built once per source, and ``launch_plan`` picks each call's grid on the
host, so there is no compile cache to bound.
"""
from __future__ import annotations

import datetime
import inspect
import os
import tempfile

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from spjoin_lint_torch import budgets


class DtypeRecorder(TorchDispatchMode):
    """Records every op whose outputs include a float64 tensor."""

    def __init__(self):
        super().__init__()
        self.f64: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float64 for t in tree_leaves(out)):
            self.f64.append(str(func))
        return out


def f64_ops(fn) -> list[str]:
    """The ops of ``fn()`` that produced float64."""
    with DtypeRecorder() as rec:
        fn()
    return rec.f64


def _op_calls() -> dict:
    """One small call of every public ``ops.*`` wrapper and of each verify
    tile emit mode, on the torch backend."""
    from repro_torch.core import verify
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(0)
    x, y = torch.rand((24, 8), generator=g), torch.rand((20, 8), generator=g)
    px, py = x[:, :3].contiguous(), y[:, :3].contiguous()
    vids, wids = torch.arange(24, dtype=torch.int32), torch.arange(20, dtype=torch.int32)
    wcells = torch.zeros(20, dtype=torch.int32)
    anchors = x[:4].contiguous()
    xm = ref.pairdist(x, anchors, "l1")
    lo, hi = xm.amin(0), xm.amax(0)
    mid = (lo + hi) / 2
    k_lo, k_hi = torch.stack([lo, mid]), torch.stack([mid, hi + 1])
    kw = dict(backend="torch")
    tile = dict(delta=0.9, metric="l1", backend="torch")
    return {
        "ops.pairdist": lambda: ops.pairdist(x, y, "l2", **kw),
        "ops.pairdist_mask": lambda: ops.pairdist_mask(x, y, 0.9, "l1", **kw),
        "ops.pairdist_count": lambda: ops.pairdist_count(x, y, 0.9, "l1", **kw),
        "ops.pairdist_mask_filtered": lambda: ops.pairdist_mask_filtered(x, y, px, py, 0.9, "l1", **kw),
        "ops.verify_compact": lambda: ops.verify_compact(
            x, y, vids, wids, wcells, 0, px, py, delta=0.9, metric="l1", capacity=64, **kw),
        "ops.map_assign": lambda: ops.map_assign(x, anchors, k_lo, k_hi, k_lo, k_hi, "l1", **kw),
        "ops.assign_membership": lambda: ops.assign_membership(xm, k_lo, k_hi, k_lo, k_hi, **kw),
        "ops.histogram": lambda: ops.histogram(x, 8, torch.ones(24), **kw),
        "verify.verify_tile[mask]": lambda: verify.verify_tile(
            x, y, vids.long(), wids.long(), wcells.long(), 0, pv=px, pw=py, prune="pivot", **tile),
        "verify.verify_tile_compact[compact]": lambda: verify.verify_tile_compact(
            x, y, vids, wids, wcells, 0, capacity=64, pv=px, pw=py, prune="pivot", **tile),
    }


def backend_ops() -> set[str]:
    """``ops.<name>`` of every public ``kernels/ops.py`` function that takes
    a keyword-only ``backend``."""
    from repro_torch.kernels import ops

    out = set()
    for name, fn in inspect.getmembers(ops, inspect.isfunction):
        params = inspect.signature(fn).parameters
        if fn.__module__ == ops.__name__ and not name.startswith("_") and \
                "backend" in params and params["backend"].kind is inspect.Parameter.KEYWORD_ONLY:
            out.add(f"ops.{name}")
    return out


def audit_f64() -> tuple[dict, list[str]]:
    calls = _op_calls()
    report, problems = {}, []
    missing = backend_ops() - set(calls)
    for name in sorted(missing):
        problems.append(f"{name}: a public backend= wrapper the float64 audit does not drive")
    for name, fn in calls.items():
        report[name] = f64_ops(fn)
        if report[name]:
            problems.append(f"{name}: float64 out of {sorted(set(report[name]))}")
    return report, problems


def compare_counts(name: str, got: dict, want: dict) -> list[str]:
    """A problem line when a stage's counts differ from its budget (keys
    with 0 budget may be absent from ``got``)."""
    keys = set(got) | set(want)
    if all(got.get(k, 0) == want.get(k, 0) for k in keys):
        return []
    return [f"{name}: collectives {dict(sorted(got.items()))} != budget {dict(sorted(want.items()))}"]


def _stage_calls() -> dict:
    """(counter, call, budget) of each distributed stage and the MoE local
    path, in a world of 1."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import distributed, index, spjoin
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import base, collectives, moe

    x = torch.as_tensor(synthetic.mixture(240, 6, n_clusters=3, spread=3.0, seed=4))
    r, s = (torch.as_tensor(a) for a in synthetic.rs_mixture(160, 180, 6, n_clusters=3, spread=3.0, seed=5))
    q = x[:48] + 0.01  # near the indexed rows: the query has pairs, so both result gathers run
    delta = 0.8
    plan = distributed.build_join_plan(torch.Generator().manual_seed(0), x[::3], delta=delta, metric="l1",
                                       p=8, n_dims=4)
    xt, vt, it, _ = distributed._pad_shard_set(x, 1, 0)
    rt = distributed._pad_shard_set(r, 1, 0)[:3]
    st = distributed._pad_shard_set(s, 1, 0)[:3]
    vcfg = distributed.VerifyConfig

    def serve():
        idx = index.build_index(x, spjoin.JoinConfig(delta=delta, metric="l1", k=96, p=8, n_dims=4),
                                device="cpu")
        didx = idx.to_distributed()
        distributed.reset_collective_counts()  # the build is not the query
        didx.query_batch(q)

    cfg = dataclasses.replace(configs.get_reduced("deepseek-moe-16b"), act_dtype="float32")
    gen = torch.Generator().manual_seed(1)
    params = base.tree_map(lambda d: (torch.randn(d.shape, generator=gen) * 0.05).requires_grad_(),
                           moe.moe_defs(cfg))
    xm = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(2))
    n_groups = 2

    def moe_local():  # forward and backward: the backward adds no collective
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), "cpu")
        with base.use_mesh(mesh, base.FSDP_ACT_RULES):
            y, aux = moe.moe_block(params, xm, cfg, group_size=xm.shape[1] // n_groups)
        (y.sum() + aux).backward()

    axes = 2  # ("data", "model") of the fsdp profile's act_batch ("pod" is absent)
    per = budgets.port_budget("moe_block.local")
    dcounts = (distributed.reset_collective_counts, distributed.collective_counts)
    mcounts = (collectives.reset_collective_counts, collectives.collective_counts)
    return {
        "stage_stats": (dcounts, lambda: distributed.make_stage_stats(backend="torch")(xt, vt),
                        budgets.stage_budget("stage_stats")),
        "stage_counts": (dcounts, lambda: distributed.make_stage_counts(plan, backend="torch")(xt, vt),
                         budgets.stage_budget("stage_counts")),
        "stage_verify": (dcounts, lambda: distributed.make_stage_verify(
            plan, vcfg(cap_v=len(x), cap_w=len(x), prune="pivot"))(xt, vt, it),
            budgets.stage_budget("stage_verify")),
        "stage_verify_cross": (dcounts, lambda: distributed.make_stage_verify(
            plan, vcfg(cap_v=len(r), cap_w=len(s), prune="pivot"), cross=True)(*rt, *st),
            budgets.stage_budget("stage_verify_cross")),
        "DistIndex.query_batch": (dcounts, serve, {**budgets.stage_budget("stage_serve"),
                                                   **budgets.port_budget("DistIndex.query_batch")}),
        "moe_block.local": (mcounts, moe_local, {k: v * n_groups * axes for k, v in per.items()}),
    }


def audit_collectives(calls: dict | None = None) -> tuple[dict, list[str]]:
    """Run each stage in an in-process gloo world of 1 and hold its counts
    to its budget. ``calls``: as ``_stage_calls`` returns (by default its
    own), built inside the world."""
    import torch.distributed as dist

    report, problems = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rdzv')}", world_size=1,
                                rank=0, timeout=datetime.timedelta(seconds=60))
        try:
            for name, ((reset, read), call, want) in (calls or _stage_calls()).items():
                reset()
                call()
                report[name] = read()
                problems += compare_counts(name, report[name], want)
        finally:
            dist.destroy_process_group()
    return report, problems


def run_audit() -> tuple[dict, list[str]]:
    """Both checks; returns (report, problems)."""
    f64, p1 = audit_f64()
    stages, p2 = audit_collectives()
    return {"f64": f64, "stages": stages}, p1 + p2
