"""The port's dry run (``repro_torch.launch.dryrun``, ``dryrun_opt``,
``stepcount``, ``mesh.fake_world``) held against the reference's.

Both sides run in processes of their own, started together by one module
fixture: ``tests/_torch_dryrun_ref.py`` (``repro.launch.dryrun`` sets
``XLA_FLAGS`` when it is imported, so this process never imports it) and
``tests/_torch_dryrun_port.py`` (every fake world forms there, none in
this process).

* Per-rank bytes, exact: for every architecture, both production meshes
  and the "tp" and "fsdp" profiles, the rank's parameter and optimizer
  bytes of the port's placed cell equal the reference's
  ``NamedSharding.shard_shape`` over its own mesh and rules.
* FLOPs: reduced qwen1.5-0.5b at train_4k, 2 microbatches, on a (2, 2)
  mesh (both at the full config's attention chunks). Under "fsdp" every
  rank holds distinct rows; under "tp" the ranks along "model" hold the
  same rows and each computes its share of every block (its heads, FFN
  columns, vocabulary rows), as the reference's partitioner splits it.
  Under both the port's per-rank FLOPs equal the reference's hloparse
  count within rel FLOPS_REL. Measured: both equal to the last digit (the
  causal blocklist and the remat recompute make the same dots in both
  packages).
* Coverage: every runnable (arch, shape) of the reduced configs writes a
  record without ``error`` on a fake (2, 2) mesh (global batch 4, the
  train and prefill shapes cut to 1,024 tokens for time), with finite
  roofline terms, a peak no smaller than the arguments, and collective
  counts and bytes.
* Hygiene: importing the dry-run modules changes no ``os.environ`` key;
  ``fake_world`` refuses inside a world (its own or a gloo one) and
  leaves none behind, after an error too; this process never forms one.
* Collective bytes: ``gather_full``, ``_all_reduce`` and
  ``_reduce_scatter`` over fake worlds of 1, 2 and 4 ranks move (g - 1) /
  g of the gathered result, 2 (g - 1) / g of the reduced tensor and
  (g - 1) / g of the scattered input, one collective each.
* Layer-by-layer gathering: one train step of deepseek-moe-16b at full
  width under "tp" (expert parallelism over "model") on a fake (2, 2)
  mesh, global batch 2 in one microbatch of 1,024 tokens, has
  temporaries + gradients at its peak below the bytes of one stack of its
  routed experts (gate, up, down of all 27 MoE layers and 64 experts in
  fp32: 59.79 GB). Whole-leaf gathering put the whole routed stacks'
  ``select_backward``/``slice_backward`` zeros there: 165.8 GB of
  temporaries; layer by layer, 42.06 GB of gradients and no temporary at
  the peak. The reduced config cannot show it: one of its layers gathered
  whole is over half of its routed stack.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
FLOPS_REL = 1e-9
MESHES = ("single_pod", "multi_pod")
CELLS = [(a, s) for a, s, ok, _ in configs.all_cells() if ok]


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """{"port": ..., "ref": ...}: each side's JSON, from two processes run
    side by side."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    for name in ("port", "ref"):
        log = open(tmp / f"{name}.log", "w")
        procs[name] = (subprocess.Popen([sys.executable, str(ROOT / "tests" / f"_torch_dryrun_{name}.py"),
                                         str(tmp / f"{name}.json")], env=env, stdout=log,
                                        stderr=subprocess.STDOUT, cwd=str(tmp)), log)
    out = {}
    try:
        for name, (proc, log) in procs.items():
            rc = proc.wait(TIMEOUT_S)
            log.close()
            assert rc == 0, (tmp / f"{name}.log").read_text()[-4000:]
            out[name] = json.loads((tmp / f"{name}.json").read_text())
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
            log.close()
    return out


def test_pytest_process_forms_no_world_and_imports_no_reference_dryrun(sides):
    assert not torch.distributed.is_initialized()
    assert "repro.launch.dryrun" not in sys.modules


@pytest.mark.parametrize("profile", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_rank_bytes_equal_reference(sides, arch, mesh, profile):
    key = f"{arch}|{mesh}|{profile}"
    params, optimizer = sides["port"]["bytes"][key]
    assert (params, optimizer) == tuple(sides["ref"]["bytes"][key])
    assert params > 0 and optimizer == 4 + 2 * params


@pytest.mark.parametrize("profile", ["fsdp", "tp"])
def test_flops_against_reference(sides, profile):
    port, ref = sides["port"]["flops"][profile], sides["ref"]["flops"][profile]
    print(f"{profile}: port {port!r} reference {ref!r}")
    assert port == pytest.approx(ref, rel=FLOPS_REL)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_every_reduced_cell_runs(sides, arch, shape):
    recs = [r for r in sides["port"]["cells"] if (r["arch"], r["shape"]) == (arch, shape)]
    assert len(recs) == 1, recs
    rec = recs[0]
    assert "error" not in rec, rec.get("traceback")
    assert rec["mesh"] == "2x2" and rec["chips"] == 4 and rec["hardware"] == "H100 SXM (data sheet constants)"
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert sum(mem["split"].values()) == mem["peak_bytes"]
    assert rec["fits"] is True
    assert rec["flops_per_device"] > 0 and rec["dot_traffic_per_device"] > 0
    assert rec["coll_bytes_per_device"] == sum(rec["coll_breakdown"].values()) > 0
    assert rec["coll_counts"]["all_gather"] > 0
    terms = rec["roofline"]
    assert all(math.isfinite(terms[k]) and terms[k] > 0 for k in ("compute_s", "memory_s", "collective_s"))
    assert terms["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert 0 < rec["mfu_bound"] and 0 < rec["useful_flops_ratio"]
    if shape == "train_4k":
        assert rec["entry"] == "train_step" and rec["n_micro"] == 2
        assert mem["split"]["optimizer"] == 4 + 2 * mem["split"]["parameters"]
    else:
        assert rec["entry"] == ("prefill_step" if shape == "prefill_32k" else "serve_step")
        assert mem["split"]["optimizer"] == mem["split"]["gradients"] == 0


def test_dryrun_opt_and_failed_cells(sides):
    opt, failed = sides["port"]["opt"]
    assert opt["opt"] == {"profile": "tp"} and "error" not in opt and opt["mesh"] == "single_pod"
    # qwen's 16 kv heads split over the 16 "model" ranks: each rank's cache holds its one
    assert opt["chips"] == 256 and opt["state_layout"] == "heads" and opt["rows_per_rank"] == 8
    assert opt["gathered_projections"] == []
    assert failed["arch"] == "no-such-arch" and "unknown arch" in failed["error"] and failed["traceback"]


def test_importing_the_dryrun_sets_no_environment(sides):
    assert sides["port"]["import_env"] == []
    assert sides["port"]["hygiene"]["env"] == []


def test_fake_world_refuses_inside_a_world_and_leaves_none(sides):
    h = sides["port"]["hygiene"]
    assert h["before"] is False and h["inside"] == [True, 4]
    assert "needs a process without a world" in h["nested"]
    assert "needs a process without a world" in h["over_gloo"] and h["gloo_kept"] == ["gloo", 1]
    assert "needs a fake world" in h["fake_mesh_over_gloo"]
    assert h["after"] is False and h["after_error"] is False and h["after_skip"] is False
    assert h["skip"].startswith("skip: ")


@pytest.mark.parametrize("g", ["1", "2", "4"])
def test_collective_wire_bytes_follow_ring_formulas(sides, g):
    res = sides["port"]["coll"][g]
    n = int(g)
    assert res["shape"] == [3 * n, 5]
    assert res["gathered"] == (n - 1) / n * (3 * n * 5 * 4)
    assert res["bytes"]["all_reduce"] == 2 * (n - 1) / n * (7 * 2 * 2)
    assert res["bytes"]["reduce_scatter"] == (n - 1) / n * (n * 6 * 2)
    assert res["scattered"] == [6]
    assert res["counts"] == {"all_gather": 1, "all_reduce": 1, "reduce_scatter": 1}


def test_layer_gather_keeps_whole_stacks_off_the_peak(sides):
    res = sides["port"]["split"]
    split = res["split"]
    print(f"split at the peak {split}, peak {res['peak']:.4e} B; one routed stack {res['routed_stack']:.4e} B")
    assert res["routed_stack"] == 27 * 3 * 64 * 2048 * 1408 * 4
    assert split["temporaries"] + split["gradients"] < res["routed_stack"]
