"""The port's mesh layer in one gloo world of 4 ranks on the CPU, held
against the single-process port and the JAX package's single-device step.

One world serves the whole module: 4 processes from the spawn context,
file rendezvous under ``tmp_path``, one thread and a timeout each, their
group destroyed in ``finally`` (``tests/_torch_mesh_ranks.py``, which
imports neither ``jax`` nor ``repro``). This process forms no world, and
the JAX side is computed here.

* DP × TP: reduced stablelm-3b at act fp32 on a (2, 2) ("data", "model")
  mesh, parameters placed by ``LOGICAL_RULES``, two steps on
  ``device_batch`` rows. Against the single-process port step on the same
  weights and batches: loss and total rtol 1e-6, grad_norm rtol 1e-5 (the
  rows' gradients are summed over the ranks in another order; measured
  0 and 6.6e-8), every parameter within 2 · lr · steps and 99.9 % of
  them within 1 % of lr · steps (an Adam step moves a weight by about lr,
  and where a gradient element is near 0 its sign decides the direction).
  Against ``repro.train.train_step.make_train_step`` under ``jax.jit``:
  the tolerances of ``tests/test_torch_lm_train.py`` (loss rtol 1e-5,
  grad_norm 1e-4 at the first step and 2e-3 after it, the same parameter
  bounds). A second variant runs 2 microbatches with int8 error-feedback
  compression (the absmax scale and the norm over whole leaves): against
  the port the same bounds (measured: parameters 7.5e-5, share 0.99997);
  against the reference 99.8 % of the parameters within 1 % (measured
  0.99929: where an element of t / scale lies within rounding of a
  half-quantum the two packages round it apart, and Adam's first step
  moves a weight by lr whether its gradient is one quantum or zero). A
  third runs the fsdp profile: batch rows over all 4 ranks, each weight
  sharded on one dim over ("data", "model"), the port's bounds.
* The MoE's local path under "fsdp" (batch rows over all 4 ranks): reduced
  deepseek-moe-16b at act fp32 and aux_weight 0.01, one mesh gradient
  against the single-process port on the whole batch (loss, aux, the routed
  weights' gradients; the step's collectives equal the contract checker's
  budget), and ``moe_block`` on the EP test's inputs against the whole
  batch and the reference's ``_dispatch_group`` aux; the tolerances are
  stated in each test.
* Reduced deepseek-moe-16b at act fp32 under remat "full" and "dots" on the (2, 2)
  mesh ("tp": the expert-parallel MoE over "model"), two steps, against
  the single-process port with the stablelm case's bounds. The
  checkpointed bodies are recomputed in the backward pass, outside the
  forward's ``use_mesh``; the recompute must take the same MoE branch as
  the forward. ``aux_weight`` 0: the expert-parallel branch averages the
  batch shards' losses, as the reference's ``pmean`` does, which is not
  the whole batch's product of means.
* Layer-by-layer gathering against the whole-leaf gather it replaced
  (``_torch_mesh_ranks._GatherParam``, the oracle): one gradient of the
  mesh loss of reduced qwen1.5-0.5b under "tp" and "fsdp" and of reduced
  deepseek-moe-16b under "tp" (the expert-parallel branch: routed experts
  never gathered along "model") on the (2, 2) mesh at act fp32. Each
  rank's gradient shard of every leaf equals the oracle's within a
  relative error of 1e-6 (of the leaf's largest value), and the step's
  collectives equal the contract checker's budget.
* The split of the "tp" step (each rank computing its share of every
  block along "model": attention by heads, MLPs and shared experts by
  column and row, vocabulary-parallel embedding, logits and cross
  entropy) against the whole-leaf step it replaced
  (``_torch_mesh_ranks._Unsplit``: every leaf gathered whole, every block
  computed whole) on reduced qwen1.5-0.5b, deepseek-moe-16b, granite-34b
  (MQA: its one kv head split inside the head, k and v gathered whole
  along "model") and llama4-scout-17b-a16e, one gradient on the (2, 2)
  mesh at act fp32: the loss within rel TP_REL (1e-6; measured equal to
  the last digit but for qwen's 8.6e-8), and each rank's gradient shards
  within TP_GRAD_REL (2e-6) of their largest value, taken over the
  rank's gradient as a whole. The row splits (``wo``, ``down``, the
  unembedding's input gradient) add the ranks' partial sums in another
  order than one product does, and the vocabulary-parallel log-sum-exp
  rounds apart from the whole one by an ulp of the log-sum-exp: measured
  5e-7 to 9.4e-7 for qwen, granite and llama4 and 1.375e-6 for deepseek
  (its ``embed/tokens`` on rank 1). Per leaf the routers move most (1.47e-6
  deepseek, 1.90e-6 llama4: top-k renormalisation leaves their gradients
  near cancellation); the step's collectives equal the checker's restated budgets;
  each rank's ``FlopCounterMode`` count of the split matmuls is half the
  whole step's (the router's and the routed experts' products, expert
  parallel in both, and the mLSTM's ``x @ w_if``, counted out). Reduced
  zamba2-2.7b and xlstm-1.3b split their Mamba2 and xLSTM mixers by head
  and inner column: the same loss bound; their gradients to
  MIXER_GRAD_REL (zamba2 2e-5, measured 3.3e-6; xlstm 1e-2, measured
  3.8e-3): their recurrences amplify rounding, so that on one process a
  relative perturbation of 1e-7 of every weight moves the gradient by
  9.6e-6 (zamba2) and 2.8e-3 (xlstm; the mLSTM's normaliser near 0) of
  its largest element (qwen's by 1.6e-6; examples/lm_grad_noise_torch.py).
* The mixer blocks under the split on 2 "model" ranks, their leaves held
  as the rules place them: reduced zamba2's Mamba2 and xlstm's mLSTM and
  sLSTM (heads that divide "model"), and Mamba2 with 3 heads, the mLSTM
  with 1 and 3 and the sLSTM with 1 (heads that do not). Output, 4 decode
  steps from the rank's share of the state, x's and every leaf's
  gradient against the whole block within MIXER_REL (1e-5; the mLSTM
  XLSTM_GRAD_REL, measured 4.4e-5), the state's shapes the rank's share.
* ``moe_block`` under the split where "model" does not divide the
  experts (3 experts on the (2, 2) mesh: no expert parallelism, each
  expert's and the shared experts' FFN split by column and row, the
  router whole, one all-reduce of the partial outputs): each rank's output
  rows equal the whole batch's through the local path (rtol = atol =
  1e-6), its aux the whole batch's (rel 1e-6), and the gradients of
  sum(y · cot) + 0.1 · aux for x and for each rank's blocks, summed over
  the "data" ranks, the whole batch's (rtol = atol = 1e-5).
* The attention's head layouts under the split on a (1, 4) mesh, the
  weights held whole: 10 heads on 5 kv heads (each rank's wo rows are
  2.5 heads: q and k/v projected on the rank's columns and gathered
  whole, the straddled heads computed on two ranks, kv heads expanded to
  each q head where the groups do not line up), with q/k/v biases; and 2
  heads on 1 kv head of width 6 (k/v replicated by the rules: computed
  whole, their gradient summed over "model"). Outputs and 4 decode steps
  from an empty cache (holding every kv head) against the unsplit block
  (rtol = atol = 1e-5); x's gradient and each leaf's (the ranks' blocks
  summed, a replicated leaf's whole on every rank) the same.
* The vocabulary-parallel cross entropy on the (2, 2) mesh (each rank's
  half of the vocabulary) against the JAX package's
  ``train_step.cross_entropy`` on the same numpy logits: labels on both
  halves with masked ones, and every label masked; rtol 1e-6. The
  gradient of each rank's columns equals the single-process port's
  within VOCAB_GRAD_REL of its largest value.
* Greedy decoding of reduced qwen1.5-0.5b under "tp" on the (2, 2) mesh
  (each "data" rank its prompt rows, 8 prompt tokens by decode, then 8
  greedy tokens): the ids equal the single process's, each rank's KV
  caches hold KV / 2 heads, and the prefill's last-position logits,
  gathered whole along "model", the single process's within rtol = atol =
  1e-5. The same for reduced zamba2 and xlstm, each rank holding its
  share of every recurrent state (logits within MIXER_LOGITS_TOL, 1e-4:
  xlstm's measured 1.7e-5).
* Each rank's parameter and ``mu`` shapes are its shards under
  ``make_shardings``, and together the ranks hold each leaf once per
  replica.
* The expert-parallel ``moe_block`` on (1, 4) and (2, 2) meshes (weights
  held whole and as the rank's expert shard) against the local path on
  the reference's MoE test config: outputs rtol = atol = 1e-6, the aux loss
  the mean of the batch shards' local aux, and the gradients of
  sum(y · cot) + 0.1 · aux for x, the router and the experts summed over
  the batch shards, rtol = atol = 1e-5.
* ``device_batch`` against ``host_batch`` row for row; ``shard_act`` on a
  DTensor; a mesh of the wrong backend or size refused.
* The launcher over a 1-D mesh of the 4 ranks (reduced qwen1.5-0.5b at
  its bf16 activations, 2 steps): the single-process launcher's losses
  within rtol 5e-5 (each rank's gradient of its row is rounded to bf16
  before the sum over ranks, where one process rounds the sum of four;
  measured 3.2e-6), and a resume from its gathered checkpoint gives the
  straight run's second loss (rtol 1e-6; measured equal).
"""
import dataclasses
import importlib.util
import multiprocessing as mp
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro import configs as jconfigs
from repro.models import base as jbase
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs, convert
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import train as train_lib
from repro_torch.models import base, moe, transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

DP_TP = dict(arch="stablelm-3b", steps=2, batch=4, seq=32,
             opt=dict(lr=1e-3, total_steps=20, warmup_steps=2),
             variants={"plain": (1, False, "tp"), "micro2_int8": (2, True, "tp"),
                       "fsdp": (1, False, "fsdp")})  # (n_micro, compress_grads, profile)
MOE_REMAT = dict(arch="deepseek-moe-16b", cfg=dict(act_dtype="float32"), remats=("full", "dots"), seed=1,
                 steps=2, batch=4, seq=32, opt=DP_TP["opt"], aux_weight=0.0)
MOE_AUX = dict(arch="deepseek-moe-16b", cfg=dict(act_dtype="float32"), seed=1, batch=8, seq=32, aux_weight=0.01)
GRADS = dict(cells=(("qwen1.5-0.5b", "tp"), ("qwen1.5-0.5b", "fsdp"), ("deepseek-moe-16b", "tp")), seed=1,
             batch=8, seq=32, aux_weight=0.01)
GRAD_REL = 1e-6
TP_SPLIT = dict(archs=("qwen1.5-0.5b", "deepseek-moe-16b", "granite-34b", "llama4-scout-17b-a16e",
                       "zamba2-2.7b", "xlstm-1.3b"), seed=1, batch=8, seq=32, aux_weight=0.01)
TP_REL = 1e-6
TP_GRAD_REL = 2e-6
XLSTM_GRAD_REL = 1e-4
VOCAB_GRAD_REL = 1e-6
TP_DECODE = dict(seed=1, n_prompt=8, n_gen=8, batch=4)
TP_DECODE_MIXERS = ("zamba2-2.7b", "xlstm-1.3b")
# Mixer blocks on 2 "model" ranks: (arch, block, config changes); the reduced configs' heads
# divide "model", the others' do not
MIXER_LAYOUTS = {"mamba2_8_heads": ("zamba2-2.7b", "mamba", {}),
                 "mlstm_4_heads": ("xlstm-1.3b", "mlstm", {}),
                 "slstm_4_heads": ("xlstm-1.3b", "slstm", {}),
                 "mamba2_3_heads": ("zamba2-2.7b", "mamba", dict(d_model=48, ssm_head_dim=32)),
                 "mlstm_1_head": ("xlstm-1.3b", "mlstm", dict(n_heads=1)),
                 "slstm_1_head": ("xlstm-1.3b", "slstm", dict(n_heads=1)),
                 "mlstm_3_heads": ("xlstm-1.3b", "mlstm", dict(d_model=48, n_heads=3))}
MIXER_REL = 1e-5
# The whole-step gradient bars of the mixer archs, a few times their own rounding response: on
# one process a relative perturbation of 1e-7 of every weight moves the gradient by 9.6e-6
# (zamba2) and 2.8e-3 (xlstm, the mLSTM's normaliser near 0) of its largest value (qwen: 1.6e-6;
# examples/lm_grad_noise_torch.py)
MIXER_GRAD_REL = {"zamba2-2.7b": 2e-5, "xlstm-1.3b": 1e-2}
MIXER_LOGITS_TOL = 1e-4  # the mixers' tp prefill logits, rtol = atol (xlstm measured 1.7e-5)
MOE_SPLIT_CFG = dict(n_experts=3, top_k=2, n_shared_experts=2, capacity_factor=8.0, act_dtype="float32")
EP_CFG = dict(n_experts=8, top_k=2, n_shared_experts=2, capacity_factor=8.0)
LAUNCH_ARGV = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--steps", "2",
               "--global-batch", "4", "--seq-len", "32", "--log-every", "1"]
MESH_SHAPE = (2, 2)


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _ref_weights(arch: str):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch), act_dtype="float32")
    return jcfg, jax.tree.map(np.asarray, jbase.init_params(jax.random.PRNGKey(1), jtf.model_defs(jcfg)))


def _ep_inputs(cfg_kw: dict = EP_CFG) -> dict:
    cfg = dataclasses.replace(configs.get_reduced("deepseek-moe-16b"), **cfg_kw)
    rng = np.random.default_rng(0)

    def draw(d):
        if isinstance(d, dict):
            return {k: draw(v) for k, v in d.items()}
        return (rng.normal(size=d.shape) / np.sqrt(base.fan_in_of(d))).astype(np.float32)

    return dict(cfg=cfg_kw, params=draw(moe.moe_defs(cfg)), group_size=16, aux_c=0.1,
                x=rng.normal(size=(4, 32, cfg.d_model)).astype(np.float32),
                cot=rng.normal(size=(4, 32, cfg.d_model)).astype(np.float32))


def _vocab_cases() -> dict:
    """(logits (2, 17, 64), labels (2, 17)) per case: labels on both halves
    of the vocabulary with a masked one in four, and every label masked."""
    rng = np.random.default_rng(2)
    logits = (3 * rng.normal(size=(2, 17, 64))).astype(np.float32)
    labels = rng.integers(0, 64, size=(2, 17)).astype(np.int32)
    labels[rng.random(size=labels.shape) < 0.25] = -1
    return {"mixed": (logits, labels), "masked": (logits, np.full_like(labels, -1))}


ATTN_MODES = {"qcols_kvcols_bias": dict(n_heads=10, n_kv_heads=5, head_dim=8, d_model=32, qkv_bias=True),
              "qcols_kvwhole": dict(n_heads=2, n_kv_heads=1, head_dim=6, d_model=32, qkv_bias=False)}


def _attn_modes_inputs() -> dict:
    from repro_torch.models import attention

    rng = np.random.default_rng(4)
    cases = {}
    for name, kw in ATTN_MODES.items():
        cfg = dataclasses.replace(configs.get_reduced("qwen1.5-0.5b"), act_dtype="float32", **kw)
        params = {k: (rng.normal(size=d.shape) / np.sqrt(base.fan_in_of(d))).astype(np.float32)
                  for k, d in attention.attn_defs(cfg).items()}
        cases[name] = dict(cfg=dict(kw, act_dtype="float32"), params=params,
                           x=rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32),
                           cot=rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32))
    return {"cases": cases}


def _decode_prompts(arch: str = "qwen1.5-0.5b") -> np.ndarray:
    cfg = configs.get_reduced(arch)
    return np.random.default_rng(3).integers(0, cfg.vocab, (TP_DECODE["batch"], TP_DECODE["n_prompt"])).astype(
        np.int32)


def _mixer_cfg(case: str):
    arch, _, kw = MIXER_LAYOUTS[case]
    return dataclasses.replace(configs.get_reduced(arch), act_dtype="float32", **kw)


def _mixer_layout_inputs() -> dict:
    rng = np.random.default_rng(5)

    def draw(d):  # a constant leaf (a norm's scale, A_log, D, a bias) near its constant
        if d.init in ("zeros", "ones"):
            return (float(d.init == "ones") + 0.1 * rng.normal(size=d.shape)).astype(np.float32)
        return (rng.normal(size=d.shape) / np.sqrt(base.fan_in_of(d))).astype(np.float32)

    cases = {}
    for name, (arch, kind, kw) in MIXER_LAYOUTS.items():
        cfg = _mixer_cfg(name)
        cases[name] = dict(arch=arch, kind=kind, cfg=dict(kw, act_dtype="float32"),
                           params=base.tree_map(draw, ranks._mixer_blocks(kind)[0](cfg)),
                           x=rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32),
                           cot=rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32))
    return {"cases": cases}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every job in one spawned 4-rank gloo world; per-rank results."""
    tmp = tmp_path_factory.mktemp("mesh4")
    _, params = _ref_weights(DP_TP["arch"])
    specs = {"dp_tp": dict(DP_TP, params=params), "moe_remat": MOE_REMAT, "moe_aux": dict(MOE_AUX, block=_ep_inputs()),
             "grads": GRADS, "tp_split": TP_SPLIT, "moe_split": _ep_inputs(MOE_SPLIT_CFG),
             "attn_modes": _attn_modes_inputs(), "vocab_ce": {"cases": _vocab_cases()},
             "tp_decode": dict(TP_DECODE, prompts=_decode_prompts()),
             "tp_decode_mixers": dict(TP_DECODE, prompts={a: _decode_prompts(a) for a in TP_DECODE_MIXERS},
                                      archs=TP_DECODE_MIXERS),
             "mixer_layouts": _mixer_layout_inputs(),
             "ep": _ep_inputs(), "batch": {}, "shard_act": {}, "guard": {},
             "launcher": dict(argv=LAUNCH_ARGV, tmp=str(tmp))}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ranks.rank_main, args=(r, str(tmp / "rdzv"), str(tmp), specs))
             for r in range(ranks.WORLD)]
    for pr in procs:
        pr.start()
    try:
        for pr in procs:
            pr.join(ranks.TIMEOUT_S)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join(10)
    msg = "\n".join((tmp / f"rank{r}.err").read_text() for r in range(ranks.WORLD)
                    if (tmp / f"rank{r}.err").exists())
    assert all(pr.exitcode == 0 for pr in procs), f"exit codes {[pr.exitcode for pr in procs]}\n{msg}"
    out = []
    for r in range(ranks.WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# DP x TP training
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(DP_TP["variants"]))
def single_steps(request):
    """A variant's steps through the single-process port and through the
    JAX package: (variant, per-step metrics and final parameters of each)."""
    n_micro, compress, _ = DP_TP["variants"][request.param]
    jcfg, params = _ref_weights(DP_TP["arch"])
    cfg = dataclasses.replace(configs.get_reduced(DP_TP["arch"]), act_dtype="float32")
    pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=DP_TP["seq"], global_batch=DP_TP["batch"]))
    model = convert.lm_params(params, cfg, "cpu", trainable=True)
    ocfg = opt.OptConfig(**DP_TP["opt"], compress_grads=compress)
    jocfg = jopt.OptConfig(**DP_TP["opt"], compress_grads=compress)
    step = ts.make_train_step(cfg, ocfg, ts.StepConfig(n_micro=n_micro))
    j_step = jax.jit(jts.make_train_step(jcfg, jocfg, jts.StepConfig(n_micro=n_micro)))
    state = opt.init_opt_state(model.param_tree(), ocfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp, jocfg)
    port, ref = [], []
    for i in range(DP_TP["steps"]):
        b = pipe.global_batch(i)
        model, state, m = step(model, state, {k: torch.as_tensor(v) for k, v in b.items()})
        jp, js, jm = j_step(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        port.append({k: float(v) for k, v in m.items()})
        ref.append({k: float(v) for k, v in jm.items()})
    return (request.param, port, [_np(t) for t in base.tree_leaves(model.param_tree())],
            ref, [np.asarray(a) for a in jax.tree.leaves(jp)])


def _param_gaps(got: list, want: list) -> tuple[float, float]:
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, want)])
    moved = DP_TP["opt"]["lr"] * DP_TP["steps"]
    return float(d.max()), float(np.mean(d <= 0.01 * moved))


@pytest.mark.parametrize("against", ["port", "reference"])
def test_dp_tp_steps_match_single_device(world, single_steps, against):
    variant, port, port_params, ref, ref_params = single_steps
    want, want_params = (port, port_params) if against == "port" else (ref, ref_params)
    loss_rtol = 1e-6 if against == "port" else 1e-5
    res = [world[r]["dp_tp"][variant] for r in range(ranks.WORLD)]
    for r in range(ranks.WORLD):  # every rank reports the global metrics
        assert res[r]["metrics"] == res[0]["metrics"]
        assert res[r]["params"][0].tobytes() == res[0]["params"][0].tobytes()
    got = res[0]["metrics"]
    for i, (g, w) in enumerate(zip(got, want)):
        print(f"{variant} vs {against} step {i + 1}: loss {g['loss']!r} vs {w['loss']!r}, grad_norm "
              f"{g['grad_norm']!r} vs {w['grad_norm']!r}")
        for k in ("loss", "total"):
            assert g[k] == pytest.approx(w[k], rel=loss_rtol), (i, k)
        gn_rtol = 1e-5 if against == "port" else (1e-4 if i == 0 else 2e-3)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=gn_rtol), i
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
        assert int(g["n_tokens"]) == int(w["n_tokens"])
    worst, share = _param_gaps(res[0]["params"], want_params)
    moved = DP_TP["opt"]["lr"] * DP_TP["steps"]
    print(f"{variant} vs {against}: params max |d| {worst:.3e} (bound {2 * moved:.1e}), share within 1 % "
          f"of lr x steps {share:.5f}; collectives per step {res[0]['collectives']}")
    assert worst <= 2 * moved
    assert share >= (0.998 if variant == "micro2_int8" and against == "reference" else 0.999)


def test_dp_tp_ranks_hold_only_their_shards(world):
    cfg = configs.get_reduced(DP_TP["arch"])
    defs = transformer.model_defs(cfg)
    specs = dict(transformer._paths(base.make_pspecs(defs, _Fake(MESH_SHAPE))))
    sizes = dict(zip(("data", "model"), MESH_SHAPE))
    total_full = 0
    for path, d in transformer._paths(defs):
        spec = specs[path]
        want = tuple(n // int(np.prod([sizes[a] for a in ((e,) if isinstance(e, str) else e)]))
                     if e is not None else n for n, e in zip(d.shape, spec))
        for r in range(ranks.WORLD):
            assert world[r]["dp_tp"]["micro2_int8"]["shapes"]["/".join(path)] == want, (path, spec)
        total_full += int(np.prod(d.shape))
    for r in range(ranks.WORLD):
        res = world[r]["dp_tp"]["micro2_int8"]
        leaf_shapes = [res["shapes"]["/".join(p)] for p, _ in transformer._paths(defs)]
        assert res["state_shapes"] == [leaf_shapes] * 3  # mu, nu and the int8 residual
        assert res["numel"] < total_full  # "embed" split over "data", the TP dims over "model"
    numel = [world[r]["dp_tp"]["micro2_int8"]["numel"] for r in range(ranks.WORLD)]
    assert sum(numel) < ranks.WORLD * total_full
    assert {world[r]["dp_tp"]["micro2_int8"]["coord"] for r in range(ranks.WORLD)} == {
        (0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("remat", MOE_REMAT["remats"])
def test_moe_remat_steps_on_mesh_match_single_device(world, remat):
    spec = MOE_REMAT
    cfg = dataclasses.replace(configs.get_reduced(spec["arch"]), **spec["cfg"], remat=remat)
    pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=spec["seq"], global_batch=spec["batch"]))
    model = train_lib.build_model(cfg, seed=spec["seed"], device="cpu")
    ocfg = opt.OptConfig(**spec["opt"])
    state = opt.init_opt_state(model.param_tree(), ocfg)
    step = ts.make_train_step(cfg, ocfg, ts.StepConfig(aux_weight=spec["aux_weight"]))
    want = []
    for i in range(spec["steps"]):
        model, state, m = step(model, state, {k: torch.as_tensor(v) for k, v in pipe.global_batch(i).items()})
        want.append({k: float(v) for k, v in m.items()})
    res = [world[r]["moe_remat"][remat] for r in range(ranks.WORLD)]
    for r in range(ranks.WORLD):
        assert res[r]["metrics"] == res[0]["metrics"]
    got = res[0]["metrics"]
    for i, (g, w) in enumerate(zip(got, want)):
        print(f"moe remat {remat} step {i + 1}: loss {g['loss']!r} vs {w['loss']!r}, grad_norm {g['grad_norm']!r} vs "
              f"{w['grad_norm']!r}")
        for k in ("loss", "total"):
            assert g[k] == pytest.approx(w[k], rel=1e-6), (i, k)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-5), i
    worst, share = _param_gaps(res[0]["params"], [_np(t) for t in base.tree_leaves(model.param_tree())])
    print(f"moe remat {remat}: params max |d| {worst:.3e}, share within 1 % of lr x steps {share:.5f}")
    assert worst <= 2 * DP_TP["opt"]["lr"] * DP_TP["steps"]
    assert share >= 0.999


def _budgets():
    """The contract checker's budgets (``tools/spjoin_lint_torch/budgets.py``,
    loaded by file location: it imports nothing of its package)."""
    path = Path(__file__).resolve().parents[1] / "tools" / "spjoin_lint_torch" / "budgets.py"
    spec = importlib.util.spec_from_file_location("spjoin_lint_torch_budgets", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_moe_aux_on_fsdp_mesh_matches_whole_batch(world):
    """The MoE's local path under "fsdp" (batch rows over all 4 ranks, no
    expert parallelism) at aux_weight 0.01: one mesh gradient of reduced
    deepseek-moe-16b against the single-process port on the whole batch.
    Loss, total and aux within rel 1e-6; the routed weights' gradients
    (router, gate, up, down of both MoE layers) within rtol = atol = 1e-5
    (the ranks' shares are summed in another order). The step's
    collectives equal the checker's budget. The mean of the batch shards'
    aux (what the mesh gave before the repair) is another value, by more
    than 100 times the tolerance."""
    spec = MOE_AUX
    cfg = dataclasses.replace(configs.get_reduced(spec["arch"]), **spec["cfg"])
    pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=spec["seq"], global_batch=spec["batch"]))
    model = train_lib.build_model(cfg, seed=spec["seed"], device="cpu")
    scfg = ts.StepConfig(aux_weight=spec["aux_weight"])
    batch = {k: torch.as_tensor(v) for k, v in pipe.global_batch(0).items()}
    total, metrics, grads = ts.make_grad_fn(cfg, scfg)(model, batch)
    want = {"/".join(p): _np(g) for p, g in transformer._paths(base.tree_unflatten(model.param_tree(), grads))}
    budget = _budgets().port_budget("mesh_step[deepseek-moe-16b reduced, fsdp, (2, 2)]")
    for r in range(ranks.WORLD):
        res = world[r]["moe_aux"]["step"]
        print(f"rank {r}: loss {res['loss']!r} vs {float(metrics['loss'])!r}, aux {res['aux']!r} vs "
              f"{float(metrics['aux'])!r}; collectives {res['collectives']}")
        assert res["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-6)
        assert res["aux"] == pytest.approx(float(metrics["aux"]), rel=1e-6)
        assert res["total"] == pytest.approx(float(total), rel=1e-6)
        assert sorted(res["grads"]) == [f"layers/moe/{k}" for k in ("down", "gate", "router", "up")]
        for k, g in res["grads"].items():
            np.testing.assert_allclose(g, want[k], rtol=1e-5, atol=1e-5, err_msg=k)
        assert res["collectives"] == budget
    rows = spec["batch"] // ranks.WORLD
    with torch.no_grad():
        shard_mean = np.mean([float(model({k: v[i * rows : (i + 1) * rows] for k, v in batch.items()
                                           if k != "labels"})[1]) for i in range(ranks.WORLD)])
    print(f"whole-batch aux {float(metrics['aux'])!r}, mean of the shards' aux {shard_mean!r}")
    assert abs(shard_mean - float(metrics["aux"])) > 100 * 1e-6 * float(metrics["aux"])


def test_moe_local_block_on_fsdp_mesh_matches_reference(world):
    """``moe_block``'s local path under "fsdp" on the EP test's inputs (2
    token groups, one batch row a rank): each rank's output rows equal the
    whole batch's (rtol = atol = 1e-6), every rank's aux equals the whole
    batch's aux (rel 1e-6), which equals the mean over the groups of the
    reference's ``_dispatch_group`` aux on the same weights (rel 1e-5); the
    ranks' gradients of sum(y · cot) + c · aux summed equal the whole
    batch's (rtol = atol = 1e-5); the forward makes the checker's budget of
    all-reduces (one per token group and batch mesh axis) and the backward
    none."""
    spec = _ep_inputs()
    cfg = dataclasses.replace(configs.get_reduced("deepseek-moe-16b"), **EP_CFG)
    jcfg = dataclasses.replace(jconfigs.get_reduced("deepseek-moe-16b"), **EP_CFG)
    params = base.tree_map(lambda a: torch.tensor(a, requires_grad=True), spec["params"])
    x = torch.tensor(spec["x"], requires_grad=True)
    gs = spec["group_size"]
    y, aux = moe.moe_block(params, x, cfg, group_size=gs)
    (y * torch.as_tensor(spec["cot"])).sum().add(spec["aux_c"] * aux).backward()
    aux = float(aux.detach())
    n_groups = x.shape[1] // gs
    jp = jax.tree.map(jnp.asarray, spec["params"])
    jaux = np.mean([float(jmoe._dispatch_group(jp, jnp.asarray(spec["x"][:, g * gs : (g + 1) * gs]), jcfg)[1])
                    for g in range(n_groups)])
    assert aux == pytest.approx(jaux, rel=1e-5)
    per = _budgets().port_budget("moe_block.local")
    n_axes = 2  # "data" and "model": the fsdp profile's batch axes on this mesh
    summed = {k: np.zeros_like(_np(params[k].grad)) for k in ("router", "gate", "up", "down")}
    for r in range(ranks.WORLD):
        res = world[r]["moe_aux"]["block"]
        lo, hi = res["rows"]
        np.testing.assert_allclose(res["y"], _np(y)[lo:hi], rtol=1e-6, atol=1e-6)
        assert res["aux"] == pytest.approx(aux, rel=1e-6)
        np.testing.assert_allclose(res["x_grad"], _np(x.grad)[lo:hi], rtol=1e-5, atol=1e-5)
        assert res["collectives"] == {k: v * n_groups * n_axes for k, v in per.items()}
        assert res["bwd_collectives"] == res["collectives"]
        for k in summed:
            summed[k] += res["grads"][k]
    for k in summed:
        np.testing.assert_allclose(summed[k], _np(params[k].grad), rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch,profile", GRADS["cells"])
def test_layer_gather_grad_shards_match_whole_gather(world, arch, profile):
    """Each rank's gradient shards from layer-by-layer gathering (the
    reduce-scatter to the shard) against the whole-leaf gather's (the
    whole gradient all-reduced, then sliced): every leaf within GRAD_REL of
    its largest value, the same loss, and the step's collectives equal to
    the checker's budget."""
    budget = _budgets().port_budget(f"mesh_step[{arch} reduced, {profile}, (2, 2)]")
    for r in range(ranks.WORLD):
        res = world[r]["grads"][(arch, profile)]
        worst = max(res["rel"], key=res["rel"].get)
        print(f"{arch} {profile} rank {r}: total {res['total'][0]!r} vs {res['total'][1]!r}; worst leaf {worst} "
              f"{res['rel'][worst]:.3e}; collectives {res['collectives']}")
        assert res["shapes"]
        assert res["total"][0] == pytest.approx(res["total"][1], rel=GRAD_REL)
        for k, v in res["rel"].items():
            assert v <= GRAD_REL, (k, v)
        assert res["collectives"] == budget


@pytest.mark.parametrize("arch", TP_SPLIT["archs"])
def test_tp_split_step_matches_whole_layer_step(world, arch):
    """The split "tp" step against the whole-leaf step on the same weights
    and rows: the loss, each rank's gradient shards, the collectives."""
    budget = _budgets().port_budget(f"mesh_step[{arch} reduced, tp, (2, 2)]")
    for r in range(ranks.WORLD):
        res = world[r]["tp_split"][arch]
        worst = sorted(res["rel"], key=res["rel"].get)[-3:]
        print(f"{arch} rank {r}: total {res['total'][0]!r} vs {res['total'][1]!r}; gradient rel {res['rel_all']:.3e}; "
              f"worst leaves {[(k, round(res['rel'][k], 10)) for k in worst]}; collectives "
              f"{res['collectives']}; gathered projections {res['gathered']}")
        assert res["total"][0] == pytest.approx(res["total"][1], rel=TP_REL)
        assert res["rel_all"] <= MIXER_GRAD_REL.get(arch, TP_GRAD_REL)
        assert res["collectives"] == budget
    assert world[0]["tp_split"]["granite-34b"]["gathered"] == ("wk", "wv")
    assert world[0]["tp_split"]["qwen1.5-0.5b"]["gathered"] == ()


def _unsplit_flops(cfg, rows: int, seq: int) -> float:
    """The FLOPs of one mesh gradient that the split leaves whole on a rank,
    in the forward, remat full's recompute and the backward (two products
    per forward one): per MoE layer the router's product and the routed
    experts' (each rank its n_experts / 2 under expert parallelism, split
    and whole step alike); per mLSTM layer the gates' ``x @ w_if`` (a (d,
    2H) leaf the rules replicate). Mamba2's B and C (every head's) come out
    of the split ``in_proj`` and are not multiplied again outside its
    heads' SSD; reduced xlstm's sLSTM heads divide "model", so no whole
    sLSTM recurrence is left."""
    fwd = 2 if cfg.remat == "full" else 1
    if cfg.family == "ssm":
        n_mlstm = cfg.n_layers // cfg.slstm_every * (cfg.slstm_every - 1)
        return float(n_mlstm * (fwd + 2) * 2 * rows * seq * cfg.d_model * 2 * cfg.n_heads)
    if cfg.family != "moe":
        return 0.0
    gs = min(2048, seq)
    n_groups = seq // gs
    C = moe._capacity(gs, cfg)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    routed = 3 * 2 * (E // 2) * (rows * C) * d * f * n_groups
    router = 2 * rows * seq * d * E
    n_moe = cfg.n_layers - (1 if cfg.first_layer_dense else 0)
    return float(n_moe * (fwd + 2) * (routed + router))


@pytest.mark.parametrize("arch", TP_SPLIT["archs"])
def test_tp_split_halves_matmul_flops(world, arch):
    """Each rank's FlopCounterMode count of the split matmuls (every product
    but the MoE's router and routed experts) is half the whole step's."""
    cfg = dataclasses.replace(configs.get_reduced(arch), act_dtype="float32")
    for r in range(ranks.WORLD):
        res = world[r]["tp_split"][arch]
        split, whole = res["flops"]
        kept = _unsplit_flops(cfg, res["rows"], TP_SPLIT["seq"])
        print(f"{arch} rank {r}: FLOPs split {split} whole {whole}, left whole {kept}")
        assert 0 <= kept < split < whole
        assert 2 * (split - kept) == whole - kept


def test_moe_split_without_expert_parallelism_matches_local_path(world):
    spec = _ep_inputs(MOE_SPLIT_CFG)
    cfg = dataclasses.replace(configs.get_reduced("deepseek-moe-16b"), **MOE_SPLIT_CFG)
    params = base.tree_map(lambda a: torch.tensor(a, requires_grad=True), spec["params"])
    x = torch.tensor(spec["x"], requires_grad=True)
    y, aux = moe.moe_block(params, x, cfg, group_size=spec["group_size"])
    (y * torch.as_tensor(spec["cot"])).sum().add(spec["aux_c"] * aux).backward()
    aux = aux.detach()
    want = {"/".join(p): _np(t.grad) for p, t in transformer._paths(params)}
    f, fs = cfg.d_ff_expert, cfg.n_shared_experts * cfg.d_ff_expert
    summed: dict = {}
    for r in range(ranks.WORLD):
        res = world[r]["moe_split"]
        lo, hi = res["rows"]
        d, m = res["coord"]
        print(f"rank {r} rows [{lo}, {hi}) model {m}: aux {res['aux']!r} vs {float(aux)!r}; forward collectives "
              f"{res['collectives']}")
        np.testing.assert_allclose(res["y"], _np(y)[lo:hi], rtol=1e-6, atol=1e-6)
        assert res["aux"] == pytest.approx(float(aux), rel=1e-6)
        np.testing.assert_allclose(res["x_grad"], _np(x.grad)[lo:hi], rtol=1e-5, atol=1e-5)
        # per token group: me || ce over "data", then the partial outputs and the shared experts' over "model"
        n_groups = x.shape[1] // spec["group_size"]
        assert res["collectives"] == {"all_gather": 0, "all_reduce": n_groups + 1, "reduce_scatter": 0}
        for k, g in res["grads"].items():
            summed.setdefault((k, m), np.zeros_like(g))
            summed[(k, m)] += g
    blocks = {"router": lambda a, m: a, "gate": lambda a, m: a[..., m * f // 2 : (m + 1) * f // 2],
              "up": lambda a, m: a[..., m * f // 2 : (m + 1) * f // 2],
              "down": lambda a, m: a[:, m * f // 2 : (m + 1) * f // 2],
              "shared/gate/w": lambda a, m: a[:, m * fs // 2 : (m + 1) * fs // 2],
              "shared/up/w": lambda a, m: a[:, m * fs // 2 : (m + 1) * fs // 2],
              "shared/down/w": lambda a, m: a[m * fs // 2 : (m + 1) * fs // 2]}
    for (k, m), g in summed.items():
        if k == "router" and m == 1:  # the router's gradient is whole on every "model" rank
            continue
        np.testing.assert_allclose(g, blocks[k](want[k], m), rtol=1e-5, atol=1e-5, err_msg=k)
    assert {k for k, _ in summed} == set(blocks)


@pytest.mark.parametrize("case", list(ATTN_MODES))
def test_attention_head_layouts_under_split_match_whole_block(world, case):
    from repro_torch.models import attention

    spec = _attn_modes_inputs()["cases"][case]
    cfg = dataclasses.replace(configs.get_reduced("qwen1.5-0.5b"), **spec["cfg"])
    params = {k: torch.tensor(v, requires_grad=True) for k, v in spec["params"].items()}
    x = torch.tensor(spec["x"], requires_grad=True)
    y, _ = attention.attention_block(params, x, cfg)
    (y * torch.as_tensor(spec["cot"])).sum().backward()
    cache = attention.init_kv_cache(cfg, x.shape[0], 4, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        dec = torch.cat([attention.decode_attention(params, x[:, i : i + 1].detach(), cache, i, cfg)[0]
                         for i in range(4)], 1)
    tol = dict(rtol=1e-5, atol=1e-5)
    summed = {k: np.zeros_like(_np(v.grad)) for k, v in params.items()}
    splits = []
    for r in range(ranks.WORLD):
        res = world[r]["attn_modes"][case]
        splits.append(res["split"])
        print(f"{case} rank {r}: {res['split']}, cache kv heads {res['cache_heads']}")
        np.testing.assert_allclose(res["y"], _np(y), **tol)
        np.testing.assert_allclose(res["decode"], _np(dec), **tol)
        np.testing.assert_allclose(res["x_grad"], _np(x.grad), **tol)
        assert res["cache_heads"] == cfg.n_kv_heads
        for k, g in res["grads"].items():
            if res["split"]["kv"] == "whole" and k in ("wk", "wv", "bk", "bv"):
                np.testing.assert_allclose(g, _np(params[k].grad), err_msg=k, **tol)
            else:
                summed[k] += g
    for k, g in summed.items():
        if not (splits[0]["kv"] == "whole" and k in ("wk", "wv", "bk", "bv")):
            np.testing.assert_allclose(g, _np(params[k].grad), err_msg=k, **tol)
    assert all(sp["q"] == "cols" for sp in splits)
    if case == "qcols_kvcols_bias":  # rank 1 attends with heads 2-4 on kv heads 1, 1, 2: expanded
        assert [sp["heads"] for sp in splits] == [(0, 3), (2, 5), (5, 8), (7, 10)]
        assert splits[1]["kv_heads"] == (1, 3) and {sp["kv"] for sp in splits} == {"cols"}
    else:
        assert {sp["kv"] for sp in splits} == {"whole"}


@pytest.mark.parametrize("case", ["mixed", "masked"])
def test_vocab_parallel_cross_entropy_matches_reference(world, case):
    logits, labels = _vocab_cases()[case]
    want, n = jts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), True)
    t = torch.tensor(logits, requires_grad=True)
    loss, _ = ts.cross_entropy(t, torch.as_tensor(labels), True)
    loss.backward()
    g = _np(t.grad)
    for r in range(ranks.WORLD):
        res = world[r]["vocab_ce"][case]
        lo, hi = res["span"]
        gap = float(np.abs(res["grad"] - g[..., lo:hi]).max() / max(np.abs(g).max(), 1e-30))
        print(f"{case} rank {r} columns [{lo}, {hi}): loss {res['loss']!r} vs reference {float(want)!r}; gradient "
              f"rel {gap:.3e}; collectives {res['collectives']}")
        assert res["loss"] == pytest.approx(float(want), rel=1e-6, abs=0 if case == "mixed" else 1e-30)
        assert gap <= VOCAB_GRAD_REL
        assert res["collectives"]["all_reduce"] == 2 and res["collectives"]["all_gather"] == 0
    assert {world[r]["vocab_ce"][case]["span"] for r in range(ranks.WORLD)} == {(0, 32), (32, 64)}
    if case == "mixed":
        assert int(n) > 0 and (labels[:, 1:] >= 32).any() and ((labels[:, 1:] >= 0) & (labels[:, 1:] < 32)).any()


def _single_decode(arch: str) -> tuple:
    """The single process's greedy ids and prefill's last-position logits
    for reduced ``arch`` at act fp32 on ``_decode_prompts``."""
    cfg = dataclasses.replace(configs.get_reduced(arch), act_dtype="float32")
    model = train_lib.build_model(cfg, seed=TP_DECODE["seed"], device="cpu")
    prompts = torch.as_tensor(_decode_prompts(arch))
    n_prompt, n_gen = TP_DECODE["n_prompt"], TP_DECODE["n_gen"]
    step = ts.make_serve_step(cfg)
    with torch.no_grad():
        last = _np(ts.make_prefill_step(cfg)(model, {"tokens": prompts}))
        state = model.init_state(prompts.shape[0], n_prompt + n_gen)
        for i in range(n_prompt):
            nxt, _, state = step(model, prompts[:, i : i + 1], state, i)
        ids = [nxt]
        for i in range(n_gen - 1):
            nxt, _, state = step(model, nxt, state, n_prompt + i)
            ids.append(nxt)
    return cfg, torch.cat(ids, 1).numpy(), last


def test_tp_greedy_decode_matches_single_process(world):
    cfg, want, last = _single_decode("qwen1.5-0.5b")
    n_prompt, n_gen = TP_DECODE["n_prompt"], TP_DECODE["n_gen"]
    for r in range(ranks.WORLD):
        res = world[r]["tp_decode"]
        lo, hi = res["rows"]
        print(f"rank {r} rows [{lo}, {hi}): ids {res['ids'].tolist()} vs {want[lo:hi].tolist()}; caches "
              f"{res['cache_shapes']}")
        assert np.array_equal(res["ids"], want[lo:hi])
        assert res["cache_shapes"] == [(cfg.n_layers, hi - lo, n_prompt + n_gen, cfg.n_kv_heads // 2, cfg.hd)] * 2
        np.testing.assert_allclose(res["prefill_last"], last[lo:hi], rtol=1e-5, atol=1e-5)


def _state_share(cfg, rows: int, max_len: int) -> list:
    """The shapes of a rank's decode state on 2 "model" ranks (its half of
    the heads of every cache and recurrent state), in ``tree_leaves``
    order: hybrid "kv" k, v, "mamba" conv, ssd; ssm "mlstm", "slstm" c, h."""
    d_in = cfg.ssm_expand * cfg.d_model
    if cfg.family == "hybrid":
        g, per = cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every
        H, P, N = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
        return [(g, rows, max_len, cfg.n_kv_heads // 2, cfg.hd)] * 2 + [
            (g, per, rows, cfg.conv_width - 1, H // 2 * P + 2 * N), (g, per, rows, H // 2, N, P)]
    g, per_m, H = cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1, cfg.n_heads
    dh = d_in // H
    return [(g, per_m, rows, H // 2, dh, dh + 1)] + [(g, rows, H // 2, dh)] * 2


@pytest.mark.parametrize("arch", TP_DECODE_MIXERS)
def test_tp_greedy_decode_of_mixers_matches_single_process(world, arch):
    """Greedy decoding of reduced zamba2 and xlstm under "tp" on the (2, 2)
    mesh, each rank holding its share of every recurrent state (its Mamba2
    heads' conv channels plus B and C and their SSD states, its mLSTM and
    sLSTM heads): the ids equal the single process's, the state's shapes
    are the rank's share, and the prefill's last-position logits the
    single process's within rtol = atol = MIXER_LOGITS_TOL."""
    cfg, want, last = _single_decode(arch)
    n_prompt, n_gen = TP_DECODE["n_prompt"], TP_DECODE["n_gen"]
    for r in range(ranks.WORLD):
        res = world[r]["tp_decode_mixers"][arch]
        lo, hi = res["rows"]
        gap = float(np.abs(res["prefill_last"] - last[lo:hi]).max())
        print(f"{arch} rank {r} rows [{lo}, {hi}): ids {res['ids'].tolist()} vs {want[lo:hi].tolist()}; state "
              f"{res['cache_shapes']}; prefill logits max |d| {gap:.3e}")
        assert np.array_equal(res["ids"], want[lo:hi])
        assert res["cache_shapes"] == _state_share(cfg, hi - lo, n_prompt + n_gen)
        np.testing.assert_allclose(res["prefill_last"], last[lo:hi], rtol=MIXER_LOGITS_TOL, atol=MIXER_LOGITS_TOL)


@pytest.mark.parametrize("case", list(MIXER_LAYOUTS))
def test_mixer_layouts_under_split_match_whole_block(world, case):
    """A mixer block on 2 "model" ranks with its leaves held as the rules
    place them (the rank's block where "model" divides the dim, else
    whole): reduced zamba2's Mamba2 (4 heads a rank) and xlstm's mLSTM (2
    heads a rank: q, k and v reduce-scattered to them) and sLSTM (2 heads
    a rank); then heads that "model" does not divide: Mamba2 with 3 heads (the
    rank's d_in columns straddle head 1, computed on both ranks; in_proj
    replicated, projected whole), the mLSTM with 1 head (each rank a half
    of its value columns: q and k all-reduced, v reduce-scattered) and
    with 3 (straddled), the sLSTM with 1 head (pre-activations gathered
    whole, the recurrence whole on both ranks). Against the whole block:
    the output and 4 decode steps from the rank's share of the state
    within MIXER_REL (the mLSTM: XLSTM_GRAD_REL: its normaliser amplifies
    rounding, measured 3.6e-5) of the largest value; x's
    gradient and each leaf's (the ranks' blocks side by side, a whole
    leaf's on every rank) the same; the state's shapes the rank's share."""
    arch, kind, _ = MIXER_LAYOUTS[case]
    spec = _mixer_layout_inputs()["cases"][case]
    cfg = _mixer_cfg(case)
    _, block, init = ranks._mixer_blocks(kind)
    params = base.tree_map(lambda a: torch.tensor(a, requires_grad=True), spec["params"])
    x = torch.tensor(spec["x"], requires_grad=True)
    y, _ = block(params, x, cfg)
    (y * torch.as_tensor(spec["cot"])).sum().backward()
    state = init(cfg, x.shape[0], device="cpu")
    with torch.no_grad():
        dec = []
        for i in range(4):
            yi, state = block(params, x[:, i : i + 1].detach(), cfg, state=state)
            dec.append(yi)
    dec = _np(torch.cat(dec, 1))
    want = {"/".join(p): _np(t.grad) for p, t in transformer._paths(params)}
    bar = XLSTM_GRAD_REL if kind == "mlstm" else MIXER_REL

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    by_m: dict = {}
    for r in range(ranks.WORLD):
        res = world[r]["mixer_layouts"][case]
        gaps = {"y": rel(res["y"], _np(y)), "decode": rel(res["decode"], dec), "x_grad": rel(res["x_grad"], _np(x.grad))}
        print(f"{case} rank {r}: {gaps}; state {res['state']}; split dims {res['split_dim']}")
        assert max(gaps.values()) <= bar, gaps
        by_m[r % 2] = res
    for k, g in want.items():
        dim = by_m[0]["split_dim"][k]
        got = (by_m[0]["grads"][k] if dim is None else
               np.concatenate([by_m[0]["grads"][k], by_m[1]["grads"][k]], axis=dim))
        if dim is None:
            assert rel(by_m[1]["grads"][k], g) <= bar, k
        print(f"{case} {k}: split along {dim}, gradient rel {rel(got, g):.3e}")
        assert rel(got, g) <= bar, k
    d_in, H = cfg.ssm_expand * cfg.d_model, (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
                                             if kind == "mamba" else cfg.n_heads)
    shares = {"mamba2_8_heads": [(2, 3, 4 * cfg.ssm_head_dim + 2 * cfg.ssm_state),
                                 (2, 4, cfg.ssm_state, cfg.ssm_head_dim)],
              "mlstm_4_heads": [(2, 2, d_in // H, d_in // H + 1)],
              "slstm_4_heads": [(2, 2, d_in // H)] * 2,
              "mamba2_3_heads": [(2, 3, 2 * cfg.ssm_head_dim + 2 * cfg.ssm_state), (2, 2, cfg.ssm_state, 32)],
              "mlstm_1_head": [(2, 1, d_in, d_in // 2 + 1)],
              "slstm_1_head": [(2, 1, d_in)] * 2,
              "mlstm_3_heads": [(2, 2, d_in // H, d_in // H + 1)]}
    assert all(world[r]["mixer_layouts"][case]["state"] == shares[case] for r in range(ranks.WORLD))


class _Fake:
    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------


def _ep_reference(spec: dict, n_data: int) -> dict:
    """The local path on the whole batch: y, the mean of the batch shards'
    aux, and the gradients of sum(y * cot) + c * that mean."""
    cfg = dataclasses.replace(configs.get_reduced("deepseek-moe-16b"), **spec["cfg"])
    params = base.tree_map(lambda a: torch.tensor(a, requires_grad=True), spec["params"])
    x = torch.tensor(spec["x"], requires_grad=True)
    y, _ = moe.moe_block(params, x, cfg, group_size=spec["group_size"])
    rows = x.shape[0] // n_data
    aux = sum(moe.moe_block(params, x[d * rows : (d + 1) * rows], cfg, group_size=spec["group_size"])[1]
              for d in range(n_data)) / n_data
    (y * torch.as_tensor(spec["cot"])).sum().add(spec["aux_c"] * aux).backward()
    return {"y": _np(y), "aux": float(aux.detach()), "x_grad": _np(x.grad),
            "grads": {k: _np(params[k].grad) for k in ("router", "gate", "up", "down")}}


def test_ep_moe_block_matches_reference_local_path():
    """The port's local moe_block (the EP test's yardstick) against the
    JAX package's on the same weights."""
    spec = _ep_inputs()
    jcfg = dataclasses.replace(jconfigs.get_reduced("deepseek-moe-16b"), **EP_CFG)
    cfg = dataclasses.replace(configs.get_reduced("deepseek-moe-16b"), **EP_CFG)
    y, aux = moe.moe_block(base.tree_map(torch.as_tensor, spec["params"]), torch.as_tensor(spec["x"]), cfg,
                           group_size=spec["group_size"])
    jy, jaux = jmoe.moe_block(jax.tree.map(jnp.asarray, spec["params"]), jnp.asarray(spec["x"]), jcfg,
                              group_size=spec["group_size"])
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


@pytest.mark.parametrize("held", ["whole", "shard"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=lambda s: "x".join(map(str, s)))
def test_ep_moe_block_matches_local_path(world, shape, held):
    spec = _ep_inputs()
    want = _ep_reference(spec, shape[0])
    cfg_e = spec["cfg"]["n_experts"]
    n_local = cfg_e // shape[1]
    tol = dict(rtol=1e-5, atol=1e-5)
    summed = {k: np.zeros_like(v) for k, v in want["grads"].items()}
    for r in range(ranks.WORLD):
        res = world[r]["ep"][(shape, held)]
        lo, hi = res["rows"]
        d, m = res["coord"]
        np.testing.assert_allclose(res["y"], want["y"][lo:hi], rtol=1e-6, atol=1e-6)
        assert res["aux"] == pytest.approx(want["aux"], rel=1e-6)
        np.testing.assert_allclose(res["x_grad"], want["x_grad"][lo:hi], **tol)
        if m == 0:  # the router's gradient is whole on every "model" rank
            summed["router"] += res["grads"]["router"]
        for k in ("gate", "up", "down"):
            g = res["grads"][k]
            local = g if held == "shard" else g[m * n_local : (m + 1) * n_local]
            if held == "whole":  # nothing reaches the other ranks' experts
                assert not np.any(np.delete(g, np.s_[m * n_local : (m + 1) * n_local], axis=0))
            summed[k][m * n_local : (m + 1) * n_local] += local
    for k in summed:
        np.testing.assert_allclose(summed[k], want["grads"][k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# Batches, activations, the mesh constructors, the launcher
# ---------------------------------------------------------------------------


def test_device_batch_is_host_batch(world):
    for r in range(ranks.WORLD):
        assert world[r]["batch"] and all(world[r]["batch"].values()), world[r]["batch"]


def test_shard_act_redistributes_dtensors(world):
    for r in range(ranks.WORLD):
        res = world[r]["shard_act"]
        assert res["placements"] == (("shard", 0), ("replicate",))
        assert res["local_ok"] and res["full_ok"] and res["plain"]
        assert res["moe_placements"] == (("shard", 0), ("shard", 1))
        assert res["moe_local"] == (2, 2, 3, 2)


def test_mesh_of_wrong_backend_or_size_is_refused(world):
    for r in range(ranks.WORLD):
        assert "needs a nccl world" in world[r]["guard"]["cuda"]
        assert "needs 8 ranks" in world[r]["guard"]["size"]


def test_launcher_over_mesh_matches_single_process(world):
    single = train_lib.train(train_lib.parse_args(LAUNCH_ARGV))
    for r in range(ranks.WORLD):
        res = world[r]["launcher"]
        print(f"rank {r}: mesh {res['straight']} vs single {single}; resumed {res['resumed']}")
        assert res["straight"] == pytest.approx(single, rel=5e-5)
        assert res["failed"]
        assert res["resumed"] == pytest.approx(res["straight"][1:], rel=1e-6)
    assert not torch.distributed.is_initialized()
