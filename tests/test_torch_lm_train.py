"""The port's LM training path against the JAX package's, on reduced
configs on the CPU: the loss and its gradient for one config of each
family, the whole train step, microbatching, descent and remat.

The reference's parameters reach the port through
``convert.lm_params(..., trainable=True)`` (the moe, hybrid and ssm
families rescaled to the port's fan-in, ``port_fan_in``, as in the serving
tests), and both sides take the same numpy batch from their
``TokenPipeline``. At act fp32, tolerances are a small factor over the
gaps measured on these inputs (run with ``-s`` to print them):

- the loss: rtol 1e-5 (measured ≤ 5.4e-7);
- each gradient leaf: max |d| over the leaf's max |value| within
  ``GRAD_GAP`` (the two sides sum the same products in other orders;
  measured ≤ 6.5e-5, and 4.7e-4 for the ssm family, whose mLSTM
  normaliser max(|q·n|, 1e-6) amplifies a rounding);
- the train step: the loss (rtol 1e-5) and grad_norm (rtol 1e-4 at the
  first step, 2e-3 after it: measured 6.5e-4, the later gradients are
  taken at parameters that carry the gaps below); each
  parameter within 2 · lr · steps of the reference (an Adam step moves a
  weight by about lr, and where a gradient element is near 0 its sign
  decides that step's direction) and 99.9 % of them within 1 % of
  lr · steps (measured 99.987 %);
- ``n_micro`` = 2 against 1 (port against port): the gradients within
  ``GRAD_GAP`` of each leaf's max. The MoE's load-balance loss is a
  product of batch means, so it does not split into microbatches (in the
  reference either): the moe case runs with ``aux_weight`` 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import base as jbase
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs, convert
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models import base
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from test_torch_lm_models import NEW, port_fan_in

FAMILIES = ["qwen1.5-0.5b", "llava-next-34b", "hubert-xlarge", "deepseek-moe-16b",
            "zamba2-2.7b", "xlstm-1.3b"]
LOSS_RTOL = 1e-5
GRAD_GAP = {"ssm": 1.5e-3}  # by family; every other family 2e-4
DEFAULT_GAP = 2e-4
B, S = 2, 32


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _pair(name: str, act: str = "float32", **kw):
    """(reference cfg, params; port cfg, trainable Transformer) on the
    reference's weights from PRNGKey(1)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), act_dtype=act, **kw)
    cfg = dataclasses.replace(configs.get_reduced(name), act_dtype=act, **kw)
    params = jax.tree.map(np.asarray, jbase.init_params(jax.random.PRNGKey(1), jtf.model_defs(jcfg)))
    if name in NEW:
        from repro_torch.models import transformer

        params = port_fan_in(params, transformer.model_defs(cfg))
    return jcfg, params, cfg, convert.lm_params(params, cfg, device="cpu", trainable=True)


def _batches(cfg, step: int = 0, batch: int = B, seq: int = S):
    """The same pipeline batch for both packages: (jax arrays, tensors)."""
    np_b = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=seq, global_batch=batch)).global_batch(step)
    return {k: jnp.asarray(v) for k, v in np_b.items()}, {k: torch.as_tensor(v) for k, v in np_b.items()}


def _gap(want, got) -> float:
    w = np.asarray(want, np.float32)
    return float(np.max(np.abs(_np(got) - w)) / max(float(np.max(np.abs(w))), 1e-30))


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_reference(name):
    jcfg, params, cfg, model = _pair(name)
    jb, tb = _batches(cfg)
    loss_fn = jts.make_loss_fn(jcfg, jts.StepConfig())
    (j_total, j_m), j_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jb)
    total, m, grads = ts.make_grad_fn(cfg, ts.StepConfig())(model, tb)
    j_leaves = jax.tree.leaves(j_g)
    assert len(j_leaves) == len(grads)
    assert [tuple(x.shape) for x in j_leaves] == [tuple(g.shape) for g in grads]
    gap = max(_gap(a, b) for a, b in zip(j_leaves, grads))
    print(f"{name}: loss {float(total)!r} vs {float(j_total)!r}, aux {float(m['aux'])!r} vs "
          f"{float(j_m['aux'])!r}, worst grad leaf gap {gap:.3e}")
    assert float(total) == pytest.approx(float(j_total), rel=LOSS_RTOL)
    assert float(m["loss"]) == pytest.approx(float(j_m["loss"]), rel=LOSS_RTOL)
    assert float(m["aux"]) == pytest.approx(float(j_m["aux"]), rel=LOSS_RTOL, abs=1e-7)
    assert int(m["n_tokens"]) == int(j_m["n_tokens"])
    assert gap <= GRAD_GAP.get(cfg.family, DEFAULT_GAP)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    name, n_steps = "qwen1.5-0.5b", 3
    jcfg, params, cfg, model = _pair(name)
    ocfg = jopt.OptConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    pcfg = opt.OptConfig(**dataclasses.asdict(ocfg))
    j_step = jax.jit(jts.make_train_step(jcfg, ocfg, jts.StepConfig(n_micro=n_micro)))
    t_step = ts.make_train_step(cfg, pcfg, ts.StepConfig(n_micro=n_micro))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp, ocfg)
    ps = opt.init_opt_state(model.param_tree(), pcfg)
    for step in range(n_steps):
        jb, tb = _batches(cfg, step, batch=4)
        jp, js, jm = j_step(jp, js, jb)
        model, ps, tm = t_step(model, ps, tb)
        assert set(tm) == set(jm) == {"loss", "aux", "n_tokens", "grad_norm", "lr", "total"}
        for k in ("loss", "total"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=LOSS_RTOL), k
        # the first step's gradient is the reference's; later ones are taken
        # at parameters that carry Adam's sign-of-a-near-zero-gradient gaps
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-4 if step == 0 else 2e-3)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["aux"]) == float(jm["aux"]) and int(tm["n_tokens"]) == int(jm["n_tokens"])
    if n_micro > 1:  # the reference's report, kept
        assert float(tm["aux"]) == 0.0 and int(tm["n_tokens"]) == 0
    d = np.concatenate([np.abs(_np(b) - np.asarray(a)).ravel() for a, b in
                        zip(jax.tree.leaves(jp), base.tree_leaves(model.param_tree()))])
    moved = ocfg.lr * n_steps  # about how far the steps move a weight
    share = float(np.mean(d <= 0.01 * moved))
    print(f"train_step n_micro={n_micro}, {n_steps} steps: max |d param| {d.max():.3e} "
          f"(bound {2 * moved:.1e}), share of elements within 1 % of lr x steps {share:.5f}")
    assert d.max() <= 2 * moved
    assert share >= 0.999
    assert int(ps.step) == n_steps


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "deepseek-moe-16b", "zamba2-2.7b"])
def test_n_micro_gradient_equals_full_batch(name):
    _, _, cfg, model = _pair(name)
    _, tb = _batches(cfg, batch=4)
    aux_weight = 0.0 if cfg.family == "moe" else ts.StepConfig().aux_weight
    t1, _, g1 = ts.make_grad_fn(cfg, ts.StepConfig(n_micro=1, aux_weight=aux_weight))(model, tb)
    t2, m2, g2 = ts.make_grad_fn(cfg, ts.StepConfig(n_micro=2, aux_weight=aux_weight))(model, tb)
    gap = max(_gap(_np(a), b) for a, b in zip(g1, g2))
    print(f"{name}: n_micro 2 vs 1: total {float(t2)!r} vs {float(t1)!r}, worst grad leaf gap {gap:.3e}")
    assert gap <= GRAD_GAP.get(cfg.family, DEFAULT_GAP)
    assert float(t2) == pytest.approx(float(t1), rel=LOSS_RTOL)
    assert float(m2["aux"]) == 0.0 and int(m2["n_tokens"]) == 0
    with pytest.raises(ValueError, match="microbatches"):
        ts.make_grad_fn(cfg, ts.StepConfig(n_micro=3))(model, tb)


def test_bf16_training_descends_on_a_fixed_batch():
    """The reference's descent test at the config's bf16 activations over
    fp32 leaves, with and without compression."""
    for compress in (False, True):
        _, _, cfg, model = _pair("qwen1.5-0.5b", act="bfloat16")
        pcfg = opt.OptConfig(total_steps=50, warmup_steps=2, compress_grads=compress)
        step = ts.make_train_step(cfg, pcfg, ts.StepConfig())
        state = opt.init_opt_state(model.param_tree(), pcfg)
        _, tb = _batches(cfg, batch=4, seq=64)
        losses = []
        for _ in range(6):
            model, state, m = step(model, state, tb)
            losses.append(float(m["total"]))
        print(f"bf16 compress={compress}: {losses}")
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        assert all(p.dtype == torch.float32 for p in base.tree_leaves(model.param_tree()))


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "deepseek-moe-16b", "zamba2-2.7b", "xlstm-1.3b"])
def test_remat_gives_the_same_gradients(name):
    """remat "full" and "dots" recompute what "none" keeps: the same
    gradients on the CPU, bit for bit."""
    out = {}
    for remat in ("none", "full", "dots"):
        _, _, cfg, model = _pair(name, remat=remat)
        _, tb = _batches(cfg)
        out[remat] = ts.make_grad_fn(cfg, ts.StepConfig())(model, tb)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][2], out["none"][2]):
            assert torch.equal(a, b), remat


def test_trainable_holding_layout():
    """One fp32 parameter a leaf, stacks whole, in the reference's tree;
    gradients land in the stacked leaves; serving is refused nothing."""
    jcfg, params, cfg, model = _pair("zamba2-2.7b")
    tree = model.param_tree()
    assert [tuple(x.shape) for x in base.tree_leaves(tree)] == [x.shape for x in jax.tree.leaves(params)]
    assert all(isinstance(p, torch.nn.Parameter) and p.requires_grad and p.dtype == torch.float32
               for p in base.tree_leaves(tree))
    assert len(list(model.parameters())) == len(base.tree_leaves(tree))
    serving = convert.lm_params(params, cfg, device="cpu")
    with pytest.raises(ValueError, match="trainable"):
        serving.param_tree()
    _, tb = _batches(cfg)
    inputs = {k: v for k, v in tb.items() if k != "labels"}
    with torch.no_grad():
        np.testing.assert_array_equal(_np(model(inputs)[0]), _np(serving(inputs)[0]))
    model.load_param_tree(base.tree_map(torch.zeros_like, tree))
    assert all(float(p.detach().abs().max()) == 0.0 for p in base.tree_leaves(model.param_tree()))
    with pytest.raises(ValueError, match="shape"):
        model.load_param_tree(base.tree_map(lambda p: torch.zeros(3), tree))
