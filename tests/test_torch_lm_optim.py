"""The port's optimizer (``repro_torch.train.optimizer``) against the JAX
package's, on the CPU, fed the same numpy inputs: the reference's own
gradients of a reduced qwen1.5-0.5b at act fp32.

Tolerances (a small factor over the gaps measured on these inputs; run
with ``-s`` to print them):

- ``lr_at`` over the whole schedule: rtol 1e-6 (XLA's and torch's cos
  differ in the last bit; measured 3.6e-7).
- ``global_norm``: rtol 3e-6 (XLA's CPU reduction sums a leaf's squares
  less accurately than torch's; measured 1.0e-6).
- ``compress_int8_ef``: the dequantised values and the residual equal
  (the same division, round half to even and clip).
- ``apply_updates`` after 1 and 5 steps, as max |d| over each leaf's max
  |value|: parameters 1e-6, ``mu`` and ``nu`` 1e-5, the residual
  ``EF_GAP`` (the bias corrections and the schedule are fp32 tensors on
  both sides; measured values printed).
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
from repro_torch.models import base, transformer
from repro_torch.train import optimizer as opt

LR_RTOL = 1e-6
NORM_RTOL = 3e-6
PARAM_GAP = 1e-6  # max |d| over the leaf's max |value|, after the steps
MOMENT_GAP = 1e-5
EF_GAP = 2.5e-4  # the residual is under half a bucket (max |t| / 254); under jit XLA
#   contracts t - q * scale into one fused multiply-add, an ulp of t apart from the
#   two roundings here: ~1e-7 * 254 of the residual's max (measured 8.4e-5)
PARAM_TOL = dict(rtol=1e-6, atol=1e-7)
NAME = "qwen1.5-0.5b"


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(tree):
    return base.tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


@pytest.fixture(scope="module")
def ref():
    """(cfg, reference params as numpy, a list of 5 gradient trees as
    numpy: the reference's gradients at 5 batches)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(NAME), act_dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced(NAME), act_dtype="float32")
    params = jbase.init_params(jax.random.PRNGKey(1), jtf.model_defs(jcfg))
    loss_fn = jts.make_loss_fn(jcfg, jts.StepConfig())
    grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))
    grads = []
    for i in range(5):
        toks = jax.random.randint(jax.random.PRNGKey(10 + i), (2, 32), 0, jcfg.vocab)
        grads.append(jax.tree.map(np.asarray, grad(params, {"tokens": toks, "labels": toks})))
    return cfg, jax.tree.map(np.asarray, params), grads


def test_lr_at_matches_reference_over_the_schedule():
    for ocfg in (jopt.OptConfig(), jopt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100),
                 jopt.OptConfig(lr=3e-4, warmup_steps=3, total_steps=60, min_lr_ratio=0.0)):
        pcfg = opt.OptConfig(**dataclasses.asdict(ocfg))
        steps = np.arange(0, ocfg.total_steps + 20, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: jopt.lr_at(s, ocfg))(jnp.asarray(steps)))
        got = np.array([float(opt.lr_at(torch.tensor(int(s), dtype=torch.int32), pcfg)) for s in steps])
        gap = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
        print(f"lr_at {ocfg.warmup_steps}/{ocfg.total_steps}: max rel gap {gap:.3e}")
        np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=0)
        assert opt.lr_at(torch.tensor(5, dtype=torch.int32), pcfg).dtype == torch.float32


def test_global_norm_matches_reference(ref):
    _, _, grads = ref
    for g in grads[:2]:
        want = float(jopt.global_norm(jax.tree.map(jnp.asarray, g)))
        got = opt.global_norm(_t(g))
        print(f"global_norm: {float(got)!r} vs {want!r}, rel {abs(float(got) - want) / want:.3e}")
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=NORM_RTOL)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4])
def test_compress_int8_ef_matches_reference(ref, rng, scale):
    _, _, grads = ref
    g = jax.tree.map(lambda a: (a * scale).astype(np.float32), grads[0])
    r = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-3 * scale).astype(np.float32), g)
    # a leaf of exact halves on the quantisation grid: round half to even
    g["final_norm"]["scale"] = (np.arange(64, dtype=np.float32) - 31.5) * np.float32(127 / 32)
    r["final_norm"]["scale"] = np.zeros(64, np.float32)
    deq_j, res_j = jopt.compress_int8_ef(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
    deq_t, res_t = opt.compress_int8_ef(_t(g), _t(r))
    for a, b in zip(jax.tree.leaves(deq_j), base.tree_leaves(deq_t)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    for a, b in zip(jax.tree.leaves(res_j), base.tree_leaves(res_t)):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    # the quantised values themselves: deq / scale is an integer in [-127, 127]
    for d, gg, rr in zip(base.tree_leaves(deq_t), base.tree_leaves(_t(g)), base.tree_leaves(_t(r))):
        t = gg + rr
        s = torch.clamp(t.abs().max(), min=1e-12) / 127.0
        q = torch.round(d / s)
        assert float((d / s - q).abs().max()) < 1e-3 and float(q.abs().max()) <= 127


def test_int8_ef_invariant(rng):
    """Error feedback (``tests/test_train.py``'s invariant): the sum of the
    dequantised stream and the final residual is the true stream's sum,
    and one step's pointwise error is at most half a bucket."""
    stream = [torch.as_tensor(rng.normal(size=(64,)).astype(np.float32)) for _ in range(10)]
    residual = {"w": torch.zeros(64)}
    sent = torch.zeros(64)
    for g in stream:
        deq, residual = opt.compress_int8_ef({"w": g}, residual)
        sent = sent + deq["w"]
    np.testing.assert_allclose(_np(sent + residual["w"]), _np(sum(stream)), rtol=1e-5, atol=1e-5)
    _, r1 = opt.compress_int8_ef({"w": stream[0]}, {"w": torch.zeros(64)})
    assert float(r1["w"].abs().max()) <= float(stream[0].abs().max()) / 127.0 / 2 + 1e-7


def _leaf_gap(want, got) -> float:
    """max |got - want| over max |want| of one leaf."""
    w = np.asarray(want)
    return float(np.max(np.abs(_np(got) - w)) / max(float(np.max(np.abs(w))), 1e-30))


@pytest.mark.parametrize("compress,clip", [(False, 1.0), (False, 1e6), (True, 1e6)],
                         ids=["clipped", "unclipped", "compressed"])
@pytest.mark.parametrize("n_steps", [1, 5])
def test_apply_updates_matches_reference(ref, compress, clip, n_steps):
    """Compression runs unclipped here: the clip scale carries
    ``global_norm``'s last-bit gap, which can move an element of the
    compressor's input across a rounding boundary (one int8 bucket)."""
    cfg, params, grads = ref
    ocfg = jopt.OptConfig(total_steps=50, warmup_steps=2, compress_grads=compress, clip_norm=clip)
    pcfg = opt.OptConfig(**dataclasses.asdict(ocfg))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp, ocfg)
    model = convert.lm_params(params, cfg, device="cpu", trainable=True)
    ps = opt.init_opt_state(model.param_tree(), pcfg)
    step = jax.jit(lambda p, g, s: jopt.apply_updates(p, g, s, ocfg))
    for i in range(n_steps):
        jp, js, jm = step(jp, jax.tree.map(jnp.asarray, grads[i]), js)
        _, ps, tm = opt.apply_updates(model.param_tree(), _t(grads[i]), ps, pcfg)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=LR_RTOL)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=NORM_RTOL)
    assert int(ps.step) == int(js.step) == n_steps and ps.step.dtype == torch.int32
    assert (ps.ef_residual is None) == (not compress)
    pairs = {"params": (jax.tree.leaves(jp), base.tree_leaves(model.param_tree()))}
    for part in ("mu", "nu") + (("ef_residual",) if compress else ()):
        pairs[part] = (jax.tree.leaves(getattr(js, part)), base.tree_leaves(getattr(ps, part)))
    gaps = {k: max(_leaf_gap(a, b) for a, b in zip(*v)) for k, v in pairs.items()}
    print(f"apply_updates {'compressed' if compress else 'clip %g' % clip}, {n_steps} steps: "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    for k, v in gaps.items():
        assert v <= {"params": PARAM_GAP, "ef_residual": EF_GAP}.get(k, MOMENT_GAP), (k, v)


def test_apply_updates_converted_state_continues_the_reference(ref):
    """``convert.adam_state`` carries the reference's state over: a step
    from it lands where the reference's next step lands."""
    cfg, params, grads = ref
    ocfg = jopt.OptConfig(total_steps=50, warmup_steps=2, compress_grads=True)
    pcfg = opt.OptConfig(**dataclasses.asdict(ocfg))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_opt_state(jp, ocfg)
    for i in range(2):
        jp, js, _ = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, grads[i]), js, ocfg)
    model = convert.lm_params(jax.tree.map(np.asarray, jp), cfg, device="cpu", trainable=True)
    ps = convert.adam_state(jax.tree.map(np.asarray, js), cfg, device="cpu")
    jp, js, _ = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, grads[2]), js, ocfg)
    opt.apply_updates(model.param_tree(), _t(grads[2]), ps, pcfg)
    for a, b in zip(jax.tree.leaves(jp), base.tree_leaves(model.param_tree())):
        np.testing.assert_allclose(_np(b), np.asarray(a), **PARAM_TOL)
    bad = jax.tree.map(np.asarray, js)._replace(mu={"embed": {}})
    with pytest.raises(ValueError, match="mu at /"):
        convert.adam_state(bad, cfg, device="cpu")


def test_grad_clip_bounds_update():
    """The reference's clip test: the norm is reported before clipping,
    and the clipped update moves each weight by at most lr."""
    g = {"w": torch.full((4,), 100.0)}
    p = {"w": torch.zeros(4)}
    pcfg = opt.OptConfig(clip_norm=1.0, lr=1.0, weight_decay=0.0, warmup_steps=0)
    st = opt.init_opt_state(p, pcfg)
    _, st, m = opt.apply_updates(p, g, st, pcfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert float(st.mu["w"].abs().max()) == pytest.approx(0.1 * 0.5, rel=1e-6)  # (1 - b1) * g * 1/200
    assert float(p["w"].abs().max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("compress", [False, True])
def test_init_and_abstract_opt_state_shapes(ref, compress):
    cfg, params, _ = ref
    ocfg = jopt.OptConfig(compress_grads=compress)
    pcfg = opt.OptConfig(compress_grads=compress)
    want = jopt.init_opt_state(jax.tree.map(jnp.asarray, params), ocfg)
    model = convert.lm_params(params, cfg, device="cpu", trainable=True)
    got = opt.init_opt_state(model.param_tree(), pcfg)
    absd = opt.abstract_opt_state(base.abstract_params(transformer.model_defs(cfg)), pcfg)
    for st in (got, absd):
        assert tuple(st.step.shape) == () and st.step.dtype == torch.int32
        for part in ("mu", "nu", "ef_residual"):
            w, g = getattr(want, part), getattr(st, part)
            assert (w is None) == (g is None)
            if w is None:
                continue
            assert [tuple(x.shape) for x in jax.tree.leaves(w)] == [tuple(x.shape) for x in base.tree_leaves(g)]
            assert all(x.dtype == torch.float32 for x in base.tree_leaves(g))
    assert all(x.device.type == "meta" for x in base.tree_leaves(absd.mu)) and absd.step.device.type == "meta"
    assert all(float(x.abs().max()) == 0.0 for x in base.tree_leaves(got.nu))
