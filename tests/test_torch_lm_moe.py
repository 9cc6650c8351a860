"""The port's capacity-dispatch MoE (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe``, on the CPU.

Both sides take the same weights and inputs, drawn with numpy from a seed
(each weight of ``moe_defs`` a normal over the square root of its input
width, ``base.fan_in_of``, so outputs are of order one and a bf16 ulp
stays small against the bar). Inputs carry a shared offset, which skews
the routing so that the default capacity factor drops assignments. Tolerances: fp32
rtol = atol = 1e-4 (the products sum in other orders); bf16 the reference's
bar, rtol = atol = 0.15. Capacity factors 1.25 (the configs' default),
8.0 (nothing drops) and 0.25 (most assignments drop) are each held, and a
router with exact ties must pick the reference's experts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import base, moe

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.15, atol=0.15)
ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(x) -> torch.Tensor:
    a = np.array(x)
    if a.dtype == jnp.bfloat16:
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(a)


def _tree(p):
    return {k: _tree(v) for k, v in p.items()} if isinstance(p, dict) else _t(p)


def _cfgs(name: str, **kw):
    return (dataclasses.replace(jconfigs.get_reduced(name), **kw),
            dataclasses.replace(configs.get_reduced(name), **kw))


def _params(jcfg, seed: int = 0):
    """The weights of ``moe_defs`` from ``default_rng(seed)``: (reference
    tree of jax arrays, the same as tensors)."""
    rng = np.random.default_rng(seed)

    def draw(d):
        if isinstance(d, dict):
            return {k: draw(d[k]) for k in sorted(d)}
        fan_in = base.fan_in_of(base.ParamDef(d.shape, d.axes, d.init))
        return jnp.asarray(rng.normal(size=d.shape) / np.sqrt(fan_in), jnp.float32)

    jp = draw(jmoe.moe_defs(jcfg))
    return jp, _tree(jp)


def _x(rng, shape, dtype):
    """Normal rows plus one offset shared by every row (skewed routing)."""
    return jnp.asarray(rng.normal(size=shape) + rng.normal(size=shape[-1:]), dtype)


def _kept(jcfg, jp, x) -> tuple[int, int]:
    """(assignments kept, assignments) of one group, by the reference's rule."""
    B, gs, _ = x.shape
    probs = jax.nn.softmax((x @ jp["router"].astype(x.dtype)).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, jcfg.top_k)
    flat = np.asarray(idx).reshape(B, -1)
    C = jmoe._capacity(gs, jcfg)
    kept = sum(min(int((row == e).sum()), C) for row in flat for e in range(jcfg.n_experts))
    return kept, flat.size


@pytest.mark.parametrize("name", ARCHS)
def test_moe_defs_and_capacity_match_reference(name):
    jcfg, cfg = _cfgs(name)
    for full in (False, True):
        jc_, c_ = (jconfigs.get(name), configs.get(name)) if full else (jcfg, cfg)
        want, got = jmoe.moe_defs(jc_), moe.moe_defs(c_)
        flat = lambda t: {k: v for k, v in t.items() if not isinstance(v, dict)}
        assert {k: (d.shape, d.axes, d.init) for k, d in flat(got).items()} == {
            k: (d.shape, d.axes, d.init) for k, d in flat(want).items()}
        assert ("shared" in got) == ("shared" in want)
    for gs in (1, 2, 7, 16, 128, 2048):
        for cf in (0.25, 1.25, 8.0):
            a, b = dataclasses.replace(jcfg, capacity_factor=cf), dataclasses.replace(cfg, capacity_factor=cf)
            assert moe._capacity(gs, b) == jmoe._capacity(gs, a), (gs, cf)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("cf", [1.25, 8.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_reference(name, cf, dtype, rng):
    jcfg, cfg = _cfgs(name, capacity_factor=cf)
    jp, tp = _params(jcfg)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = _x(rng, (2, 32, cfg.d_model), jdt)
    y_j, aux_j = jmoe.moe_block(jp, x, jcfg)
    y_t, aux_t = moe.moe_block(tp, _t(x), cfg)
    assert y_t.shape == x.shape and y_t.dtype == _t(x).dtype and aux_t.dtype == torch.float32
    np.testing.assert_allclose(_np(y_t), _np(y_j), **(FP32 if dtype == "float32" else BF16))
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5 if dtype == "float32" else 0.15)
    kept, total = _kept(jcfg, jp, x)
    assert (kept < total) == (cf != 8.0), (kept, total)  # drops at 1.25 and 0.25 only


@pytest.mark.parametrize("name", ARCHS)
def test_moe_groups_and_decode_match_reference(name, rng):
    """Several token groups (aux averaged over them) and the decode shape
    (one token: gs = 1, C = 8)."""
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=1)
    x = _x(rng, (2, 32, cfg.d_model), jnp.float32)
    y_j, aux_j = jmoe.moe_block(jp, x, jcfg, group_size=8)
    y_t, aux_t = moe.moe_block(tp, _t(x), cfg, group_size=8)
    np.testing.assert_allclose(_np(y_t), _np(y_j), **FP32)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    y_j, aux_j = jmoe.moe_block(jp, x[:, :1], jcfg)
    y_t, aux_t = moe.moe_block(tp, _t(x[:, :1]), cfg)
    np.testing.assert_allclose(_np(y_t), _np(y_j), **FP32)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def test_top_k_breaks_ties_to_the_lower_index(rng):
    probs = rng.integers(0, 4, size=(64, 16)).astype(np.float32)  # many exact ties
    for k in (1, 2, 6, 16):
        w_j, i_j = jax.lax.top_k(jnp.asarray(probs), k)
        w_t, i_t = moe.top_k(torch.as_tensor(probs), k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_ties_choose_the_reference_experts(dtype, rng):
    """A router whose columns repeat gives every token exact ties among
    the experts; the dispatch must take the reference's (lower) ids."""
    jcfg, cfg = _cfgs("deepseek-moe-16b", n_shared_experts=0)
    jp, _ = _params(jcfg, seed=2)
    base_cols = np.asarray(jp["router"])[:, :2]
    router = np.repeat(base_cols, jcfg.n_experts // 2, axis=1)  # columns 0,0,..,1,1,..
    jp = dict(jp, router=jnp.asarray(router))
    tp = _tree(jp)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = _x(rng, (2, 16, cfg.d_model), jdt)
    probs = jax.nn.softmax((x @ jp["router"].astype(jdt)).astype(jnp.float32), -1)
    _, i_j = jax.lax.top_k(probs, jcfg.top_k)
    lg = (_t(x) @ tp["router"].to(_t(x).dtype)).float()
    _, i_t = moe.top_k(torch.softmax(lg, -1), cfg.top_k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert len(np.unique(np.asarray(i_j))) < jcfg.n_experts  # ties decided, not all experts used
    y_j, aux_j = jmoe.moe_block(jp, x, jcfg)
    y_t, aux_t = moe.moe_block(tp, _t(x), cfg)
    np.testing.assert_allclose(_np(y_t), _np(y_j), **(FP32 if dtype == "float32" else BF16))
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5 if dtype == "float32" else 0.15)
