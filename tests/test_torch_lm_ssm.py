"""The port's recurrent blocks — the chunked linear recurrence and its
decode step (``repro_torch.models.ssm``), Mamba2, mLSTM and sLSTM
(``repro_torch.models.xlstm``) — against the JAX package's, on the CPU.

Both sides take the same weights and inputs, drawn with numpy from a seed
(each weight a normal over the square root of its input width,
``base.fan_in_of``). Each block runs a forward pass from no state, then a
decode step (S = 1) from the state the forward pass carried out, and for
mLSTM a second chunked pass from a carried state; outputs and states
compare, and the states' shapes and dtypes equal the reference's.
Tolerances: fp32 rtol = atol = 1e-4; bf16 the reference's bar, rtol =
atol = 0.15.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch import configs
from repro_torch.models import base, ssm, xlstm

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.15, atol=0.15)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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
    if isinstance(p, dict):
        return {k: _tree(v) for k, v in p.items()}
    if isinstance(p, tuple):
        return tuple(_tree(v) for v in p)
    return _t(p)


def _leaves(p) -> list:
    if isinstance(p, dict):
        return [x for k in sorted(p) for x in _leaves(p[k])]
    if isinstance(p, tuple):
        return [x for v in p for x in _leaves(v)]
    return [p]


def _same_layout(got, want) -> None:
    g, w = _leaves(got), _leaves(want)
    assert [(tuple(a.shape), str(a.dtype).replace("torch.", "")) for a in g] == [
        (tuple(a.shape), str(a.dtype)) for a in w]


def _close(got, want, dtype: str) -> None:
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), **(FP32 if dtype == "float32" else BF16))


def _params(defs, seed: int):
    """``defs`` (the reference's) drawn from ``default_rng(seed)``; zeros
    and ones leaves get values too, so every parameter is exercised.
    Returns (jax tree, tensor tree)."""
    rng = np.random.default_rng(seed)

    def draw(d):
        if isinstance(d, dict):
            return {k: draw(d[k]) for k in sorted(d)}
        fan_in = base.fan_in_of(base.ParamDef(d.shape, d.axes, d.init))
        a = rng.normal(size=d.shape) / np.sqrt(fan_in)
        if d.init == "ones":
            a = 1.0 + 0.1 * a
        return jnp.asarray(a, jnp.float32)

    jp = draw(defs)
    return jp, _tree(jp)


def _x(seed: int, shape, jdt):
    return jnp.asarray(np.random.default_rng(seed).normal(size=shape), jdt)


# ---------------------------------------------------------------------------
# the shared engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,with_state", [(8, False), (8, True), (32, False), (16, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_linear_recurrence_matches_reference(chunk, with_state, dtype, rng):
    jdt, _ = DTYPES[dtype]
    B, S, H, dk, dv = 2, 32, 3, 4, 5
    q, k = (jnp.asarray(rng.normal(size=(B, S, H, dk)), jdt) for _ in range(2))
    v = jnp.asarray(rng.normal(size=(B, S, H, dv)), jdt)
    log_a = jnp.asarray(-np.abs(rng.normal(size=(B, S, H))) * 0.3, jnp.float32)
    s0 = jnp.asarray(rng.normal(size=(B, H, dk, dv)), jnp.float32) if with_state else None
    y_j, st_j = jssm.chunked_linear_recurrence(q, k, v, log_a, chunk=chunk, state0=s0)
    y_t, st_t = ssm.chunked_linear_recurrence(_t(q), _t(k), _t(v), _t(log_a), chunk=chunk,
                                              state0=None if s0 is None else _t(s0))
    _same_layout((y_t, st_t), (y_j, st_j))
    _close((y_t, st_t), (y_j, st_j), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_recurrence_step_matches_reference(dtype, rng):
    jdt, _ = DTYPES[dtype]
    B, H, dk, dv = 2, 3, 4, 5
    state = jnp.asarray(rng.normal(size=(B, H, dk, dv)), jnp.float32)
    q, k = (jnp.asarray(rng.normal(size=(B, H, dk)), jdt) for _ in range(2))
    v = jnp.asarray(rng.normal(size=(B, H, dv)), jdt)
    log_a = jnp.asarray(-np.abs(rng.normal(size=(B, H))), jnp.float32)
    want = jssm.linear_recurrence_step(state, q, k, v, log_a)
    got = ssm.linear_recurrence_step(_t(state), _t(q), _t(k), _t(v), _t(log_a))
    _same_layout(got, want)
    _close(got, want, dtype)


def test_chunked_form_equals_the_step_form(rng):
    """The port's own invariant (the reference's test_models.py): the
    chunked dual form equals S decode steps, output and final state."""
    B, S, H, dk, dv = 2, 24, 2, 4, 3
    q, k = (torch.as_tensor(rng.normal(size=(B, S, H, dk)), dtype=torch.float32) for _ in range(2))
    v = torch.as_tensor(rng.normal(size=(B, S, H, dv)), dtype=torch.float32)
    log_a = torch.as_tensor(-np.abs(rng.normal(size=(B, S, H))) * 0.3, dtype=torch.float32)
    y, st = ssm.chunked_linear_recurrence(q, k, v, log_a, chunk=8)
    state, ys = torch.zeros((B, H, dk, dv)), []
    for t in range(S):
        yt, state = ssm.linear_recurrence_step(state, q[:, t], k[:, t], v[:, t], log_a[:, t])
        ys.append(yt)
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st, state, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _run_block(name, defs_j, block_j, block_t, init_j, init_t, dtype, seed, steps=(16, 1, 8)):
    """Forward over ``steps[0]`` tokens from no state, then each further
    length from the carried state; outputs and states against the
    reference, and both state inits' layouts."""
    jcfg, cfg = jconfigs.get_reduced(name), configs.get_reduced(name)
    jcfg, cfg = (dataclasses.replace(c, act_dtype=dtype) for c in (jcfg, cfg))
    jdt, _ = DTYPES[dtype]
    jp, tp = _params(defs_j(jcfg), seed)
    _same_layout(init_t(cfg, 2, device="cpu"), init_j(jcfg, 2))
    st_j = st_t = None
    for i, S in enumerate(steps):
        x = _x(seed + i, (2, S, cfg.d_model), jdt)
        if st_j is None:
            y_j, st_j = block_j(jp, x, jcfg)
            y_t, st_t = block_t(tp, _t(x), cfg)
        else:
            y_j, st_j = block_j(jp, x, jcfg, state=st_j)
            y_t, st_t = block_t(tp, _t(x), cfg, state=st_t)
        assert y_t.dtype == _t(x).dtype and y_t.shape == x.shape
        _close(y_t, y_j, dtype)
        _same_layout(st_t, st_j)
        _close(st_t, st_j, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_matches_reference(dtype):
    # forward, then decode steps from the carried state (conv history + SSD state)
    _run_block("zamba2-2.7b", jssm.mamba2_defs, jssm.mamba2_block, ssm.mamba2_block,
               jssm.mamba2_state_init, ssm.mamba2_state_init, dtype, seed=3, steps=(16, 1, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_block_matches_reference(dtype):
    # forward, a decode step, then a chunked pass from the carried state
    _run_block("xlstm-1.3b", jxlstm.mlstm_defs, jxlstm.mlstm_block, xlstm.mlstm_block,
               jxlstm.mlstm_state_init, xlstm.mlstm_state_init, dtype, seed=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_block_matches_reference(dtype):
    _run_block("xlstm-1.3b", jxlstm.slstm_defs, jxlstm.slstm_block, xlstm.slstm_block,
               jxlstm.slstm_state_init, xlstm.slstm_state_init, dtype, seed=5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype, rng):
    jdt, _ = DTYPES[dtype]
    W, C = 4, 12
    w = jnp.asarray(rng.normal(size=(W, C)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(C,)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(2, 7, C)), jdt)
    hist = jnp.asarray(rng.normal(size=(2, W - 1, C)), jnp.bfloat16)  # the bf16 history
    for state in (None, hist):
        want = jssm._causal_conv(x, w, b, state)
        got = ssm._causal_conv(_t(x), _t(w), _t(b), None if state is None else _t(state))
        _same_layout(got, want)  # the new history in the activation dtype, as the reference's
        _close(got, want, dtype)
