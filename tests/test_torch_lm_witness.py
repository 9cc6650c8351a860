"""The forward-vs-decode gap of the moe, hybrid and ssm families at full
width, the port's beside the reference's own, on the CPU.

At full width these randomly initialised models amplify a rounding far
more than the reduced configs do: a bf16 (or bf16-cached) rounding moves a
router logit across a near-tie, and Mamba2 and mLSTM stacks grow a
rounding layer by layer. So the logits a prompt position gets from the
full-sequence forward and from decode one token at a time may differ by
more than the reference's bar (rtol = atol = 0.15). Each case runs both
packages on the same weights (the port's seeded draw) and tokens, at full
width on a cut depth that holds one of each block kind, and holds the
port's gap to the reference's own: the port's worst excess over the bar
exceeds the reference's by at most the bar, and both keep the argmax
agreement > 0.9 that the reference asks of hybrid and ssm.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.models import base, transformer

BAR = 0.15  # the reference's rtol = atol (tests/test_models.py)
B, S = 2, 32

# (arch, layers, act dtype): deepseek's dense layer 0 and one MoE layer at
# capacity factor n_experts / top_k (no drop, as decode never drops) in
# fp32 through the bf16 KV cache; one zamba2 group (6 Mamba2 layers and
# the shared block) in bf16; one xlstm group (7 mLSTM, 1 sLSTM) in fp32.
CUTS = [("deepseek-moe-16b", 2, "float32"), ("zamba2-2.7b", 6, "bfloat16"),
        ("xlstm-1.3b", 8, "float32")]


def _gap(full: np.ndarray, dec: np.ndarray) -> tuple[float, float]:
    """(worst |full - dec| - BAR |dec|, argmax agreement)."""
    excess = float((np.abs(full - dec) - BAR * np.abs(dec)).max())
    return excess, float((full.argmax(-1) == dec.argmax(-1)).mean())


def _reference(jcfg, params, toks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    full, _ = jax.jit(lambda p, b: jtf.forward(p, b, jcfg))(params, {"tokens": jnp.asarray(toks)})
    step = jax.jit(lambda p, t, s, n: jtf.decode_step(p, t, s, n, jcfg))
    state, dec = jtf.init_state(jcfg, B, S), []
    for t in range(S):
        lg, state = step(params, jnp.asarray(toks[:, t : t + 1]), state, jnp.int32(t))
        dec.append(np.asarray(lg, np.float32)[:, 0])
    return np.asarray(full, np.float32), np.stack(dec, 1)


def _port(model, toks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    with torch.inference_mode():
        tt = torch.as_tensor(toks)
        full, _ = model({"tokens": tt})
        state, dec = model.init_state(B, S), []
        for t in range(S):
            lg, state = model.decode_step(tt[:, t : t + 1], state, t)
            dec.append(lg.float().numpy()[:, 0])
    return full.float().numpy(), np.stack(dec, 1)


@pytest.mark.parametrize("name,n_layers,act", CUTS)
def test_full_width_decode_gap_is_the_references(name, n_layers, act):
    kw = dict(n_layers=n_layers, act_dtype=act)
    full_cfg = configs.get(name)
    if full_cfg.family == "moe":
        kw["capacity_factor"] = full_cfg.n_experts / full_cfg.top_k
    cfg = dataclasses.replace(full_cfg, **kw)
    jcfg = dataclasses.replace(jconfigs.get(name), **kw)
    params = base.init_params(torch.Generator().manual_seed(0), transformer.model_defs(cfg))
    jparams = jax.tree.map(jnp.asarray, base.tree_map(lambda t: t.numpy(), params))
    model = transformer.Transformer(cfg, params)
    del params
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int32)

    full_j, dec_j = _reference(jcfg, jparams, toks)
    full_t, dec_t = _port(model, toks)
    ref_excess, ref_agree = _gap(full_j, dec_j)
    excess, agree = _gap(full_t, dec_t)
    print(f"{name} ({n_layers} layers, {act}): forward vs decode, worst |d| - {BAR}|decode| "
          f"{excess:.4f} (reference {ref_excess:.4f}), argmax agreement {agree:.4f} "
          f"(reference {ref_agree:.4f})")
    if full_cfg.family == "moe":  # no rounding in the forward: the two agree in fp32
        np.testing.assert_allclose(full_t, full_j, rtol=1e-4, atol=1e-4)
    assert ref_agree > 0.9 and agree > 0.9, (ref_agree, agree)
    assert excess <= ref_excess + BAR, (excess, ref_excess)
