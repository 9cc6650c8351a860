"""The port's LM stack (configs, parameters, layers, attention, forward)
against the JAX package's, on reduced configs on the CPU.

The reference's parameters reach the port through ``convert.lm_params``
(``jax.random`` streams cannot be reproduced), so both sides compute from
the same weights and inputs. Tolerances:

- fp32 (``act_dtype="float32"``): rtol 1e-4, atol 1e-4. The two sides sum
  the same products in different orders; the reference's scaled init
  (fan_in = the layer count for stacked weights) makes activations large,
  and those summation differences reach ~7e-5 absolute on logits of
  magnitude ~1-4, so atol 1e-5 would fail on near-zero logits alone.
- bf16 (the configs' default): the reference's own decode-vs-forward bar
  (``tests/test_models.py``): rtol/atol 0.15 and argmax agreement > 0.95,
  on that test's inputs (params ``PRNGKey(1)``, tokens ``PRNGKey(2)``,
  B 2, S 16). XLA keeps fused bf16 chains in fp32 where PyTorch rounds
  after each op, so the two bf16 results differ by bf16 rounding.

The moe, hybrid and ssm families take the same draw with each scaled
weight rescaled to the port's fan-in (``port_fan_in``: normal / √d_in, not
/ √(layer count)). Under the reference's scale these reduced models are so
ill-conditioned that the reference's own bf16 forward misses its fp32
forward by more than the bar on these inputs, so no second bf16
implementation can meet it. At bf16 they hold argmax agreement > 0.9 (the
reference's bar for hybrid and ssm, ``test_ssm_decode_matches_forward``)
and the 0.15 bar, or where ``BF16_EXCESS`` lists a path its measured
excess over the bar; at fp32 a decode path through the reference's bf16
KV cache is held at ``fp32_kv_tol``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import base as jbase
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import ShapeConfig as JShapeConfig
from repro_torch import configs, convert
from repro_torch.models import attention, base, layers, transformer
from repro_torch.models.config import SHAPES, ShapeConfig

DENSE_BODY = ["qwen1.5-0.5b", "stablelm-3b", "phi3-mini-3.8b", "granite-34b",
              "llava-next-34b", "hubert-xlarge"]
NEW = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "zamba2-2.7b", "xlstm-1.3b"]
FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.15, atol=0.15)
B, S = 2, 16


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(x) -> torch.Tensor:
    """A reference array as a CPU tensor of the same dtype (a copy)."""
    a = np.array(x)
    if a.dtype == jnp.bfloat16:
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(a)


def _flat(tree, prefix=""):
    if isinstance(tree, (dict, tuple)):
        out = {}
        for k in (sorted(tree) if isinstance(tree, dict) else range(len(tree))):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def port_fan_in(params, defs):
    """The reference's draw with each scaled weight rescaled from the
    reference's fan-in (shape[0]) to the port's (``base.fan_in_of``)."""
    if isinstance(defs, dict):
        return {k: port_fan_in(params[k], defs[k]) for k in defs}
    a = np.asarray(params, np.float32)
    if defs.init != "scaled":
        return a
    return (a * np.sqrt(defs.shape[0] / base.fan_in_of(defs))).astype(np.float32)


def _models(name: str, act: str, **kw):
    """(reference cfg, params; port cfg, Transformer) on the reference's
    weights from PRNGKey(1), rescaled by ``port_fan_in`` for the moe, hybrid
    and ssm families; ``kw`` replaces config fields on both sides."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), act_dtype=act, **kw)
    cfg = dataclasses.replace(configs.get_reduced(name), act_dtype=act, **kw)
    params = jax.tree.map(np.asarray, jbase.init_params(jax.random.PRNGKey(1), jtf.model_defs(jcfg)))
    if name in NEW:
        params = port_fan_in(params, transformer.model_defs(cfg))
    model = convert.lm_params(params, cfg, device="cpu")
    return jcfg, jax.tree.map(jnp.asarray, params), cfg, model


def _batch(jcfg):
    """The reference test's tokens (PRNGKey(2)); frames and patches from a
    seeded numpy draw, as bf16."""
    toks = jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, jcfg.vocab)
    rng = np.random.default_rng(0)
    if jcfg.family == "audio":
        return {"frames": jnp.asarray(rng.normal(size=(B, S, jcfg.frontend_dim)), jnp.bfloat16)}
    if jcfg.family == "vlm":
        patches = rng.normal(size=(B, jcfg.n_patches, jcfg.frontend_dim))
        return {"patches": jnp.asarray(patches, jnp.bfloat16), "tokens": toks[:, : S - jcfg.n_patches]}
    return {"tokens": toks}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_arch_configs_equal_reference(name):
    for get_p, get_j in ((configs.get, jconfigs.get), (configs.get_reduced, jconfigs.get_reduced)):
        got, want = get_p(name), get_j(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.n_params_active == want.n_params_active
        assert (got.hd, got.is_encoder, got.sub_quadratic) == (want.hd, want.is_encoder, want.sub_quadratic)


def test_registry_shapes_and_cells_equal_reference():
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert configs.ARCH_MODULES == jconfigs.ARCH_MODULES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert configs.all_cells() == jconfigs.all_cells()
    with pytest.raises(ValueError, match="unknown arch"):
        configs.get("gpt-2")


def _spec_leaves(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_input_specs_match_reference(name):
    cfg, jcfg = configs.get(name), jconfigs.get(name)
    for shape in SHAPES.values():
        jshape = JSHAPES[shape.name]
        ok = jconfigs.shape_applicable(jcfg, jshape)[0]
        if not ok:
            with pytest.raises(ValueError, match="skipped"):
                configs.input_specs(cfg, shape)
            continue
        want = jconfigs.input_specs(jcfg, jshape, abstract=True)
        got = configs.input_specs(cfg, shape, abstract=True)
        assert all(t.device.type == "meta" for t in _flat(got).values())
        assert _spec_leaves(got) == _spec_leaves(want), shape.name
    # Concrete inputs at a small size: the same token ids and labels.
    small_p, small_j = ShapeConfig("smoke", 24, 2, "train"), JShapeConfig("smoke", 24, 2, "train")
    cfg, jcfg = configs.get_reduced(name), jconfigs.get_reduced(name)
    got = _flat(configs.input_specs(cfg, small_p, abstract=False, device="cpu"))
    want = _flat(jconfigs.input_specs(jcfg, small_j, abstract=False))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


def test_decode_input_specs_concrete():
    cfg = configs.get_reduced("qwen1.5-0.5b")
    spec = configs.input_specs(cfg, ShapeConfig("d", 12, 2, "decode"), abstract=False, device="cpu")
    assert spec["state"]["kv"]["k"].shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads, cfg.hd)
    assert spec["state"]["kv"]["k"].dtype == torch.bfloat16
    assert int(spec["length"]) == 11 and spec["token"].shape == (2, 1)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE_BODY + NEW)
def test_param_defs_match_reference(name):
    cfg, jcfg = configs.get_reduced(name), jconfigs.get_reduced(name)
    got = _flat(transformer.model_defs(cfg))
    want = _flat(jtf.model_defs(jcfg))
    assert sorted(got) == sorted(want)
    for k, d in want.items():
        g = got[k]
        assert (g.shape, g.axes, g.init, g.scale) == (d.shape, d.axes, d.init, d.scale), k
    abstract = _spec_leaves(base.abstract_params(transformer.model_defs(cfg)))
    assert abstract == _spec_leaves(jbase.abstract_params(jtf.model_defs(jcfg)))
    # The full-size config's tree, too, without allocating it.
    full = base.abstract_params(transformer.model_defs(configs.get(name)))
    assert _spec_leaves(full) == _spec_leaves(jbase.abstract_params(jtf.model_defs(jconfigs.get(name))))


def test_init_params_initialisers():
    cfg = configs.get("qwen1.5-0.5b")
    cfg = dataclasses.replace(cfg, n_layers=3, vocab=4096)
    defs = transformer.model_defs(cfg)
    p1 = base.init_params(torch.Generator().manual_seed(5), defs)
    p2 = base.init_params(torch.Generator().manual_seed(5), defs)
    for k, v in _flat(p1).items():
        assert torch.equal(v, _flat(p2)[k]) and v.dtype == torch.float32, k
    lp = p1["layers"]
    assert torch.all(lp["attn_norm"]["scale"] == 1) and torch.all(lp["attn"]["bq"] == 0)
    # scaled: normal / sqrt(fan_in), fan_in the weight's own input width
    # (not the stacked shape[0], the layer count, as in the reference)
    for w, fan_in in ((lp["attn"]["wq"], cfg.d_model), (lp["mlp"]["down"]["w"], cfg.d_ff)):
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.01
    assert [base.fan_in_of(d) for d in (defs["layers"]["attn"]["wo"], defs["layers"]["mlp"]["down"]["w"],
                                        defs["layers"]["attn"]["bq"])] == [cfg.d_model, cfg.d_ff, 1]
    assert abs(float(p1["embed"]["tokens"].std()) - 0.02) < 0.0005
    assert float(p1["embed"]["tokens"].mean()) == pytest.approx(0.0, abs=1e-4)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-34b", "llava-next-34b", "hubert-xlarge"] + NEW)
def test_transformer_holds_the_reference_weights(name):
    """Every leaf, one parameter per stacked layer (nested for hybrid and
    ssm), equal to the reference's: fp32 for the norms' scales and the
    leaves the reference reads in fp32 (A_log, D, dt_bias, r), else cast
    to bf16 once."""
    jcfg, params, cfg, model = _models(name, "bfloat16")
    named = dict(model.named_parameters())
    flat = _flat(jax.tree.map(np.asarray, params))
    defs = _flat(transformer.model_defs(cfg))
    n_stacked = {k: sum(1 for a in d.axes if a == "layers") for k, d in defs.items()}
    assert len(named) == sum(int(np.prod(a.shape[: n_stacked[k]])) for k, a in flat.items())
    for k, a in flat.items():
        parts = k.strip("/").split("/")
        fp32 = parts[-2].endswith("norm") or parts[-1] in ("A_log", "D", "dt_bias", "r")
        for idx in np.ndindex(a.shape[: n_stacked[k]]):
            mod_name = ".".join(["tree", parts[0], *map(str, idx), *parts[1:]])
            t = named[mod_name]
            want = a[idx]
            assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), mod_name
            assert not t.requires_grad
            np.testing.assert_array_equal(
                t.float().numpy(), want if fp32 else np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32))


def test_lm_params_rejects_a_foreign_tree():
    cfg, jcfg = configs.get_reduced("qwen1.5-0.5b"), jconfigs.get_reduced("stablelm-3b")
    params = jax.tree.map(np.asarray, jbase.init_params(jax.random.PRNGKey(0), jtf.model_defs(jcfg)))
    with pytest.raises(ValueError):
        convert.lm_params(params, cfg, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_match_reference(dtype, rng):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32) * 30
    scale = rng.normal(size=(64,)).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, jdt))
    got = layers.rmsnorm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5 if dtype == "float32" else 1e-2, atol=1e-5)

    q = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = (np.arange(7)[None, :] + np.array([[0], [300]])).astype(np.int32)
    for theta in (10_000.0, 1e6):
        want = jlayers.rope(jnp.asarray(q, jdt), jnp.asarray(pos), theta)
        got = layers.rope(torch.as_tensor(q).to(tdt), torch.as_tensor(pos), theta)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5 if dtype == "float32" else 1e-2,
                                   atol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_reference(kind, rng):
    d, dff = 64, 128
    w = {k: (rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("gate", (d, dff)), ("up", (d, dff)), ("down", (dff, d)))}
    if kind == "gelu":
        del w["gate"]
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    want = jlayers.mlp({k: {"w": jnp.asarray(v)} for k, v in w.items()}, jnp.asarray(x), kind)
    got = layers.mlp({k: {"w": torch.as_tensor(v)} for k, v in w.items()}, torch.as_tensor(x), kind)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # gelu is jax.nn.gelu's tanh form, which differs from the exact erf form
    if kind == "gelu":
        h = torch.as_tensor(x) @ torch.as_tensor(w["up"])
        exact = torch.nn.functional.gelu(h) @ torch.as_tensor(w["down"])
        assert float((exact - got).abs().max()) > 1e-5


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = [  # (arch whose reduced heads it takes, causal, schedule)
    ("llava-next-34b", True, "rect"), ("llava-next-34b", True, "blocklist"),
    ("llava-next-34b", False, "rect"), ("granite-34b", True, "rect"),
    ("granite-34b", True, "blocklist"), ("granite-34b", False, "blocklist"),
]


@pytest.mark.parametrize("name,causal,mode", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches_reference(name, causal, mode, dtype, rng):
    cfg = configs.get_reduced(name)  # llava: H 4, KV 2 (GQA); granite: H 4, KV 1 (MQA)
    H, KV, hd, s = cfg.n_heads, cfg.n_kv_heads, cfg.hd, 48
    q, k, v = (rng.normal(size=(2, s, n, hd)).astype(np.float32) * 2 for n in (H, KV, KV))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jattn.chunked_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal,
                                   q_chunk=16, kv_chunk=16, causal_mode=mode)
    got = attention.chunked_attention(*(torch.as_tensor(a).to(tdt) for a in (q, k, v)), causal=causal,
                                      q_chunk=16, kv_chunk=16, causal_mode=mode)
    assert got.shape == (2, s, H, hd) and got.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_chunked_attention_schedules_agree(rng):
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 64, 4, 16)).astype(np.float32)) for _ in range(3))
    rect = attention.chunked_attention(q, k, v, causal=True, q_chunk=16, kv_chunk=32, causal_mode="rect")
    block = attention.chunked_attention(q, k, v, causal=True, q_chunk=16, kv_chunk=16)
    one = attention.chunked_attention(q, k, v, causal=True, q_chunk=64, kv_chunk=64)
    torch.testing.assert_close(rect, block, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(one, block, rtol=1e-5, atol=1e-5)
    with pytest.raises(AssertionError):
        attention.chunked_attention(q, k, v, causal=True, q_chunk=16, kv_chunk=32)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "llava-next-34b", "granite-34b"])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(name, act, rng):
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), act_dtype=act)
    cfg = dataclasses.replace(configs.get_reduced(name), act_dtype=act)
    jp = jbase.init_params(jax.random.PRNGKey(3), jattn.attn_defs(jcfg))
    if cfg.qkv_bias:  # zero-initialised: give the biases values
        jp = dict(jp, **{b: jnp.asarray(rng.normal(size=jp[b].shape), jnp.float32) for b in ("bq", "bk", "bv")})
    tp = {k: _t(v) for k, v in jp.items()}
    max_len, length = 12, 7
    kc = rng.normal(size=(B, max_len, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    jdt = jnp.float32 if act == "float32" else jnp.bfloat16
    cache_j = {"k": jnp.asarray(kc, jnp.bfloat16), "v": jnp.asarray(vc, jnp.bfloat16)}
    cache_t = {k: _t(v) for k, v in cache_j.items()}
    y_j, new_j = jattn.decode_attention(jp, jnp.asarray(x, jdt), cache_j, jnp.int32(length), jcfg)
    y_t, new_t = attention.decode_attention(tp, _t(jnp.asarray(x, jdt)), cache_t, length, cfg)
    assert new_t["k"] is cache_t["k"]  # written in place
    for k in ("k", "v"):
        assert new_t[k].dtype == torch.bfloat16
        np.testing.assert_allclose(_np(new_t[k]), _np(new_j[k]), rtol=1e-2, atol=1e-2)
        keep = np.arange(max_len) != length  # every other slot untouched
        np.testing.assert_array_equal(_np(new_t[k])[:, keep], _np(cache_j[k])[:, keep])
    tol = FP32 if act == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(y_t), _np(y_j), **tol)
    # a 0-dim tensor length, as input_specs gives it, writes the same slot
    cache2 = {k: _t(v) for k, v in cache_j.items()}
    y2, _ = attention.decode_attention(tp, _t(jnp.asarray(x, jdt)), cache2, torch.tensor(length, dtype=torch.int32), cfg)
    assert torch.equal(y2, y_t) and torch.equal(cache2["k"], new_t["k"])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE_BODY)
def test_forward_fp32_matches_reference(name):
    jcfg, params, cfg, model = _models(name, "float32")
    batch = _batch(jcfg)
    for mode in ("blocklist", "rect"):
        want, aux_j = jtf.forward(params, batch, jcfg, causal_mode=mode)
        got, aux = transformer.forward(model.tree, {k: _t(v) for k, v in batch.items()}, cfg, causal_mode=mode)
        assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), **FP32)
        assert (_np(got).argmax(-1) == _np(want).argmax(-1)).all()
        assert float(aux) == float(aux_j) == 0.0
    last, _ = model({k: _t(v) for k, v in batch.items()}, last_only=True)
    assert last.shape == (B, 1, cfg.vocab)
    np.testing.assert_allclose(_np(last)[:, 0], _np(want)[:, -1], **FP32)


@pytest.mark.parametrize("name", DENSE_BODY)
def test_forward_bf16_matches_reference(name):
    jcfg, params, cfg, model = _models(name, "bfloat16")
    batch = _batch(jcfg)
    want, _ = jtf.forward(params, batch, jcfg)
    got, _ = model({k: _t(v) for k, v in batch.items()})
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    agree = (_np(got).argmax(-1) == _np(want).argmax(-1)).mean()
    assert agree > 0.95, agree


@pytest.mark.parametrize("name", ["stablelm-3b", "qwen1.5-0.5b", "granite-34b"])
def test_decode_matches_forward(name):
    """The reference's own invariant, on the port: prefill-by-decode gives
    the full forward's logits (bf16 bar of tests/test_models.py)."""
    jcfg, _, cfg, model = _models(name, "bfloat16")
    toks = _t(jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, cfg.vocab))
    full, _ = model({"tokens": toks})
    state = model.init_state(B, S)
    dec = torch.cat([model.decode_step(toks[:, t : t + 1], state, t)[0] for t in range(S)], dim=1)
    np.testing.assert_allclose(_np(full), _np(dec), **BF16)
    assert (_np(full).argmax(-1) == _np(dec).argmax(-1)).mean() > 0.95


def test_encoder_has_no_decode_state():
    cfg = configs.get_reduced("hubert-xlarge")
    with pytest.raises(ValueError, match="no decode state"):
        transformer.init_state(cfg, 1, 4, device="cpu")


# ---------------------------------------------------------------------------
# the moe, hybrid and ssm families
# ---------------------------------------------------------------------------


def test_fan_in_of_batched_and_doubly_stacked_weights():
    """The input width of an expert's, a head's and a (groups, per group)
    stacked weight: the dimension ``x @ w`` contracts."""
    moe_defs = transformer.model_defs(configs.get("deepseek-moe-16b"))["layers"]["moe"]
    assert [base.fan_in_of(moe_defs[k]) for k in ("router", "gate", "down")] == [2048, 2048, 1408]
    xl = configs.get("xlstm-1.3b")
    defs = transformer.model_defs(xl)
    assert base.fan_in_of(defs["slstm_layers"]["slstm"]["r"]) == 2 * xl.d_model // xl.n_heads
    assert base.fan_in_of(defs["layers"]["mlstm"]["wq"]) == 2 * xl.d_model
    zd = transformer.model_defs(configs.get("zamba2-2.7b"))["layers"]["mamba"]
    assert [base.fan_in_of(zd[k]) for k in ("in_proj", "out_proj", "A_log")] == [2560, 5120, 1]


# Where the reference's 0.15 bar does not hold at bf16: how far worst
# |got - want| - 0.15 |want| exceeds 0.15 on these inputs (reduced
# configs, CPU; printed by the tests) and the bound held, a small factor
# above it. Along llama4's decode path a bf16 rounding moves a top-1
# router logit across a near-tie and a token takes another expert (an
# isolated position off by ~1: the reference's own llama4 decode misses
# its forward by more than the bar on these inputs); the mLSTM divides by
# max(|q.n|, 1e-6) and so amplifies a rounding.
BF16_EXCESS = {  # (arch, path): (measured, bound)
    ("llama4-scout-17b-a16e", "decode"): (0.727, 0.85),
    ("xlstm-1.3b", "forward"): (0.011, 0.05),
    ("xlstm-1.3b", "decode"): (0.169, 0.25),
}


def _bf16_bar(cfg, got: np.ndarray, want: np.ndarray, path: str) -> None:
    """Argmax agreement > 0.9 (the reference's bar for hybrid and ssm) and
    the 0.15 bar, or where ``BF16_EXCESS`` lists (cfg, path) its bound on
    the excess over 0.15."""
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    _, bound = BF16_EXCESS.get((cfg.name, path), (None, 0.0))
    excess = float((np.abs(got - want) - BF16["rtol"] * np.abs(want)).max())
    print(f"{cfg.name} bf16 {path}: excess over 0.15 {excess - BF16['atol']:.4f}, agreement {agree:.4f}")
    assert agree > 0.9, agree
    assert excess <= BF16["atol"] + bound, excess


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_forward_matches_reference_moe_hybrid_ssm(name, act):
    jcfg, params, cfg, model = _models(name, act)
    batch = _batch(jcfg)
    want, aux_j = jtf.forward(params, batch, jcfg)
    got, aux = model({k: _t(v) for k, v in batch.items()})
    assert got.shape == (B, S, cfg.vocab) and got.dtype == layers.act_dt(cfg)
    assert aux.dtype == torch.float32 and (float(aux) > 0) == (cfg.family == "moe")
    if act == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **FP32)
        assert (_np(got).argmax(-1) == _np(want).argmax(-1)).all()
        np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)
        last, _ = model({k: _t(v) for k, v in batch.items()}, last_only=True)
        np.testing.assert_allclose(_np(last)[:, 0], _np(want)[:, -1], **FP32)
    else:
        _bf16_bar(cfg, _np(got), _np(want), "forward")
        np.testing.assert_allclose(float(aux), float(aux_j), rtol=0.15)


# At act fp32 a KV cache is still bf16 (the reference's): where the two
# sides' fp32 k, v or attention probabilities lie within a rounding of a
# bf16 boundary they store neighbouring values, 2^-8 apart. With fp32
# caches every family's decode meets FP32
# (``test_decode_step_fp32_caches_match_reference``). Through the bf16
# caches the largest logit gaps measured on these inputs (reduced configs,
# CPU) are deepseek-moe-16b 4.4e-3 over 8 decode steps and 7.1e-3 over
# greedy generation, zamba2-2.7b 6.9e-4 over greedy generation (4e-6 over
# 8 steps), the others under 2e-5; those two are held a small factor above
# that, well under the gap of the same path run at bf16 (4.3e-2, 1.0e-1).
KV_TOL = {"deepseek-moe-16b": dict(rtol=1e-2, atol=1e-2), "zamba2-2.7b": dict(rtol=2e-3, atol=2e-3)}


def fp32_kv_tol(name: str) -> dict:
    """Tolerance of fp32 logits read through the reference's bf16 caches."""
    return KV_TOL.get(name, FP32)


def _state_layout(got, want) -> tuple[dict, dict]:
    """The two state trees' leaves by path, after asserting equal paths,
    shapes and dtypes."""
    g, w = _flat(got), _flat(want)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in g.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in w.items()}
    return g, w


def _state_close(got, want, tol: dict) -> None:
    g, w = _state_layout(got, want)
    for k in w:
        np.testing.assert_allclose(_np(g[k]), _np(w[k]), err_msg=k, **tol)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_decode_step_matches_reference(name, act):
    """Eight decode steps from ``init_state``: every step's logits, and the
    state's tree, shapes, dtypes (Mamba2's conv history turns to the
    activation dtype after a step, as in the reference) and, at fp32,
    values."""
    jcfg, params, cfg, model = _models(name, act)
    T = 8
    toks = jax.random.randint(jax.random.PRNGKey(2), (B, T), 0, cfg.vocab)
    st_j, st_t = jtf.init_state(jcfg, B, T), model.init_state(B, T)
    _state_close(st_t, st_j, FP32)
    step = jax.jit(lambda p, t, s, n: jtf.decode_step(p, t, s, n, jcfg))
    want, got = [], []
    for t in range(T):
        lg, st_j = step(params, toks[:, t : t + 1], st_j, jnp.int32(t))
        want.append(_np(lg)[:, 0])
        lg, st_t = model.decode_step(_t(toks[:, t : t + 1]), st_t, t)
        got.append(_np(lg)[:, 0])
    want, got = np.stack(want, 1), np.stack(got, 1)
    if act == "float32":
        print(f"{name} fp32 decode through the bf16 KV cache: max |d| {np.abs(got - want).max():.3e}")
        np.testing.assert_allclose(got, want, **fp32_kv_tol(name))
        assert (got.argmax(-1) == want.argmax(-1)).all()
        _state_close(st_t, st_j, FP32)
    else:
        _bf16_bar(cfg, got, want, "decode")
        _state_layout(st_t, st_j)


def _fp32_caches(state: dict, cast) -> dict:
    """``state`` with its KV caches (``kv``, deepseek's ``kv0``) as fp32."""
    return {k: {n: cast(c) for n, c in v.items()} if k in ("kv", "kv0") else v for k, v in state.items()}


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "llama4-scout-17b-a16e", "zamba2-2.7b"])
def test_decode_step_fp32_caches_match_reference(name):
    """At act fp32 with every KV cache in fp32 on both sides, eight decode
    steps' logits and states meet FP32: the bf16 caches' rounding is the
    only gap ``fp32_kv_tol`` allows for."""
    jcfg, params, cfg, model = _models(name, "float32")
    T = 8
    toks = jax.random.randint(jax.random.PRNGKey(2), (B, T), 0, cfg.vocab)
    st_j = _fp32_caches(jtf.init_state(jcfg, B, T), lambda c: c.astype(jnp.float32))
    st_t = _fp32_caches(model.init_state(B, T), lambda c: c.float())
    step = jax.jit(lambda p, t, s, n: jtf.decode_step(p, t, s, n, jcfg))
    want, got = [], []
    for t in range(T):
        lg, st_j = step(params, toks[:, t : t + 1], st_j, jnp.int32(t))
        want.append(_np(lg)[:, 0])
        lg, st_t = model.decode_step(_t(toks[:, t : t + 1]), st_t, t)
        got.append(_np(lg)[:, 0])
    got, want = np.stack(got, 1), np.stack(want, 1)
    print(f"{name} fp32 decode through fp32 KV caches: max |d| {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, **FP32)
    assert st_t["kv"]["k"].dtype == torch.float32
    _state_close(st_t, st_j, FP32)


@pytest.mark.parametrize("name", NEW)
def test_decode_matches_forward_moe_hybrid_ssm(name):
    """The reference's invariant on the port: prefill-by-decode gives the
    full forward's logits, on the dense families' bar (0.15, argmax
    agreement > 0.95). hybrid and ssm at bf16; moe at act fp32 (at bf16 a
    rounding moves routing across near-ties, ``BF16_EXCESS``) with
    capacity factor n_experts / top_k so that the forward drops nothing,
    as decode never does."""
    cfg = configs.get_reduced(name)
    kw = {"capacity_factor": cfg.n_experts / cfg.top_k} if cfg.family == "moe" else {}
    _, _, cfg, model = _models(name, "float32" if cfg.family == "moe" else "bfloat16", **kw)
    toks = _t(jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, cfg.vocab))
    full, _ = model({"tokens": toks})
    state = model.init_state(B, S)
    dec = torch.cat([model.decode_step(toks[:, t : t + 1], state, t)[0] for t in range(S)], dim=1)
    excess = float((np.abs(_np(full) - _np(dec)) - 0.15 * np.abs(_np(dec))).max()) - 0.15
    agree = (_np(full).argmax(-1) == _np(dec).argmax(-1)).mean()
    print(f"{name} {cfg.act_dtype} forward vs decode: excess over 0.15 {excess:.4f}, agreement {agree:.4f}")
    np.testing.assert_allclose(_np(full), _np(dec), **BF16)
    assert agree > 0.95, agree
