"""The port's serving path (``launch.serve``, ``train.train_step``) against
the JAX package's, on reduced configs on the CPU.

Greedy generation runs the reference's serve loop (``prefill_by_decode``
one prompt token at a time, then decode from the last prompt token at
position ``prompt_len``) on the reference's weights (``PRNGKey(0)``, as its
``serve_lm``) carried over by ``convert.lm_params``, with the reference's
prompts (``np.random.default_rng(0)``). At ``act_dtype="float32"`` the
generated ids are identical and every step's logits agree within rtol
1e-4 / atol 1e-4 (the fp32 bar of ``test_torch_lm_models.py``; the KV
cache is bf16 in both, as in the reference).
"""
import dataclasses
import math
import os
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import base as jbase
from repro.models import transformer as jtf
from repro.train import train_step as jts
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import base, transformer
from repro_torch.train import train_step as ts
from test_torch_lm_models import fp32_kv_tol, port_fan_in

ROOT = Path(__file__).resolve().parents[1]
FP32 = dict(rtol=1e-4, atol=1e-4)
GREEDY_ARCHS = ["qwen1.5-0.5b", "stablelm-3b", "phi3-mini-3.8b", "granite-34b", "llava-next-34b",
                "deepseek-moe-16b", "llama4-scout-17b-a16e", "zamba2-2.7b", "xlstm-1.3b"]
NEW = GREEDY_ARCHS[5:]
B, PROMPT, GEN = 2, 8, 8


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(name: str, act: str = "float32", key: int = 0):
    """(reference cfg, params; port cfg, Transformer) on the reference's
    draw; for the moe, hybrid and ssm families with each scaled weight at
    the port's fan-in (``port_fan_in``: under the reference's scale those
    reduced models amplify fp32 summation order past the 1e-4 bar)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), act_dtype=act)
    cfg = dataclasses.replace(configs.get_reduced(name), act_dtype=act)
    params = jax.tree.map(np.asarray, jbase.init_params(jax.random.PRNGKey(key), jtf.model_defs(jcfg)))
    if name in NEW:
        params = port_fan_in(params, transformer.model_defs(cfg))
    return jcfg, jax.tree.map(jnp.asarray, params), cfg, convert.lm_params(params, cfg, device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree) for k2, v in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _reference_generate(jcfg, params, prompts):
    """The reference's serve_lm loop, keeping every decode step's logits."""
    step = jax.jit(jts.make_serve_step(jcfg))
    state = jtf.init_state(jcfg, B, PROMPT + GEN)
    state = jserve.prefill_by_decode(params, jnp.asarray(prompts), jcfg, state, step)
    tok, ids, logits = jnp.asarray(prompts[:, -1:]), [], []
    for i in range(GEN):
        tok, lg, state = step(params, tok, state, jnp.int32(PROMPT + i))
        ids.append(np.asarray(tok)[:, 0])
        logits.append(_np(lg)[:, 0])
    return np.stack(ids, 1), np.stack(logits, 1)


@pytest.mark.parametrize("name", GREEDY_ARCHS)
def test_greedy_generation_fp32_matches_reference(name):
    jcfg, params, cfg, model = _pair(name)
    prompts = serve.lm_prompts(cfg, B, PROMPT, device="cpu")
    want_ids, want_logits = _reference_generate(jcfg, params, prompts.numpy())

    step = ts.make_serve_step(cfg)
    ids, t_prefill, t_decode = serve.generate(model, prompts, GEN, step)
    assert ids.dtype == torch.int32 and ids.shape == (B, GEN)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    assert t_prefill >= 0 and t_decode >= 0

    # The same loop by hand, holding each step's logits.
    state = serve.prefill_by_decode(model, prompts, cfg, model.init_state(B, PROMPT + GEN), step)
    tok, logits = prompts[:, -1:], []
    for i in range(GEN):
        tok, lg, state = step(model, tok, state, PROMPT + i)
        logits.append(_np(lg)[:, 0])
    logits = np.stack(logits, 1)
    print(f"{name} fp32 greedy generation: max |d logit| {np.abs(logits - want_logits).max():.3e}")
    np.testing.assert_allclose(logits, want_logits, **fp32_kv_tol(name))


def test_prompts_are_the_reference_draw():
    cfg = configs.get_reduced("qwen1.5-0.5b")
    got = serve.lm_prompts(cfg, 4, 32, device="cpu")
    want = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-34b", "llava-next-34b", "hubert-xlarge"] + NEW)
def test_prefill_step_matches_reference(name):
    jcfg, params, cfg, model = _pair(name)
    rng = np.random.default_rng(1)
    if cfg.family == "audio":
        batch = {"frames": rng.normal(size=(B, 16, cfg.frontend_dim)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, 16)).astype(np.int32)}
        if cfg.family == "vlm":
            batch["patches"] = rng.normal(size=(B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    want = jts.make_prefill_step(jcfg)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = ts.make_prefill_step(cfg)(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert got.shape == (B, 1, cfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **FP32)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "hubert-xlarge", "llava-next-34b"])
def test_cross_entropy_and_eval_step_match_reference(name):
    jcfg, params, cfg, model = _pair(name)
    rng = np.random.default_rng(2)
    S = 16
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, :3] = -1  # masked positions
    if cfg.family == "audio":
        batch = {"frames": rng.normal(size=(B, S, cfg.frontend_dim)).astype(np.float32)}
    elif cfg.family == "vlm":
        batch = {"patches": rng.normal(size=(B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32),
                 "tokens": rng.integers(0, cfg.vocab, (B, S - cfg.n_patches)).astype(np.int32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"] = labels
    want = jts.make_eval_step(jcfg)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = ts.make_eval_step(cfg)(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert int(got["n_tokens"]) == int(want["n_tokens"])
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    assert float(got["aux"]) == float(want["aux"]) == 0.0

    logits = rng.normal(size=(B, 12, 40)).astype(np.float32)
    lab = rng.integers(-1, 40, (B, 14)).astype(np.int32)  # longer than logits: right-aligned
    for shift in (True, False):
        wl, wn = jts.cross_entropy(jnp.asarray(logits), jnp.asarray(lab), shift)
        gl, gn = ts.cross_entropy(torch.as_tensor(logits), torch.as_tensor(lab), shift)
        np.testing.assert_allclose(float(gl), float(wl), rtol=1e-6)
        assert int(gn) == int(wn)


def test_sampling_step_draws_from_the_generator():
    _, _, cfg, model = _pair("qwen1.5-0.5b")
    step = ts.make_serve_step(cfg, "sample", 0.7)
    prompts = serve.lm_prompts(cfg, B, PROMPT, device="cpu")
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        ids, _, _ = serve.generate(model, prompts, GEN, step, gen)
        runs.append(ids)
    assert torch.equal(runs[0], runs[1])
    assert bool(((runs[0] >= 0) & (runs[0] < cfg.vocab)).all())


def test_later_families_and_encoders_are_refused():
    args = serve.parse_args(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])
    assert args.cmd == "lm" and args.device == "cpu"  # bare --arch means lm
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.serve_lm(args)
    assert serve.parse_args(["lm", "--arch", "qwen1.5-0.5b"]).device == "cuda"


def test_build_model_is_seeded():
    cfg = configs.get_reduced("granite-34b")
    a, b = (serve.build_model(cfg, seed=4, device="cpu") for _ in range(2))
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert isinstance(a, transformer.Transformer) and a.tree["embed"]["tokens"].dtype == torch.bfloat16


def _run(*argv: str) -> str:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *argv],
                         capture_output=True, text=True, env=env, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("extra", [(), ("--temperature", "0.5")])
def test_serve_lm_cli_on_cpu(extra):
    out = _run("lm", "--arch", "qwen1.5-0.5b", "--reduced", "--batch", "2", "--prompt-len", "8",
               "--gen", "8", "--device", "cpu", *extra)
    assert "decode 8 steps" in out and out.strip().endswith("ok"), out


def test_serve_range_cli_on_cpu():
    out = _run("range", "--n", "3000", "--m", "8", "--queries", "512", "--batch", "128",
               "--delta", "2.0", "--device", "cpu")
    assert "pinned V buffers on 1 rank(s)" in out
    assert out.strip().endswith("parity vs brute force: ok"), out


def test_build_model_holds_reference_fp32_leaves_in_fp32():
    """The leaves the reference reads in fp32 without a cast (Mamba2's
    A_log, D, dt_bias; sLSTM's r) stay fp32 for serving, like the norms'
    scales; every other leaf is bf16."""
    seen = set()
    for name in ("zamba2-2.7b", "xlstm-1.3b", "deepseek-moe-16b"):
        model = serve.build_model(configs.get_reduced(name), device="cpu")
        for pname, p in model.named_parameters():
            leaf, parent = pname.split(".")[-1], pname.split(".")[-2]
            fp32 = leaf in ("A_log", "D", "dt_bias", "r") or parent.endswith("norm")
            assert p.dtype == (torch.float32 if fp32 else torch.bfloat16), pname
            seen.add(leaf)
    assert {"A_log", "D", "dt_bias", "r", "router", "gate"} <= seen


def test_build_model_draws_leaf_by_leaf(monkeypatch):
    """``build_model`` gives the weights of drawing the whole fp32 tree and
    casting it (the earlier build) bit for bit, while the fp32 normals it
    draws are freed leaf by leaf: at most one is alive at a time."""
    cfg = configs.get_reduced("granite-34b")
    gen = torch.Generator().manual_seed(3)
    tree = base.init_params(gen, transformer.model_defs(cfg))  # fp32 whole
    old = transformer.Transformer(cfg, tree)
    del tree, gen

    alive, peak, randn = [0], [0], torch.randn

    def counted(*args, **kw):
        z = randn(*args, **kw)
        n = z.numel() * z.element_size()
        alive[0] += n
        peak[0] = max(peak[0], alive[0])
        weakref.finalize(z, lambda: alive.__setitem__(0, alive[0] - n))
        return z

    monkeypatch.setattr(torch, "randn", counted)
    new = serve.build_model(cfg, seed=3, device="cpu")
    monkeypatch.undo()
    got = dict(new.named_parameters())
    for name, p in old.named_parameters():
        assert got[name].dtype == p.dtype and torch.equal(got[name], p), name
    leaves = base.tree_map(lambda d: math.prod(d.shape) * 4 if d.init in ("normal", "scaled") else 0,
                           transformer.model_defs(cfg))
    sizes = list(_flat(leaves).values())
    assert peak[0] == max(sizes) < sum(sizes)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "xlstm-1.3b"])
def test_serve_lm_example_on_cpu(name):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "serve_lm_torch.py"), "--arch", name,
                          "--device", "cpu"], capture_output=True, text=True, env=env, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "decode 24 steps" in out.stdout and out.stdout.strip().endswith("ok"), out.stdout


def test_decode_gap_example_on_cpu():
    """examples/lm_decode_gap_torch.py: at act fp32 with fp32 KV caches a
    reduced zamba2's forward and decode agree at every position."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "lm_decode_gap_torch.py"), "--arch",
                          "zamba2-2.7b", "--reduced", "--device", "cpu", "--act", "float32", "--fp32-caches",
                          "--batch", "2", "--prompt-len", "8"],
                         capture_output=True, text=True, env=env, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "(0 of 16 positions over 0.15)" in out.stdout and "argmax agreement 1.0000" in out.stdout, out.stdout
