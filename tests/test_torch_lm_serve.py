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
import os
import subprocess
import sys
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
from repro_torch.models import transformer
from repro_torch.train import train_step as ts

ROOT = Path(__file__).resolve().parents[1]
FP32 = dict(rtol=1e-4, atol=1e-4)
GREEDY_ARCHS = ["qwen1.5-0.5b", "stablelm-3b", "phi3-mini-3.8b", "granite-34b", "llava-next-34b"]
B, PROMPT, GEN = 2, 8, 8


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(name: str, act: str = "float32", key: int = 0):
    jcfg = dataclasses.replace(jconfigs.get_reduced(name), act_dtype=act)
    cfg = dataclasses.replace(configs.get_reduced(name), act_dtype=act)
    params = jbase.init_params(jax.random.PRNGKey(key), jtf.model_defs(jcfg))
    return jcfg, params, cfg, convert.lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")


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
    np.testing.assert_allclose(np.stack(logits, 1), want_logits, **FP32)


def test_prompts_are_the_reference_draw():
    cfg = configs.get_reduced("qwen1.5-0.5b")
    got = serve.lm_prompts(cfg, 4, 32, device="cpu")
    want = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-34b", "llava-next-34b", "hubert-xlarge"])
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.build_model(configs.get_reduced("zamba2-2.7b"), device="cpu")
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
