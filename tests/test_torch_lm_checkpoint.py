"""Checkpoints, the token pipeline and the training launcher of the port,
against the JAX package's where both have them, on the CPU.

- A checkpoint written by either package restores in the other with every
  leaf equal (the same directory layout, ``meta.json`` and leaf numbering).
- The port's own contract: atomic publish, ``keep_k`` garbage collection,
  and a resumed run that reproduces an uninterrupted one (the reference's
  bound, rel 1e-5; on the CPU the two runs are equal).
- ``TokenPipeline`` and ``token_example`` give the reference's arrays bit
  for bit (dense, vlm, audio).
- ``python -m repro_torch.launch.train --device cpu`` crashes on
  ``--fail-at`` and ``--resume`` runs it to the end; the two training
  examples run with ``--device cpu``.
"""
import dataclasses
import json
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
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import base as jbase
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs, convert
from repro_torch.data import pipeline, synthetic
from repro_torch.launch import train as train_lib
from repro_torch.models import base
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

ROOT = Path(__file__).resolve().parents[1]
NAME = "qwen1.5-0.5b"


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ref_state(compress: bool):
    """The reference's (cfg, params, opt state) after one jitted train step
    on a reduced qwen, as numpy."""
    jcfg = jconfigs.get_reduced(NAME)
    ocfg = jopt.OptConfig(total_steps=50, warmup_steps=2, compress_grads=compress)
    params = jbase.init_params(jax.random.PRNGKey(0), jtf.model_defs(jcfg))
    state = jopt.init_opt_state(params, ocfg)
    batch = jpipe.TokenPipeline(jcfg, jpipe.PipelineConfig(seq_len=32, global_batch=2)).global_batch(0)
    step = jax.jit(jts.make_train_step(jcfg, ocfg, jts.StepConfig()))
    params, state, _ = step(params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    return jcfg, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _port_like(compress: bool):
    cfg = configs.get_reduced(NAME)
    model = train_lib.build_model(cfg, seed=3, device="cpu")
    return model, opt.init_opt_state(model.param_tree(), opt.OptConfig(compress_grads=compress))


@pytest.mark.parametrize("compress", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, compress):
    _, params, state = _ref_state(compress)
    jckpt.save(str(tmp_path), jckpt.TrainState(params, state, step=7, data_cursor=28, rng_seed=3))
    model, like = _port_like(compress)
    back = ckpt_lib.restore(str(tmp_path), ckpt_lib.TrainState(model.param_tree(), like, 0, 0, 0))
    assert (back.step, back.data_cursor, back.rng_seed) == (7, 28, 3)
    want = jax.tree.leaves({"params": params, "opt_state": state})
    got = base.tree_leaves({"params": back.params, "opt_state": back.opt_state})
    assert len(got) == len(want) == 1 + (4 if compress else 3) * len(jax.tree.leaves(params))
    for a, b in zip(want, got):
        assert b.dtype == (torch.int32 if a.dtype == np.int32 else torch.float32)
        np.testing.assert_array_equal(_np(b), a)
    assert isinstance(back.opt_state, opt.AdamState) and back.opt_state.step.dtype == torch.int32
    assert (back.opt_state.ef_residual is None) == (not compress)
    model.load_param_tree(back.params)
    for a, b in zip(jax.tree.leaves(params), base.tree_leaves(model.param_tree())):
        np.testing.assert_array_equal(_np(b), a)


@pytest.mark.parametrize("compress", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, compress):
    jcfg, params, state = _ref_state(compress)
    model = convert.lm_params(params, configs.get_reduced(NAME), device="cpu", trainable=True)
    pstate = convert.adam_state(state, configs.get_reduced(NAME), device="cpu")
    ckpt_lib.save(str(tmp_path / "port"), ckpt_lib.TrainState(model.param_tree(), pstate, 9, 36, 1))
    jckpt.save(str(tmp_path / "ref"), jckpt.TrainState(params, state, 9, 36, 1))
    for d in ("port", "ref"):  # the same files, leaf for leaf
        path = tmp_path / d / "step_000000009"
        assert sorted(os.listdir(path)) == ["meta.json", "shard_0.npz"]
    assert (json.loads((tmp_path / "port/step_000000009/meta.json").read_text())
            == json.loads((tmp_path / "ref/step_000000009/meta.json").read_text()))
    with np.load(tmp_path / "port/step_000000009/shard_0.npz") as zp, \
            np.load(tmp_path / "ref/step_000000009/shard_0.npz") as zr:
        assert sorted(zp.files) == sorted(zr.files)
        for k in zr.files:
            assert zp[k].dtype == zr[k].dtype and zp[k].shape == zr[k].shape
            np.testing.assert_array_equal(zp[k], zr[k])
    zeros = jax.tree.map(jnp.zeros_like, (params, state))
    back = jckpt.restore(str(tmp_path / "port"), jckpt.TrainState(*zeros, 0, 0, 0))
    assert (back.step, back.data_cursor, back.rng_seed) == (9, 36, 1)
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((back.params, back.opt_state))):
        np.testing.assert_array_equal(np.asarray(b), a)


def test_multi_host_shards_round_trip(tmp_path):
    """Two hosts each write their leaves (i % 2); host 0 publishes; the
    reference reads the result."""
    _, params, state = _ref_state(False)
    cfg = configs.get_reduced(NAME)
    model = convert.lm_params(params, cfg, device="cpu", trainable=True)
    pstate = convert.adam_state(state, cfg, device="cpu")
    st = ckpt_lib.TrainState(model.param_tree(), pstate, 4, 16, 0)
    ckpt_lib.save(str(tmp_path), st, host_id=1, n_hosts=2)
    ckpt_lib.save(str(tmp_path), st, host_id=0, n_hosts=2)
    assert sorted(os.listdir(tmp_path / "step_000000004")) == ["meta.json", "shard_0.npz", "shard_1.npz"]
    zeros = jax.tree.map(jnp.zeros_like, (params, state))
    back = jckpt.restore(str(tmp_path), jckpt.TrainState(*zeros, 0, 0, 0))
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((back.params, back.opt_state))):
        np.testing.assert_array_equal(np.asarray(b), a)


def test_checkpoint_atomicity(tmp_path):
    """A stale tmp dir (crash artifact) is invisible to latest_step."""
    os.makedirs(tmp_path / "step_000000099.tmp")
    assert ckpt_lib.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        ckpt_lib.restore(str(tmp_path), ckpt_lib.TrainState({}, {}, 0, 0, 0))
    p = {"w": torch.ones(3)}
    ckpt_lib.save(str(tmp_path), ckpt_lib.TrainState(p, {"s": p}, 5, 0, 0))
    assert ckpt_lib.latest_step(str(tmp_path)) == 5
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    with pytest.raises(ValueError, match="shape"):
        ckpt_lib.restore(str(tmp_path), ckpt_lib.TrainState({"w": torch.ones(4)}, {"s": {"w": torch.ones(4)}}, 0, 0, 0))


def test_checkpoint_keep_k(tmp_path):
    p = {"w": torch.ones(3)}
    for s in range(6):
        ckpt_lib.save(str(tmp_path), ckpt_lib.TrainState(p, {}, s, 0, 0), keep_k=3)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000003", "step_000000004", "step_000000005"]
    assert ckpt_lib.latest_step(str(tmp_path)) == 5


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """The reference's test on the port (bf16 activations over fp32
    leaves): 2 steps, save, restore into freshly built objects, 2 more,
    against 4 straight steps."""
    cfg = configs.get_reduced(NAME)
    ocfg = opt.OptConfig(total_steps=50, warmup_steps=2)
    step = ts.make_train_step(cfg, ocfg, ts.StepConfig())
    batch = train_lib.to_device(
        pipeline.TokenPipeline(cfg, pipeline.PipelineConfig(seq_len=64, global_batch=4)).global_batch(0), "cpu")

    def fresh():
        model = train_lib.build_model(cfg, seed=0, device="cpu")
        return model, opt.init_opt_state(model.param_tree(), ocfg)

    model, state = fresh()
    for _ in range(4):
        model, state, m = step(model, state, batch)
    straight = float(m["total"])

    model, state = fresh()
    for _ in range(2):
        model, state, _ = step(model, state, batch)
    ckpt_lib.save(str(tmp_path), ckpt_lib.TrainState(model.param_tree(), state, 2, 8, 0))
    model, state = fresh()
    back = ckpt_lib.restore(str(tmp_path), ckpt_lib.TrainState(model.param_tree(), state, 0, 0, 0))
    model.load_param_tree(back.params)
    state = back.opt_state
    assert int(state.step) == 2
    for _ in range(2):
        model, state, m = step(model, state, batch)
    assert float(m["total"]) == pytest.approx(straight, rel=1e-5)
    assert float(m["total"]) == straight  # one CPU process: the same operations in the same order


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "llava-next-34b", "hubert-xlarge"])
def test_pipeline_equals_reference(name):
    jcfg, cfg = jconfigs.get_reduced(name), configs.get_reduced(name)
    for seed, seq, gb in ((0, 32, 4), (5, 48, 2)):
        want = jpipe.TokenPipeline(jcfg, jpipe.PipelineConfig(seed, seq, gb))
        got = pipeline.TokenPipeline(cfg, pipeline.PipelineConfig(seed, seq, gb))
        for step in (0, 3):
            a, b = want.global_batch(step), got.global_batch(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(b[k], a[k])
            for h in range(2):
                a, b = want.host_batch(step, h, 2), got.host_batch(step, h, 2)
                for k in a:
                    np.testing.assert_array_equal(b[k], a[k])
    for seed, index, seq, vocab in ((0, 0, 65, 256), (7, 123, 4097, 151936), (1, 2**40, 10, 3)):
        a = jsyn.token_example(seed, index, seq, vocab)
        b = synthetic.token_example(seed, index, seq, vocab)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(b, a)


def _run(args, **kw):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                          timeout=240, cwd=kw.get("cwd", ROOT))


def test_launcher_fail_at_then_resume(tmp_path):
    ck = tmp_path / "ckpt"
    common = ["-m", "repro_torch.launch.train", "--arch", NAME, "--reduced", "--device", "cpu",
              "--steps", "4", "--seq-len", "32", "--global-batch", "2", "--ckpt-dir", str(ck),
              "--ckpt-every", "1", "--log-every", "1"]
    out = _run(common + ["--fail-at", "2"])
    assert out.returncode != 0 and "injected failure at step 2" in out.stderr, out.stderr[-2000:]
    assert ckpt_lib.latest_step(str(ck)) == 2
    out = _run(common + ["--resume"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[resume] restored step 2" in out.stdout and out.stdout.rstrip().endswith("done")
    assert "step     4 loss" in out.stdout and "step     2 loss" not in out.stdout
    assert ckpt_lib.latest_step(str(ck)) == 4
    with open(ck / "step_000000004" / "meta.json") as f:
        assert json.load(f) == {"step": 4, "data_cursor": 8, "rng_seed": 0, "n_leaves": 1 + 3 * 14,
                                "n_hosts": 1}


def test_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        train_lib.train(train_lib.parse_args(["--arch", NAME, "--reduced", "--steps", "1"]))


def test_examples_run_on_the_cpu(tmp_path):
    out = _run([str(ROOT / "examples/train_lm_torch.py"), "--device", "cpu", "--steps", "4",
                "--seq-len", "32", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"])
    assert out.returncode == 0 and out.stdout.rstrip().endswith("done"), out.stderr[-2000:]
    assert ckpt_lib.latest_step(str(tmp_path / "ck")) == 4
    out = _run([str(ROOT / "examples/dedup_corpus_torch.py"), "--device", "cpu", "--steps", "8"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dedup: kept" in out.stdout and "held-out loss  deduped corpus" in out.stdout
    losses = [float(line.split(":")[1]) for line in out.stdout.splitlines() if line.startswith("held-out")]
    assert len(losses) == 2 and all(np.isfinite(losses))
