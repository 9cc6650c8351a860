"""Fault-tolerant training launcher (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 200 --reduced --ckpt-dir runs/ckpt [--resume] \\
        [--fail-at 50]   # fault injection: simulate a crash, then restart

Runs on the card unless ``--device cpu`` is passed; it never falls back to
the CPU. The reference's arguments and log line, on one device: the
reference's mesh (``mesh.make_host_mesh``, ``device_batch``) belongs to the
mesh tooling and is not ported.

  checkpoint/restart   atomic checkpoints in the reference's format every
                       --ckpt-every steps; --resume restores params, opt
                       state and step, and the loss curve continues where
                       it left off (batches are addressed by global step).
  failure injection    --fail-at N raises after step N, so the restart path
                       stays tested.

Weights are random, drawn leaf by leaf in fp32 from a seeded
``torch.Generator`` on the device (the reference's ``PRNGKey(0)`` stream
cannot be reproduced; ``convert.lm_params(..., trainable=True)`` carries
the reference's weights over where a test needs them). Seconds per step
are measured to a ``torch.cuda.synchronize()`` on the card.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.models import base, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts


def build_model(cfg: ArchConfig, *, seed: int = 0,
                device: torch.device | str = "cuda") -> transformer.Transformer:
    """``cfg``'s model for training: fp32 leaves drawn from a seeded
    generator on ``device``, held trainable (stacks whole)."""
    dev = ops.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = base.init_params(gen, transformer.model_defs(cfg), torch.float32)
    return transformer.Transformer(cfg, params, trainable=True)


def to_device(batch: dict, device: torch.device | str) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(args: argparse.Namespace) -> None:
    """The training loop."""
    from repro_torch import configs

    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    dev = ops.resolve_device(args.device)
    pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=args.seq_len,
                                             global_batch=args.global_batch))
    ocfg = opt_lib.OptConfig(
        lr=args.lr, total_steps=args.steps, warmup_steps=max(args.steps // 20, 1),
        compress_grads=args.compress_grads,
    )
    step_fn = ts.make_train_step(cfg, ocfg, ts.StepConfig(n_micro=args.n_micro))
    model = build_model(cfg, seed=0, device=dev)
    opt_state = opt_lib.init_opt_state(model.param_tree(), ocfg)

    start_step = 0
    if args.resume and args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        state = ckpt_lib.restore(
            args.ckpt_dir, ckpt_lib.TrainState(model.param_tree(), opt_state, 0, 0, 0))
        model.load_param_tree(state.params)
        opt_state, start_step = state.opt_state, state.step
        print(f"[resume] restored step {start_step} from {args.ckpt_dir}", flush=True)

    _sync(dev)
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        batch = to_device(pipe.global_batch(step), dev)
        model, opt_state, metrics = step_fn(model, opt_state, batch)

        if (step + 1) % args.log_every == 0 or step == start_step:
            _sync(dev)
            print(
                f"step {step + 1:5d} loss {float(metrics['total']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({(time.perf_counter() - t0) / max(step + 1 - start_step, 1):.2f}s/step)",
                flush=True,
            )
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = ckpt_lib.save(
                args.ckpt_dir,
                ckpt_lib.TrainState(model.param_tree(), opt_state, step + 1,
                                    (step + 1) * args.global_batch, 0),
            )
            print(f"[ckpt] {path}", flush=True)
        if args.fail_at is not None and step + 1 >= args.fail_at:
            raise RuntimeError(f"injected failure at step {step + 1} (restart with --resume)")
    print("done", flush=True)


def parse_args(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    return ap.parse_args(argv)


def main() -> None:
    train(parse_args(sys.argv[1:]))


if __name__ == "__main__":
    main()
