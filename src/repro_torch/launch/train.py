"""Fault-tolerant training launcher (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 200 --reduced --ckpt-dir runs/ckpt [--resume] \\
        [--fail-at 50]   # fault injection: simulate a crash, then restart

Runs on the card unless ``--device cpu`` is passed; it never falls back to
the CPU. The reference's arguments and log line. In an initialised world
of more than one rank (``torchrun --nproc-per-node N -m
repro_torch.launch.train ...``: ``main`` then initialises it from
torchrun's environment, NCCL with one card per rank, gloo with ``--device
cpu``), it takes the reference's mesh branch: a 1-D "data" mesh over the
world (``mesh.make_host_mesh``), the model held as shards
(``transformer.ShardedTransformer``, the tensor-parallel rules: "embed"
dims split over "data"), each step run under ``base.use_mesh`` on the
rank's rows of ``TokenPipeline.device_batch(step, mesh, ("data",))``, and
rank 0 logging. Otherwise it runs on one device as before.

  checkpoint/restart   atomic checkpoints in the reference's format every
                       --ckpt-every steps; --resume restores params, opt
                       state and step, and the loss curve continues where
                       it left off (batches are addressed by global step).
                       Over a mesh the leaves are gathered whole and rank 0
                       writes them; every rank restores the whole tree and
                       keeps its shards.
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
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import base, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts


def build_model(cfg: ArchConfig, *, seed: int = 0,
                device: torch.device | str = "cuda", mesh=None) -> transformer.Transformer:
    """``cfg``'s model for training: fp32 leaves drawn from a seeded
    generator on ``device``, held trainable (stacks whole); with ``mesh``
    each rank draws the same leaves and keeps its shards
    (``ShardedTransformer``)."""
    dev = ops.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = base.init_params(gen, transformer.model_defs(cfg), torch.float32)
    if mesh is not None:
        return transformer.ShardedTransformer(cfg, params, mesh)
    return transformer.Transformer(cfg, params, trainable=True)


def _world_mesh(dev: torch.device):
    """The reference's mesh branch: a 1-D "data" mesh over an initialised
    world of more than one rank, else None."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return mesh_lib.make_host_mesh(device=dev.type)
    return None


def _save(args, model, opt_state, step: int, mesh) -> None:
    params = model.param_tree()
    if mesh is not None:  # whole leaves, written by rank 0
        params = model.full_param_tree()
        opt_state = opt_lib.AdamState(
            opt_state.step, model.gather_tree(opt_state.mu), model.gather_tree(opt_state.nu),
            None if opt_state.ef_residual is None else model.gather_tree(opt_state.ef_residual))
        if dist.get_rank() != 0:
            # spjoin-lint-torch: allow[collective-site] -- checkpoint fence: wait for rank 0's write, once a save
            dist.barrier()
            return
    path = ckpt_lib.save(args.ckpt_dir, ckpt_lib.TrainState(params, opt_state, step, step * args.global_batch, 0))
    print(f"[ckpt] {path}", flush=True)
    if mesh is not None:
        # spjoin-lint-torch: allow[collective-site] -- checkpoint fence: rank 0 has written, once a save
        dist.barrier()


def _restore(args, model, opt_state, mesh):
    if mesh is None:
        state = ckpt_lib.restore(args.ckpt_dir, ckpt_lib.TrainState(model.param_tree(), opt_state, 0, 0, 0))
        model.load_param_tree(state.params)
        return state.opt_state, state.step
    whole = model.full_param_tree()
    like = opt_lib.init_opt_state(whole, opt_lib.OptConfig(compress_grads=opt_state.ef_residual is not None))
    state = ckpt_lib.restore(args.ckpt_dir, ckpt_lib.TrainState(whole, like, 0, 0, 0))
    model.load_param_tree(state.params)
    o = state.opt_state
    return opt_lib.AdamState(o.step, model.shard_tree(o.mu), model.shard_tree(o.nu),
                             None if o.ef_residual is None else model.shard_tree(o.ef_residual)), state.step


def to_device(batch: dict, device: torch.device | str) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(args: argparse.Namespace) -> list[float]:
    """The training loop; returns each step's loss (``total``). Every rank
    of an initialised world calls it with the same arguments."""
    from repro_torch import configs

    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    dev = ops.resolve_device(args.device)
    mesh = _world_mesh(dev)
    lead = mesh is None or dist.get_rank() == 0
    pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=args.seq_len,
                                             global_batch=args.global_batch))
    ocfg = opt_lib.OptConfig(
        lr=args.lr, total_steps=args.steps, warmup_steps=max(args.steps // 20, 1),
        compress_grads=args.compress_grads,
    )
    make_step = ts.make_train_step if mesh is None else ts.make_mesh_train_step
    step_fn = make_step(cfg, ocfg, ts.StepConfig(n_micro=args.n_micro))
    model = build_model(cfg, seed=0, device=dev, mesh=mesh)
    opt_state = opt_lib.init_opt_state(model.param_tree(), ocfg)

    start_step = 0
    if args.resume and args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        opt_state, start_step = _restore(args, model, opt_state, mesh)
        if lead:
            print(f"[resume] restored step {start_step} from {args.ckpt_dir}", flush=True)

    _sync(dev)
    t0 = time.perf_counter()
    totals = []
    for step in range(start_step, args.steps):
        if mesh is None:
            batch = to_device(pipe.global_batch(step), dev)
        else:
            batch = pipe.device_batch(step, mesh, batch_axes=("data",))
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        totals.append(metrics["total"])

        if lead and ((step + 1) % args.log_every == 0 or step == start_step):
            _sync(dev)
            print(
                f"step {step + 1:5d} loss {float(metrics['total']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"({(time.perf_counter() - t0) / max(step + 1 - start_step, 1):.2f}s/step)",
                flush=True,
            )
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(args, model, opt_state, step + 1, mesh)
        if args.fail_at is not None and step + 1 >= args.fail_at:
            raise RuntimeError(f"injected failure at step {step + 1} (restart with --resume)")
    if lead:
        print("done", flush=True)
    return [float(t) for t in totals]


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
    args = parse_args(sys.argv[1:])
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # torchrun: one rank a process
        cuda = torch.device(args.device).type == "cuda"
        if cuda:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl" if cuda else "gloo")
        try:
            train(args)
        finally:
            dist.destroy_process_group()
        return
    train(args)


if __name__ == "__main__":
    main()
