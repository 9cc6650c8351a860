"""How far a model's training gradient moves when its weights move by a
rounding: the yardstick for comparing two computations of one gradient
that round apart (the "tp" split against the whole step,
``tests/test_torch_mesh.py``'s ``MIXER_GRAD_REL``).

    PYTHONPATH=src python examples/lm_grad_noise_torch.py                  # the CPU
    PYTHONPATH=src python examples/lm_grad_noise_torch.py --arch xlstm-1.3b --eps 1e-7 1e-6

For each ``--arch`` (reduced config, act fp32, ``build_model``'s draw with
``--seed``): one gradient of the single-process loss on the pipeline's
first batch (``--batch`` x ``--seq`` tokens, aux weight 0.01, as the mesh
tests take it), then ``--trials`` gradients after every weight is scaled
elementwise by (1 + EPS N(0, 1)). Prints the largest |perturbed - base|
over the largest |base|, over every leaf and trial.
"""
import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import train as train_lib
from repro_torch.models import base
from repro_torch.train import train_step as ts


def grad_noise(arch: str, eps: float, seed: int, batch: int, seq: int, trials: int) -> float:
    cfg = dataclasses.replace(configs.get_reduced(arch), act_dtype="float32")
    pipe = TokenPipeline(cfg, PipelineConfig(seed=0, seq_len=seq, global_batch=batch))
    model = train_lib.build_model(cfg, seed=seed, device="cpu")
    grad_fn = ts.make_grad_fn(cfg, ts.StepConfig(aux_weight=0.01))
    rows = {k: torch.as_tensor(v) for k, v in pipe.global_batch(0).items()}
    whole = model.param_tree()
    want = [g.clone() for g in grad_fn(model, rows)[2]]
    scale = max(float(g.abs().max()) for g in want)
    gen = torch.Generator().manual_seed(7)
    worst = 0.0
    for _ in range(trials):
        model.load_param_tree(base.tree_map(lambda t: t * (1 + eps * torch.randn(t.shape, generator=gen)),
                                            whole))
        got = grad_fn(model, rows)[2]
        worst = max(worst, max(float((a - b).abs().max()) for a, b in zip(got, want)) / scale)
    return worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["qwen1.5-0.5b", "zamba2-2.7b", "xlstm-1.3b"])
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-7])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args()
    for arch in args.arch:
        for eps in args.eps:
            rel = grad_noise(arch, eps, args.seed, args.batch, args.seq, args.trials)
            print(f"{arch} (reduced, act fp32, {args.batch} x {args.seq} tokens): weights x (1 + {eps} N(0, 1)) "
                  f"moves the gradient by {rel:.3e} of its largest element (worst of {args.trials})")


if __name__ == "__main__":
    main()
