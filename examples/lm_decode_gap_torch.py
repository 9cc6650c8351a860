"""How far a model's full-sequence forward and its decode path disagree,
over depth: the logits each gives at every prompt position, compared on
the reference's bar (rtol = atol = 0.15, tests/test_models.py).

    PYTHONPATH=src python examples/lm_decode_gap_torch.py --arch zamba2-2.7b \\
        --layers 6 12 24 54 --act bfloat16                       # on the card
    PYTHONPATH=src python examples/lm_decode_gap_torch.py --arch deepseek-moe-16b \\
        --layers 2 --act float32 --fp32-caches
    PYTHONPATH=src python examples/lm_decode_gap_torch.py --arch xlstm-1.3b --reduced --device cpu

Weights are ``serve.build_model``'s seeded draw at full width (``--reduced``:
the reduced config) cut to each ``--layers`` depth; prompts are
``serve.lm_prompts``'. MoE configs run at capacity factor n_experts / top_k,
where the forward drops nothing, as decode never does. ``--fp32-caches``
holds the KV caches in fp32 instead of the reference's bf16. Prints, per
depth, the worst |forward - decode| - 0.15 |decode|, the positions over
0.15, max |d| against max |logit|, and the argmax agreement.
``--perturb EPS`` then compares the forward with itself after every matrix
is scaled elementwise by (1 + EPS N(0, 1)): how far the model amplifies a
relative change of EPS with no change of path.
"""
import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.train import train_step as ts

BAR = 0.15


def decode_logits(model, prompts: torch.Tensor, fp32_caches: bool) -> torch.Tensor:
    """Prefill by decode, keeping each position's fp32 logits (B, T, V)."""
    step = ts.make_serve_step(model.cfg)
    B, T = prompts.shape
    state = model.init_state(B, T)
    if fp32_caches:
        state = {k: {n: c.float() for n, c in v.items()} if k in ("kv", "kv0") else v
                 for k, v in state.items()}
    out = []
    for t in range(T):
        _, lg, state = step(model, prompts[:, t : t + 1], state, t)
        out.append(lg[:, 0].float())
    return torch.stack(out, 1)


def report(what: str, got: torch.Tensor, want: torch.Tensor, n_pos: int) -> None:
    d = (got - want).abs()
    over = d - BAR * want.abs()
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"{what}: worst |d| - {BAR}|ref| {float(over.max()):.4f} ({int((over.amax(-1) > BAR).sum())} of "
          f"{n_pos} positions over {BAR}), max |d| {float(d.max()):.5f} of max |logit| "
          f"{float(want.abs().max()):.4f}, argmax agreement {agree:.4f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, nargs="*", default=[], help="depths (default: the config's)")
    ap.add_argument("--act", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--fp32-caches", action="store_true")
    ap.add_argument("--perturb", type=float, default=0.0, help="relative weight perturbation")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args()
    dev = ops.resolve_device(args.device)
    base = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    base = dataclasses.replace(base, act_dtype=args.act)
    if base.family == "moe":
        base = dataclasses.replace(base, capacity_factor=base.n_experts / base.top_k)
    for n_layers in args.layers or [base.n_layers]:
        cfg = dataclasses.replace(base, n_layers=n_layers)
        t0 = time.perf_counter()
        model = serve.build_model(cfg, seed=0, device=dev)
        prompts = serve.lm_prompts(cfg, args.batch, args.prompt_len, dev)
        with torch.inference_mode():
            full = model({"tokens": prompts})[0].float()
            dec = decode_logits(model, prompts, args.fp32_caches)
        caches = "fp32" if args.fp32_caches else "as the reference"
        report(f"{cfg.name} {n_layers} layers, {args.act}, KV caches {caches}, forward vs decode",
               full, dec, prompts.numel())
        if args.perturb:
            gen = torch.Generator(device=dev).manual_seed(1)
            with torch.inference_mode():
                for p in model.parameters():
                    if p.dim() >= 2:
                        p.mul_(1 + args.perturb * torch.randn(p.shape, generator=gen, device=dev))
                moved = model({"tokens": prompts})[0].float()
            report(f"{cfg.name} {n_layers} layers, {args.act}, forward with weights x (1 + {args.perturb:g} "
                   f"N(0,1)) vs forward", moved, full, prompts.numel())
        print(f"({time.perf_counter() - t0:.1f}s)", flush=True)
        del model, full, dec
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
