"""Serving entry points: the metric-index range-query server + an LM demo.

The port of ``repro.launch.serve``; both subcommands run on the card unless
``--device cpu`` is passed.

``range`` — the query-serving path of this repo (docs/SERVING.md): build a
persistent ``core.index.MetricIndex`` once, pin its per-slot V buffers over
the "data" axis of ``launch.mesh.make_host_mesh`` (its process group; the
world the caller initialised, else one of world size 1: NCCL on the card,
gloo on the CPU, file rendezvous in a temporary directory), then serve
δ-range query batches through the distributed serve stage. Prints build time, per-batch
latency, QPS/p50/p99, and checks one batch against the brute-force oracle.

    PYTHONPATH=src python -m repro_torch.launch.serve range \\
        --n 20000 --m 16 --queries 4096 --batch 256

``lm`` — the batched LM prefill+decode demo (prefill-by-decode keeps the KV
state layout identical between phases):

    PYTHONPATH=src python -m repro_torch.launch.serve lm --arch qwen1.5-0.5b \\
        --reduced --batch 4 --prompt-len 32 --gen 32

Weights are random, drawn from a seeded ``torch.Generator`` on the device;
prompts are the reference's (``np.random.default_rng(0)``). As in the
reference, decoding starts from the last prompt token at position
``prompt_len``, so that token is fed twice (once by the prefill at
``prompt_len - 1``). Bare ``--arch ...`` argv (no subcommand) is routed to
``lm``.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import base, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.train import train_step as ts


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# range: metric-index query serving (build once, query millions)
# ---------------------------------------------------------------------------


def serve_range(args) -> None:
    import torch.distributed as dist

    from repro_torch.core import index as index_lib
    from repro_torch.core import spjoin
    from repro_torch.data import synthetic
    from repro_torch.launch import mesh as mesh_lib

    dev = ops.resolve_device(args.device)
    # queries drawn near the indexed clusters (rs_mixture shares centers) so
    # the default δ actually produces hits
    data, queries = synthetic.rs_mixture(args.n, args.queries, args.m,
                                         n_clusters=6, spread=6.0, skew=0.3,
                                         shift=1.5, seed=0)
    cfg = spjoin.JoinConfig(delta=args.delta, metric=args.metric,
                            k=min(1024, args.n // 4), p=16, n_dims=8, seed=0)

    t0 = time.perf_counter()
    idx = index_lib.build_index(data, cfg, device=dev)
    _sync(dev)
    print(f"build: N={idx.n_rows} m={idx.n_features} p={idx.p} "
          f"in {time.perf_counter() - t0:.2f}s")

    with tempfile.TemporaryDirectory() as tmp:
        own = not dist.is_initialized()
        if own:
            kw = {}
            if dev.type == "cuda":
                kw["device_id"] = torch.device("cuda", dev.index if dev.index is not None
                                               else torch.cuda.current_device())
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                    init_method=f"file://{tmp}/rdzv", world_size=1, rank=0, **kw)
        try:
            mesh = mesh_lib.make_host_mesh(axis="data", device=dev.type)
            didx = idx.to_distributed(mesh.get_group("data"))
            print(f"pinned V buffers on {mesh.size()} rank(s); serving")
            batches = [queries[i : i + args.batch]
                       for i in range(0, args.queries, args.batch)]
            didx.query_batch(batches[0])  # warm-up

            lat, n_pairs = [], 0
            for i, b in enumerate(batches):
                t0 = time.perf_counter()
                pairs = didx.query_batch(b)  # host pairs: the device is done
                lat.append(time.perf_counter() - t0)
                n_pairs += int(pairs.shape[0])
                if i < 3 or (i + 1) == len(batches):
                    print(f"  batch {i + 1}/{len(batches)}: {b.shape[0]} queries, "
                          f"{pairs.shape[0]} pairs, {lat[-1] * 1e3:.1f} ms")
            got = didx.query_batch(batches[0])
        finally:
            if own:
                dist.destroy_process_group()

    lat_ms = np.asarray(lat) * 1e3
    n_q = sum(b.shape[0] for b in batches)
    print(f"served {n_q} queries, {n_pairs} pairs: "
          f"{n_q / lat_ms.sum() * 1e3:.0f} QPS, "
          f"p50 {np.percentile(lat_ms, 50):.1f} ms, "
          f"p99 {np.percentile(lat_ms, 99):.1f} ms")

    truth = index_lib.brute_force_query(data, batches[0], args.delta,
                                        args.metric, device=dev)
    if not np.array_equal(got, truth):
        raise AssertionError("parity check vs brute force FAILED")
    print("parity vs brute force: ok")


# ---------------------------------------------------------------------------
# lm: batched prefill + streaming decode demo
# ---------------------------------------------------------------------------


def build_model(cfg: ArchConfig, *, seed: int = 0,
                device: torch.device | str = "cuda") -> transformer.Transformer:
    """``cfg``'s model with random weights from a seeded generator on
    ``device``, placed for serving. Each leaf is drawn in fp32 and cast to
    its serving dtype at once, so the build never holds the whole fp32
    tree (deepseek-moe-16b: 65.5 GB in fp32, 32.8 GB held in bf16)."""
    dev = ops.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = base.init_params(gen, transformer.model_defs(cfg), transformer.serving_dtype(cfg))
    return transformer.Transformer(cfg, params)


def lm_prompts(cfg: ArchConfig, batch: int, prompt_len: int,
               device: torch.device | str = "cuda") -> torch.Tensor:
    """The reference's prompts: (batch, prompt_len) int32 ids from
    ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab, (batch, prompt_len))
    return torch.as_tensor(ids, dtype=torch.int32, device=ops.resolve_device(device))


def prefill_by_decode(model, tokens, cfg, state, serve_step, generator=None):
    """Feed prompt tokens one step at a time (exact state, any family)."""
    B, T = tokens.shape
    for t in range(T):
        _, _, state = serve_step(model, tokens[:, t : t + 1], state, t, generator)
    return state


def generate(model, prompts: torch.Tensor, n_gen: int, serve_step,
             generator: torch.Generator | None = None) -> tuple[torch.Tensor, float, float]:
    """Prefill ``prompts`` by decode, then decode ``n_gen`` tokens from the
    last prompt token at position ``prompt_len`` (the reference's start).
    Returns (ids (B, n_gen) int32 on the device, prefill s, decode s)."""
    cfg = model.cfg
    B, T = prompts.shape
    dev = prompts.device
    state = model.init_state(B, T + n_gen)
    _sync(dev)
    t0 = time.perf_counter()
    state = prefill_by_decode(model, prompts, cfg, state, serve_step, generator)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = prompts[:, -1:]
    out = []
    t0 = time.perf_counter()
    for i in range(n_gen):
        tok, _, state = serve_step(model, tok, state, T + i, generator)
        out.append(tok[:, 0])
    ids = torch.stack(out, dim=1)
    _sync(dev)
    return ids, t_prefill, time.perf_counter() - t0


def serve_lm(args) -> None:
    from repro_torch import configs

    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get(args.arch)
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode path")
    dev = ops.resolve_device(args.device)
    model = build_model(cfg, seed=0, device=dev)
    mode = "greedy" if args.temperature == 0.0 else "sample"
    serve_step = ts.make_serve_step(cfg, mode, max(args.temperature, 1e-3))
    generator = None if mode == "greedy" else torch.Generator(device=dev).manual_seed(0)
    prompts = lm_prompts(cfg, args.batch, args.prompt_len, dev)

    with torch.inference_mode():
        ids, t_prefill, t_decode = generate(model, prompts, args.gen, serve_step, generator)
    gen = ids.cpu().numpy()
    print(f"prefill {args.batch}x{args.prompt_len} in {t_prefill:.2f}s; "
          f"decode {args.gen} steps in {t_decode:.2f}s "
          f"({args.batch * args.gen / max(t_decode, 1e-9):.1f} tok/s) on {dev}")
    print("sample output ids:", gen[0][:16])
    if gen.shape != (args.batch, args.gen) or not ((gen >= 0) & (gen < cfg.vocab)).all():
        raise AssertionError(f"generated ids out of shape or range: {gen.shape}")
    print("ok")


def parse_args(argv: list[str]) -> argparse.Namespace:
    if argv and argv[0].startswith("-"):
        argv = ["lm"] + argv  # pre-subcommand compat: bare --arch means lm

    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("range", help="metric-index δ-range query serving")
    rp.add_argument("--n", type=int, default=20_000, help="indexed rows")
    rp.add_argument("--m", type=int, default=16, help="features")
    rp.add_argument("--queries", type=int, default=4096)
    rp.add_argument("--batch", type=int, default=256)
    rp.add_argument("--delta", type=float, default=3.0)
    rp.add_argument("--metric", default="l2")
    rp.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    rp.set_defaults(fn=serve_range)

    lp = sub.add_parser("lm", help="batched LM prefill + decode demo")
    lp.add_argument("--arch", required=True)
    lp.add_argument("--reduced", action="store_true")
    lp.add_argument("--batch", type=int, default=4)
    lp.add_argument("--prompt-len", type=int, default=32)
    lp.add_argument("--gen", type=int, default=32)
    lp.add_argument("--temperature", type=float, default=0.0)
    lp.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    lp.set_defaults(fn=serve_lm)
    return ap.parse_args(argv)


def main() -> None:
    args = parse_args(sys.argv[1:])
    args.fn(args)


if __name__ == "__main__":
    main()
