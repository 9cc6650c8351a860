"""End-to-end data pipeline on the port: SP-Join-powered corpus dedup
feeding LM training — the paper's technique in its production seat.

    PYTHONPATH=src python examples/dedup_corpus_torch.py            # on the card
    PYTHONPATH=src python examples/dedup_corpus_torch.py --device cpu

Pipeline:
  1. a noisy near-duplicate string corpus (synthetic AOL-style),
  2. q-gram profile vectorization (paper §6.2),
  3. SP-Join semantic dedup (generative sampling + learning partition)
     through ``data.dedup`` (on the card: the map-assign and filtered
     pairdist kernels),
  4. train a reduced qwen-family LM on the deduped corpus and on the
     duplicated one at an equal step budget, and compare their held-out
     losses (duplicates waste steps).

``vectorize.qgram_profile`` hashes with Python's per-process salted
``hash()``, so its profiles (and the dedup's counts) compare only within
one process.
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import spjoin
from repro_torch.data import dedup, synthetic, vectorize
from repro_torch.launch import train as train_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts


def tokenize(ss: list[str], chars: list[str], vocab: int, seq_len: int = 64) -> np.ndarray:
    text = "#".join(ss)
    ids = np.array([chars.index(c) % vocab for c in text], np.int32)
    n = len(ids) // (seq_len + 1)
    return ids[: n * (seq_len + 1)].reshape(n, seq_len + 1)


def train_eval(cfg, corpus, held, chars, device, steps: int = 30, bs: int = 8, seed: int = 0) -> float:
    """Train on ``corpus`` for ``steps`` steps; the held-out loss."""
    toks = tokenize(corpus, chars, cfg.vocab)
    rng = np.random.default_rng(seed)
    model = train_lib.build_model(cfg, seed=seed, device=device)
    ocfg = opt_lib.OptConfig(lr=1e-3, total_steps=steps, warmup_steps=2)
    state = opt_lib.init_opt_state(model.param_tree(), ocfg)
    step = ts.make_train_step(cfg, ocfg, ts.StepConfig())
    hb = train_lib.to_device({"tokens": held[:32, :-1], "labels": held[:32, 1:]}, device)
    for _ in range(steps):
        idx = rng.integers(0, len(toks), bs)
        batch = train_lib.to_device({"tokens": toks[idx, :-1], "labels": toks[idx, 1:]}, device)
        model, state, _ = step(model, state, batch)
    with torch.no_grad():
        return float(ts.make_eval_step(cfg)(model, hb)["loss"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    ap.add_argument("--steps", type=int, default=30, help="training steps per corpus")
    args = ap.parse_args()

    # ---- 1-2: corpus + vectors ---------------------------------------------
    strs = synthetic.strings(1200, mutate=0.03, n_templates=64, seed=0)
    prof = vectorize.qgram_profile(strs, q=2, dim=64)
    print(f"corpus: {len(strs)} strings, {len(set(strs))} distinct")

    # ---- 3: SP-Join dedup ---------------------------------------------------
    res = dedup.dedup(prof, delta=2.0, metric="l1",
                      cfg=spjoin.JoinConfig(delta=2.0, metric="l1", k=256, p=8, n_dims=6),
                      device=args.device)
    kept = [s for s, k in zip(strs, res.keep_mask) if k]
    print(f"dedup: kept {res.n_components}, removed {res.n_duplicates} near-dups")

    # ---- 4: token stream + reduced-LM training ------------------------------
    cfg = configs.get_reduced("qwen1.5-0.5b")
    chars = sorted(set("".join(strs)) | {"#"})
    held = tokenize(synthetic.strings(200, mutate=0.03, n_templates=64, seed=99), chars, cfg.vocab)
    loss_dup = train_eval(cfg, strs, held, chars, args.device, args.steps)
    loss_dedup = train_eval(cfg, kept, held, chars, args.device, args.steps)
    print(f"held-out loss  duplicated corpus: {loss_dup:.4f}")
    print(f"held-out loss  deduped corpus:    {loss_dedup:.4f}")
    print("dedup helps" if loss_dedup <= loss_dup + 0.05 else "(noise-dominated at this scale)")


if __name__ == "__main__":
    main()
