"""Architecture registry + input specs for every (arch x shape) cell.

The port of ``repro.configs``: ``get(name)`` / ``get_reduced(name)`` return
the same ArchConfig; ``input_specs`` builds the inputs each entry point
takes — as ``meta``-device tensors (shapes and dtypes, zero allocation) or
concrete tensors, whose token ids are the reference's (the same
``np.random.default_rng(0)`` draw).
"""
from __future__ import annotations

import importlib
from typing import Any

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig, shape_applicable

ARCH_MODULES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "hubert-xlarge": "hubert_xlarge",
    "stablelm-3b": "stablelm_3b",
    "granite-34b": "granite_34b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "xlstm-1.3b": "xlstm_1p3b",
    "llava-next-34b": "llava_next_34b",
}
ARCH_NAMES = tuple(ARCH_MODULES)


def _module(name: str):
    try:
        return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; have {sorted(ARCH_MODULES)}") from None


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()


def _token_specs(cfg: ArchConfig, shape: ShapeConfig, device: torch.device, kind: str):
    B, S = shape.global_batch, shape.seq_len

    def arr(shp, dtype, high=None):
        if device.type == "meta":
            return torch.empty(shp, dtype=dtype, device=device)
        if dtype == torch.int32:
            ids = np.random.default_rng(0).integers(0, high or cfg.vocab, shp)
            return torch.as_tensor(ids, dtype=torch.int32, device=device)
        return torch.zeros(shp, dtype=dtype, device=device)

    if cfg.family == "audio":
        batch = {"frames": arr((B, S, cfg.frontend_dim), torch.bfloat16)}
        labels = arr((B, S), torch.int32)
    elif cfg.family == "vlm":
        s_text = S - cfg.n_patches
        assert s_text > 0, (S, cfg.n_patches)
        batch = {
            "patches": arr((B, cfg.n_patches, cfg.frontend_dim), torch.bfloat16),
            "tokens": arr((B, s_text), torch.int32),
        }
        labels = arr((B, S), torch.int32)  # full-sequence labels, patch part masked
    else:
        batch = {"tokens": arr((B, S), torch.int32)}
        labels = arr((B, S), torch.int32)
    if kind == "train":
        batch["labels"] = labels
    return batch


def input_specs(
    cfg: ArchConfig, shape: ShapeConfig, *, abstract: bool = True,
    device: torch.device | str = "cuda",
) -> dict[str, Any]:
    """Inputs for the entry point the shape exercises (``abstract``: on
    the ``meta`` device, else on ``device``).

    train/prefill -> {"batch": {...}}           (forward / eval step)
    decode        -> {"token","state","length"} (serve_step: one new token
                     against a KV state already holding seq_len tokens)
    """
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape.name} skipped: {why}")
    dev = torch.device("meta") if abstract else torch.device(device)
    if not shape.is_decode:
        return {"batch": _token_specs(cfg, shape, dev, shape.kind)}

    B, S = shape.global_batch, shape.seq_len
    state = transformer.init_state(cfg, B, S, device=dev)
    token = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    length = (torch.empty((), dtype=torch.int32, device=dev) if abstract
              else torch.tensor(S - 1, dtype=torch.int32, device=dev))
    return {"token": token, "state": state, "length": length}


def all_cells() -> list[tuple[str, str, bool, str]]:
    """Every (arch, shape) pair with (runnable, skip_reason)."""
    out = []
    for a in ARCH_NAMES:
        cfg = get(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            out.append((a, s.name, ok, why))
    return out
