"""Fixture: a step scope in fp32, and float64 in a host helper outside the
step tier."""
import numpy as np
import torch

Tensor = torch.Tensor


def decode_attention(params: dict, x: Tensor, cache: dict, length: int, cfg):
    scale = torch.ones((), dtype=torch.float32, device=x.device)
    cache["k"][:, length] = x[:, 0]
    return x * scale, cache


def table(n: int) -> np.ndarray:
    return np.linspace(0.0, 1.0, n, dtype=np.float64)
