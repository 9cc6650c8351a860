"""Fixture: float64 inside a step scope."""
import torch

Tensor = torch.Tensor


def decode_attention(params: dict, x: Tensor, cache: dict, length: int, cfg):
    scale = torch.ones((), dtype=torch.float64)  # expect: f64-cast
    y = x.double()  # expect: f64-cast
    return y * scale, cache
