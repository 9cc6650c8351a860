"""Fixture: a step scope that stays on the card."""
import math

import torch

Tensor = torch.Tensor


def _capacity(gs: int, k: int) -> int:
    return max(math.ceil(gs * k / 8) * 8, 8)


def moe_block(params: dict, x: Tensor, cfg, group_size: int = 2048, state: Tensor | None = None):
    B, S, d = x.shape
    gs = min(group_size, S)
    if state is None:
        state = torch.zeros((B, d), dtype=torch.float32, device=x.device)
    n = int(x.shape[1]) * x.numel()
    y = torch.where(x > 0, x, torch.zeros_like(x))  # a select, not a nonzero
    y = y.masked_fill(y > 1, 1.0)
    w = params["w"].to(x.dtype)
    cap = torch.full((B,), _capacity(gs, n), dtype=torch.int64, device=x.device)
    return y @ w, state + cap[:, None]
