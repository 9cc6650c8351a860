"""Fixture: a tensor decode position."""
import torch

Tensor = torch.Tensor


def generate(model, tok: Tensor, state, n: int):
    length = torch.zeros((), dtype=torch.int64, device=tok.device)
    for i in range(n):
        logits, state = model.decode_step(tok, state, length + i)  # expect: host-sync
        tok = logits.argmax(-1)
    return tok
