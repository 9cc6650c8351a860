"""Fixture: the decode position stays a Python int."""
import torch

Tensor = torch.Tensor


def generate(model, tok: Tensor, state, n: int, prompt_len: int):
    for i in range(n):
        logits, state = model.decode_step(tok, state, prompt_len + i)
        tok = logits.argmax(-1)
    return tok
