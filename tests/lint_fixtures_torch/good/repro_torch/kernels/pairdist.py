"""Fixture: a kernel module in fp32."""
import numpy as np
import torch


def plan(n: int):
    w = np.zeros(n, dtype=np.float32)
    t = torch.zeros(n, dtype=torch.float32)
    return w, t.float()
