"""Fixture: float64 anywhere in a kernel module."""
import numpy as np
import torch


def plan(n: int):
    w = np.zeros(n, dtype=np.float64)  # expect: f64-cast
    t = torch.zeros(n, dtype=float)  # expect: f64-cast
    return w, t.double()  # expect: f64-cast
