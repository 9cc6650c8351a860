"""Fixture: a read in a stream scope whose budget is 0, and imports of JAX
and of the JAX package."""
import jax  # expect: layering
import torch
from repro.core import verify as ref_verify  # expect: layering

Tensor = torch.Tensor


class MetricIndex:
    def query_batch(self, q: Tensor, delta: float | None = None):  # expect: host-sync
        total = 0.0
        for row in q:
            total += row.sum().item()
        return total, jax, ref_verify
