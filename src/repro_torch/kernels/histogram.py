"""CUDA wrapper: the weighted per-dimension histogram (the GoF cell counts).

``histogram_cuda`` replaces ``repro/kernels/histogram.py::
histogram_blocked``; the kernel is in ``csrc/histogram.cu`` (design notes
there). It computes what ``ref.histogram`` computes: for u (n, m) and a
weight per row, the (m, t) sums of the weights of the rows whose
``clip(trunc(u·t), 0, t − 1)`` is each cell.

What bounds it on an H100: bytes. It reads u once (n·m·4 bytes) and the
weights once (n·4) and writes m·t floats; the binning is a few operations
per element. Each CTA keeps a private 32-dimension histogram in shared
memory and adds it into the output with one global atomic per cell.

The wrapper zeroes the (m, t) output with ``torch.zeros`` and raises on CPU
tensors, on a non-float32 or non-contiguous input, on t outside
[1, ``MAX_T``] and on a failed launch. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

LAUNCHES = {"histogram": 0}
MAX_T = 383  # cells one CTA's shared histogram holds: 32 * (t | 1) <= 12288 floats


def histogram_cuda(u: Tensor, weights: Tensor, t: int) -> Tensor:
    """``u`` (n, m) float32, ``weights`` (n,) float32, both contiguous CUDA
    tensors. Returns the (m, t) float32 counts."""
    _build.check_inputs("histogram", u)
    if not weights.is_cuda or weights.dtype != torch.float32 or weights.dim() != 1 or (
        not weights.is_contiguous()
    ):
        raise ValueError(
            f"histogram: weights must be a contiguous 1-D float32 CUDA tensor, got "
            f"{weights.dtype} {tuple(weights.shape)} on {weights.device}"
        )
    n, m = u.shape
    if weights.shape[0] != n:
        raise ValueError(f"histogram: {weights.shape[0]} weights for {n} rows")
    if not 1 <= t <= MAX_T:
        raise ValueError(f"histogram: t must be in [1, {MAX_T}], got {t}")
    out = torch.zeros((m, t), dtype=torch.float32, device=u.device)
    if n and m:
        n_sms = torch.cuda.get_device_properties(u.device).multi_processor_count
        rc = _build.lib("histogram").histogram_launch(
            u.data_ptr(), weights.data_ptr(), out.data_ptr(), n, m, int(t), n_sms,
            _build.stream_ptr(u.device),
        )
        LAUNCHES["histogram"] += 1
        _build.check("histogram", rc, "histogram launch")
    return out
