"""CUDA wrapper: the fused map phase (space map + kernel cell + packed whole
membership) in one pass over the rows.

``map_assign_cuda`` replaces ``repro/kernels/mapassign.py::
map_assign_blocked``; the kernel is in ``csrc/mapassign.cu`` (design notes
there), including the assign-only mode (``metric=None``: the input rows ARE
the mapped coordinates) and the ``want`` flags that zero-fill a skipped
output.

What bounds it on an H100: bytes. It reads each row once (n·m·4 bytes) and
writes n·(n_dims + 1 + ⌈p/32⌉) words, against n·n_dims·m pair-features of
space map — at m = 128 and n_dims = 8 that is ~16 operations per byte, below
the card's balance. The design reads every row exactly once (one CTA per
64-row block, anchors staged beside it in shared memory), keeps the mapped
coordinates in shared memory for both containment sweeps, and writes the
membership packed 32 partitions per word instead of an (n, p) mask.

Takes CUDA float32 tensors only and raises otherwise; the plain version is
``ref.map_assign``/``ref.assign_membership``. ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

LAUNCHES = {"map_assign": 0}
MAX_DIMS = 64  # mapped dimensions (padded) one CTA holds: csrc kMaxNa


def map_assign_cuda(
    x: Tensor,
    anchors: Tensor | None,
    klo: Tensor,
    khi: Tensor,
    wlo: Tensor,
    whi: Tensor,
    metric: str | None,
    n_dims: int,
    want_cells: bool,
    want_member: bool,
) -> tuple[Tensor, Tensor, Tensor]:
    """Raw call over pre-padded boxes (pp, nap): pp a multiple of 32, nap
    >= n_dims, padded per ``ops._prep_boxes``. ``metric=None`` is the
    assign-only mode (``x`` is (n, n_dims) mapped coordinates). Returns
    (xm (n, n_dims) f32, cells (n,) int32, bits (n, pp/32) int32); xm is
    ``x`` itself in assign-only mode."""
    boxes = (klo, khi, wlo, whi)
    _build.check_inputs("map_assign", x, *boxes, *(() if anchors is None else (anchors,)))
    pp, nap = klo.shape
    if any(b.shape != (pp, nap) for b in boxes) or pp % 32 or nap < n_dims:
        raise ValueError(f"map_assign: bad padded boxes {[tuple(b.shape) for b in boxes]}")
    if nap > MAX_DIMS:
        raise ValueError(f"map_assign: the kernel holds at most {MAX_DIMS} mapped dims, got {nap}")
    n = x.shape[0]
    if metric is None:
        if x.shape[1] != n_dims:
            raise ValueError(f"map_assign: assign-only rows must be (n, {n_dims})")
        m, xm = n_dims, x
        a_ptr, xm_ptr, mid = None, None, -1
    else:
        if anchors is None or anchors.shape != (n_dims, x.shape[1]):
            raise ValueError("map_assign: anchors must be (n_dims, m)")
        m = x.shape[1]
        xm = torch.empty((n, n_dims), dtype=torch.float32, device=x.device)
        a_ptr, xm_ptr, mid = anchors.data_ptr(), xm.data_ptr(), _build.METRIC_IDS[metric]
    cells = torch.empty((n,), dtype=torch.int32, device=x.device)
    bits = torch.empty((n, pp // 32), dtype=torch.int32, device=x.device)
    if n:
        lib = _build.lib("mapassign")
        rc = lib.map_assign_launch(
            x.data_ptr(), a_ptr, klo.data_ptr(), khi.data_ptr(), wlo.data_ptr(),
            whi.data_ptr(), xm_ptr, cells.data_ptr(), bits.data_ptr(),
            n, m, n_dims, nap, pp, mid, int(want_cells), int(want_member),
            _build.stream_ptr(x.device),
        )
        LAUNCHES["map_assign"] += 1
        _build.check("mapassign", rc, "map_assign launch")
    return xm, cells, bits
