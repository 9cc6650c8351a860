"""CUDA wrappers: blocked all-pairs distance, plain and pivot-filtered.

``pairdist_cuda`` replaces ``repro/kernels/pairdist.py::pairdist_blocked``
and ``pairdist_filtered_cuda`` replaces ``::pairdist_filtered_blocked``; the
kernels are in ``csrc/pairdist.cu`` (design notes there).

What bounds them on an H100: operations. At the verify engine's tile shapes
(up to 1024 x 4096 pairs over m = 128 features) a tile is ~0.5 G
pair-features against ~20 MB of rows and mask, far above the card's
bytes-per-operation balance; l1/linf spend two fp32 instructions per
pair-feature on the CUDA cores, l2/cosine/dot one FMA (TF32 tensor cores
are ruled out by the fp32 guard band of ``ref.prune_delta``). The design
keeps the accumulator in registers (4x4 per thread), stages 16-feature
chunks in shared memory for 64 operations per word loaded, and the
filtered kernel skips the whole feature loop of a 64x64 tile when the
pivot bound prunes every pair in it.

Each wrapper takes CUDA float32 tensors only and raises otherwise; the
plain versions are ``ref.pairdist``/``ref.pairdist_mask``/
``ref.pairdist_mask_filtered``. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

LAUNCHES = {"pairdist": 0, "pairdist_filtered": 0}
MAX_ROWS = 65535 * 64  # x rows: one grid row of 64-row tiles each, gridDim.y <= 65535


def _check_rows(name: str, a: int) -> None:
    if a > MAX_ROWS:
        raise ValueError(f"{name}: at most {MAX_ROWS} x rows per launch, got {a}")


def pairdist_cuda(
    x: Tensor, y: Tensor, metric: str, delta: float | None = None
) -> Tensor:
    """(a, b) float32 distances, or the int8 ``D <= delta`` mask when
    ``delta`` is given. Cosine rows must be pre-normalised by the caller."""
    _build.check_inputs("pairdist", x, y)
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"pairdist: feature widths differ {x.shape} vs {y.shape}")
    a, b, m = x.shape[0], y.shape[0], x.shape[1]
    _check_rows("pairdist", a)
    if delta is None:
        out = torch.empty((a, b), dtype=torch.float32, device=x.device)
        out_f, out_m = out.data_ptr(), None
    else:
        out = torch.empty((a, b), dtype=torch.int8, device=x.device)
        out_f, out_m = None, out.data_ptr()
    if a and b:
        lib = _build.lib("pairdist")
        rc = lib.pairdist_launch(
            x.data_ptr(), y.data_ptr(), out_f, out_m, a, b, m,
            _build.METRIC_IDS[metric], int(delta is not None),
            0.0 if delta is None else float(delta), _build.stream_ptr(x.device),
        )
        LAUNCHES["pairdist"] += 1
        _build.check("pairdist", rc, "pairdist launch")
    return out


def pairdist_filtered_cuda(
    x: Tensor,
    y: Tensor,
    px: Tensor,
    py: Tensor,
    metric: str,
    delta: float,
    delta_bound: float,
) -> Tensor:
    """(a, b) int8 mask ``(D <= delta) & (max_p |px - py| <= delta_bound)``."""
    _build.check_inputs("pairdist_filtered", x, y, px, py)
    a, b, m = x.shape[0], y.shape[0], x.shape[1]
    _check_rows("pairdist_filtered", a)
    bp = px.shape[1]
    if y.shape[1] != m or px.shape[0] != a or py.shape != (b, bp):
        raise ValueError(
            f"pairdist_filtered: shapes disagree x{tuple(x.shape)} y{tuple(y.shape)} "
            f"px{tuple(px.shape)} py{tuple(py.shape)}"
        )
    out = torch.empty((a, b), dtype=torch.int8, device=x.device)
    if a and b:
        lib = _build.lib("pairdist")
        rc = lib.pairdist_filtered_launch(
            x.data_ptr(), y.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
            a, b, m, bp, _build.METRIC_IDS[metric], float(delta), float(delta_bound),
            _build.stream_ptr(x.device),
        )
        LAUNCHES["pairdist_filtered"] += 1
        _build.check("pairdist", rc, "pairdist_filtered launch")
    return out
