"""CUDA wrappers: blocked all-pairs distance, plain and pivot-filtered.

``pairdist_cuda`` replaces ``repro/kernels/pairdist.py::pairdist_blocked``
and ``pairdist_filtered_cuda`` replaces ``::pairdist_filtered_blocked``; the
kernels are in ``csrc/pairdist.cu`` on the verify tile of
``csrc/tilecore.cuh`` (design notes there).

What bounds them on an H100: operations. At the verify engine's tile shapes
(up to 1024 x 4096 pairs over m = 128 features) a tile is ~0.5 G
pair-features against ~20 MB of rows and mask, far above the card's
bytes-per-operation balance; l1/linf spend two fp32 instructions per
pair-feature on the CUDA cores, l2/cosine/dot one FMA (TF32 tensor cores
are ruled out by the fp32 guard band of ``ref.prune_delta``). The design
keeps the accumulator in registers (8x8 per thread on the 128x128 tile),
stages 16-feature chunks with cp.async and reads them feature-major from
shared memory, and the filtered kernel skips the feature loads of a CTA,
and the arithmetic of a warp's 32x32 sub-tile, where the pivot bound
prunes every pair.

Two choices are made here, on the host, per launch (``launch_plan``): the
CTA tile (:func:`choose_tile`: 128x128 when that grid has a CTA for every
SM, else 64x64) and the staging path (:func:`stage_flags`: 16-byte copies
for rows whose width is a multiple of 4 floats on 16-byte aligned bases,
4-byte copies otherwise). Neither changes a result bit.

Each wrapper takes CUDA float32 tensors only and raises otherwise; the
plain versions are ``ref.pairdist``/``ref.pairdist_mask``/
``ref.pairdist_mask_filtered``. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations


import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

LAUNCHES = {"pairdist": 0, "pairdist_filtered": 0}
TILES = (128, 64)  # CTA tile edges of csrc/tilecore.cuh, largest first
MAX_GRID_Y = 65535  # CTA rows of one launch (gridDim.y): MAX_GRID_Y * tile x rows
VEC_ROWS, VEC_PIVOTS = 1, 2  # stage flags of csrc/tilecore.cuh (kVecRows, kVecPivots)


def choose_tile(a: int, b: int, n_sm: int) -> int:
    """The largest CTA tile whose (a, b) grid still has a CTA for each of
    the card's ``n_sm`` SMs, else the smallest: a short tile (a 256-row
    query batch, a cell's last tile) takes 64x64 and keeps the card busy."""
    for t in TILES:
        if -(-a // t) * -(-b // t) >= n_sm:
            return t
    return TILES[-1]


def _vec_ok(u: Tensor, v: Tensor) -> bool:
    return u.shape[1] % 4 == 0 and u.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0


def stage_flags(x: Tensor, y: Tensor, px: Tensor | None = None, py: Tensor | None = None) -> int:
    """The kernel's staging path per operand pair: ``VEC_ROWS`` when the
    feature rows take 16-byte copies (width a multiple of 4 floats and both
    bases 16-byte aligned, so every row start is), ``VEC_PIVOTS`` likewise
    for the pivot coordinates; the rest take 4-byte copies."""
    flags = VEC_ROWS if _vec_ok(x, y) else 0
    if px is not None and _vec_ok(px, py):
        flags |= VEC_PIVOTS
    return flags


def launch_plan(name: str, x: Tensor, a: int, b: int, tile: int | None = None) -> int:
    """The CTA tile of a launch over (a, b) pairs on ``x``'s card (``tile``
    forces one of ``TILES``); raises when the grid would exceed its rows."""
    if tile is None:
        tile = choose_tile(a, b, _build.sm_count(x.device.index))
    if tile not in TILES:
        raise ValueError(f"{name}: tile must be one of {TILES}, got {tile}")
    if -(-a // tile) > MAX_GRID_Y:
        raise ValueError(f"{name}: at most {MAX_GRID_Y * tile} x rows per launch of the "
                         f"{tile}x{tile} tile, got {a}")
    return tile


def pairdist_cuda(x: Tensor, y: Tensor, metric: str, delta: float | None = None) -> Tensor:
    """(a, b) float32 distances, or the int8 ``D <= delta`` mask when
    ``delta`` is given. Cosine rows must be pre-normalised by the caller."""
    _build.check_inputs("pairdist", x, y)
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"pairdist: feature widths differ {x.shape} vs {y.shape}")
    a, b, m = x.shape[0], y.shape[0], x.shape[1]
    if delta is None:
        out = torch.empty((a, b), dtype=torch.float32, device=x.device)
        out_f, out_m = out.data_ptr(), None
    else:
        out = torch.empty((a, b), dtype=torch.int8, device=x.device)
        out_f, out_m = None, out.data_ptr()
    if a and b:
        tile = launch_plan("pairdist", x, a, b)
        lib = _build.lib("pairdist")
        rc = lib.pairdist_launch(
            x.data_ptr(), y.data_ptr(), out_f, out_m, a, b, m,
            _build.METRIC_IDS[metric], int(delta is not None),
            0.0 if delta is None else float(delta), tile, stage_flags(x, y),
            _build.stream_ptr(x.device),
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
    bp = px.shape[1]
    if y.shape[1] != m or px.shape[0] != a or py.shape != (b, bp):
        raise ValueError(
            f"pairdist_filtered: shapes disagree x{tuple(x.shape)} y{tuple(y.shape)} "
            f"px{tuple(px.shape)} py{tuple(py.shape)}"
        )
    out = torch.empty((a, b), dtype=torch.int8, device=x.device)
    if a and b:
        tile = launch_plan("pairdist_filtered", x, a, b)
        lib = _build.lib("pairdist")
        rc = lib.pairdist_filtered_launch(
            x.data_ptr(), y.data_ptr(), px.data_ptr(), py.data_ptr(), out.data_ptr(),
            a, b, m, bp, _build.METRIC_IDS[metric], float(delta), float(delta_bound),
            tile, stage_flags(x, y, px, py), _build.stream_ptr(x.device),
        )
        LAUNCHES["pairdist_filtered"] += 1
        _build.check("pairdist", rc, "pairdist_filtered launch")
    return out
