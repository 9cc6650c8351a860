"""CUDA wrapper: the fused map phase (space map + kernel cell + packed whole
membership) in one pass over the rows.

``map_assign_cuda`` replaces ``repro/kernels/mapassign.py::
map_assign_blocked``; the kernel is in ``csrc/mapassign.cu`` (design notes
there), including the assign-only mode (``metric=None``: the input rows ARE
the mapped coordinates) and the ``want`` flags that zero-fill a skipped
output.

What bounds it on an H100: bytes. It reads each row once (n·m·4 bytes) and
writes n·(n_dims + 1 + ⌈p/32⌉) words, against n·n_dims·m pair-features of
space map — at m = 128 and n_dims = 8 that is ~16 operations per byte,
below the card's balance. The kernel streams the rows through a cp.async
ring, keeps the mapped coordinates in shared memory for both containment
sweeps (a warp per row, a lane per partition) and writes the membership
packed 32 partitions per word.

The launch is planned here, on the host, by :func:`launch_plan` (a pure
function of the shapes): rows per CTA, anchors per thread, the dimension
and word blocks and the shared memory they take. Any ``n_dims`` and any
``p`` run; a plan that would not fit the card is never made.

Takes CUDA float32 tensors only and raises otherwise; the plain version is
``ref.map_assign``/``ref.assign_membership``. ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

LAUNCHES = {"map_assign": 0}
THREADS = 256  # threads per CTA (csrc kThreads)
ROWS = (256, 128, 64, 32)  # rows per CTA in the metric modes, largest first
ASSIGN_ROWS = (512,) + ROWS  # the assign-only mode's
ANCHORS = (1, 2, 4, 8, 16, 32)  # anchors per thread: the kernel's template widths
CHUNK, STAGES = 16, 3  # features per staged chunk, cp.async ring depth
SWEEP_DIMS = 64  # mapped dims per block in the assign-only mode
SMEM_OPTIN = 232_448  # bytes of shared memory an H100 block can opt in to (227 KB)
SMEM_PER_SM = 233_472  # bytes of shared memory an H100 SM holds (228 KB), 1 KB of it per CTA
STREAM_CTAS = 3  # CTAs per SM of the persistent assign-only kernel (csrc launch bounds)


class MapPlan(NamedTuple):
    rows: int  # rows per CTA
    a: int  # anchors per thread (metric mode; 1 in the assign-only mode)
    db: int  # mapped dims per block (a multiple of 8)
    pw: int  # membership words per word block
    grid: int  # CTAs
    smem: int  # bytes of dynamic shared memory
    stream: bool = False  # the persistent assign-only kernel: `grid` CTAs walk the row tiles


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def smem_bytes(rows: int, db: int, pw: int, metric_mode: bool, stream: bool = False) -> int:
    """Dynamic shared memory of a plan: csrc ``ma_layout``, or
    ``ma_stream_floats`` for the persistent kernel (the C entry
    ``map_assign_smem_bytes`` computes the same)."""
    if stream:
        return 4 * (4 * db * 32 * pw + 2 * rows * db)  # the edges, two row buffers
    ring = STAGES * (rows * (CHUNK + 4) + CHUNK * (db + 4)) if metric_mode else 0
    norms = _round4(db) if metric_mode else 0
    floats = ring + norms + rows * (db + 4) + 4 * db * 32 * pw + 2 * rows * pw + _round4(rows)
    return 4 * floats


def launch_plan(
    n: int, nap: int, pp: int, p: int, metric_mode: bool, n_sm: int,
    smem_max: int = SMEM_OPTIN, rows: int | None = None,
) -> MapPlan:
    """The launch over ``n`` rows, ``nap`` padded mapped dims (a multiple of
    8) and ``pp`` padded partitions (a multiple of 32, ``p`` of them live)
    on a card of ``n_sm`` SMs (the sweeps skip the padding partitions):

    * rows per CTA: the largest of ``ROWS`` (``ASSIGN_ROWS`` in the
      assign-only mode) whose grid has a CTA for every SM (a 4,096-row
      query batch takes 32-row CTAs: 128 of them), or fewer where that does
      not fit ``smem_max`` (``rows`` forces one);
    * metric mode: threads per row g = 256 / rows and anchors per thread
      ``a`` — the fewest with g·a >= nap (one block over the rows), at
      most 32 (then more blocks), and at least 8 / g (blocks of >= 8 dims);
      the assign-only mode sweeps blocks of up to ``SWEEP_DIMS`` dims;
    * membership words: as many per block as fit beside the rest, spread
      evenly over the blocks;
    * the assign-only mode at 256 rows per CTA or more, with every dim and
      word in one block, takes the persistent kernel (``stream``): as few
      CTAs as finish the row tiles in the same number of rounds as
      ``STREAM_CTAS`` per SM would.
    """
    if nap < 8 or nap % 8 or pp < 32 or pp % 32 or not pp - 32 < p <= pp:
        raise ValueError(f"map_assign: bad padded shape nap={nap} pp={pp} p={p}")
    choices = ROWS if metric_mode else ASSIGN_ROWS
    if rows is not None:
        if rows not in choices:
            raise ValueError(f"map_assign: rows per CTA must be one of {choices}, got {rows}")
        choices = (rows,)
    first = next(i for i, r in enumerate(choices) if -(-n // r) >= n_sm or r == choices[-1])
    for rows in choices[first:]:
        if metric_mode:
            g = THREADS // rows
            blocks = [(a, g * a) for a in ANCHORS if g * a >= 8]
        else:
            top = min(nap, SWEEP_DIMS)
            blocks = [(1, db) for db in range(8, top + 1, 8)]
        blocks = [(a, db) for a, db in blocks if smem_bytes(rows, db, 1, metric_mode) <= smem_max]
        if not blocks:
            continue
        # One block over the dims if any fits (the fewest anchors that do),
        # else the widest block.
        a, db = next(((a, db) for a, db in blocks if db >= nap), blocks[-1])
        words = pp // 32
        base = smem_bytes(rows, db, 0, metric_mode)
        per_word = smem_bytes(rows, db, 1, metric_mode) - base
        n_blocks = -(-words // min(words, (smem_max - base) // per_word))
        pw = -(-words // n_blocks)
        tiles = -(-n // rows)
        smem_s = smem_bytes(rows, db, words, False, stream=True)
        if not metric_mode and rows >= THREADS and db >= nap and pw == words and smem_s <= smem_max:
            per_sm = min(STREAM_CTAS, SMEM_PER_SM // (smem_s + 1024))
            rounds = -(-tiles // (per_sm * n_sm))
            return MapPlan(rows, a, db, pw, -(-tiles // rounds), smem_s, stream=True)
        return MapPlan(rows, a, db, pw, tiles, smem_bytes(rows, db, pw, metric_mode))
    raise ValueError(f"map_assign: no plan fits {smem_max} bytes of shared memory")


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
    p: int | None = None,
    plan: MapPlan | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Raw call over pre-padded boxes (pp, nap): pp a multiple of 32, nap a
    multiple of 8 and >= n_dims, padded per ``ops._prep_boxes``; ``p`` the
    live partitions (default pp). ``metric=None`` is the assign-only mode
    (``x`` is (n, n_dims) mapped coordinates). ``plan`` overrides
    :func:`launch_plan` (every plan gives the same bits). Returns (xm (n,
    n_dims) f32, cells (n,) int32, bits (n, pp/32) int32); xm is ``x``
    itself in assign-only mode."""
    boxes = (klo, khi, wlo, whi)
    _build.check_inputs("map_assign", x, *boxes, *(() if anchors is None else (anchors,)))
    pp, nap = klo.shape
    if any(b.shape != (pp, nap) for b in boxes) or pp % 32 or nap % 8 or nap < n_dims:
        raise ValueError(f"map_assign: bad padded boxes {[tuple(b.shape) for b in boxes]}")
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
        p = pp if p is None else p
        if plan is None:
            plan = launch_plan(n, nap, pp, p, metric is not None, _build.sm_count(x.device.index))
        vec = int(m % 4 == 0 and x.data_ptr() % 16 == 0)
        rc = _build.lib("mapassign").map_assign_launch(
            x.data_ptr(), a_ptr, klo.data_ptr(), khi.data_ptr(), wlo.data_ptr(),
            whi.data_ptr(), xm_ptr, cells.data_ptr(), bits.data_ptr(),
            n, m, n_dims, nap, pp, mid, int(want_cells), int(want_member),
            plan.rows, plan.a, plan.db, plan.pw, p, plan.grid, int(plan.stream), vec,
            _build.stream_ptr(x.device),
        )
        LAUNCHES["map_assign"] += 1
        _build.check("mapassign", rc, "map_assign launch")
    return xm, cells, bits
