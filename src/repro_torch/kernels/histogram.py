"""CUDA wrapper: the weighted per-dimension histogram (the GoF cell counts).

``histogram_cuda`` replaces ``repro/kernels/histogram.py::
histogram_blocked``; the kernels are in ``csrc/histogram.cu`` (design notes
there). It computes what ``ref.histogram`` computes: for u (n, m) and a
weight per row, the (m, t) sums of the weights of the rows whose
``clip(trunc(u·t), 0, t − 1)`` is each cell.

What bounds it on an H100: bytes. It reads u once (n·m·4 bytes) and the
weights once (n·4) and writes m·t floats; the binning is a few operations
per element. A thread owns 4 consecutive dimensions (float4 loads where
the rows allow) and counts in registers for t <= 16, in shared-memory
histograms for larger t, or with global atomics where not even one quad's
histogram fits shared memory; :func:`launch_plan` (a pure function of the
shapes) picks the way and the grid. Any t >= 1 runs.

The wrapper zeroes the (m, t) output with ``torch.zeros`` and raises on CPU
tensors, on a non-float32 or non-contiguous input, on t < 1 and on a failed
launch. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

LAUNCHES = {"histogram": 0}
THREADS = 256  # threads per CTA (csrc kHThreads)
WARPS = THREADS // 32
REGISTERS, SHARED, GLOBAL = 0, 1, 2  # ways to count (csrc HistMode)
REG_CELLS = (8, 16)  # register counters per dimension: the kernel's template widths
SHARED_BLOCK = 48 * 1024  # bytes of one shared histogram before the block narrows
SHARED_BUDGET = 96 * 1024  # bytes of the per-warp copies together (two CTAs per SM)
CTAS_PER_SM = 8  # grid size: CTAs per SM in all, each walking a strided row range
MAX_GRID_Y = 65535
SMEM_OPTIN = 232_448  # bytes of shared memory an H100 block can opt in to (227 KB)


class HistPlan(NamedTuple):
    mode: int  # REGISTERS | SHARED | GLOBAL
    tmax: int  # register counters per dimension (REGISTERS), else 0
    qb: int  # quads (4 dimensions) per CTA, a power of two <= 32
    copies: int  # shared histograms per CTA (SHARED), else 1
    grid_x: int  # dimension blocks
    grid_y: int  # row ranges
    smem: int  # bytes of dynamic shared memory


def smem_bytes(t: int, qb: int, mode: int, tmax: int, copies: int) -> int:
    """Dynamic shared memory of a plan (the C entry ``histogram_smem_bytes``
    computes the same)."""
    if mode == REGISTERS:
        return 4 * THREADS * 4 * tmax  # the row slots' counters, summed at the end
    if mode == SHARED:
        return 4 * copies * 4 * qb * (t | 1)
    return 0


def launch_plan(n: int, m: int, t: int, n_sm: int, smem_max: int = SMEM_OPTIN) -> HistPlan:
    """How to count (m, t) cells over n rows on a card of ``n_sm`` SMs:
    registers for t <= 16; else shared histograms, the block narrowed
    until one copy takes at most ``SHARED_BLOCK`` bytes (or one quad) and
    as many per-warp copies as ``SHARED_BUDGET`` holds (at least one, up
    to ``smem_max``); else global atomics. Row ranges: ``CTAS_PER_SM`` CTAs
    per SM in all, never more than there are row groups."""
    if t < 1 or n < 0 or m < 1:
        raise ValueError(f"histogram: bad shape n={n} m={m} t={t}")
    quads = -(-m // 4)
    qb = min(32, 1 << (quads - 1).bit_length())
    tmax, copies = 0, 1
    if t <= REG_CELLS[-1]:
        mode = REGISTERS
        tmax = next(c for c in REG_CELLS if t <= c)
    else:
        mode = SHARED
        while qb > 1 and smem_bytes(t, qb, SHARED, 0, 1) > SHARED_BLOCK:
            qb //= 2
        one = smem_bytes(t, qb, SHARED, 0, 1)
        if one > smem_max:
            mode, qb = GLOBAL, min(32, 1 << (quads - 1).bit_length())
        else:
            copies = next(c for c in (WARPS, 4, 2, 1) if c == 1 or c * one <= SHARED_BUDGET)
    grid_x = -(-quads // qb)
    row_groups = max(1, -(-n // (THREADS // qb)))
    grid_y = max(1, min(row_groups, (CTAS_PER_SM * n_sm) // grid_x, MAX_GRID_Y))
    return HistPlan(mode, tmax, qb, copies, grid_x, grid_y, smem_bytes(t, qb, mode, tmax, copies))


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
    if t < 1:
        raise ValueError(f"histogram: t must be >= 1, got {t}")
    out = torch.zeros((m, t), dtype=torch.float32, device=u.device)
    if n and m:
        plan = launch_plan(n, m, int(t), _build.sm_count(u.device.index))
        vec = int(m % 4 == 0 and u.data_ptr() % 16 == 0)
        rc = _build.lib("histogram").histogram_launch(
            u.data_ptr(), weights.data_ptr(), out.data_ptr(), n, m, int(t), plan.mode,
            plan.tmax, plan.qb, plan.copies, plan.grid_x, plan.grid_y, vec,
            _build.stream_ptr(u.device),
        )
        LAUNCHES["histogram"] += 1
        _build.check("histogram", rc, "histogram launch")
    return out
