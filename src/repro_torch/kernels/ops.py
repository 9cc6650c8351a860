"""Public wrappers around the CUDA kernels: input preparation, backend
dispatch, and the plain versions they fall to on the CPU.

Backend dispatch (``backend=`` on every wrapper), the rules of the JAX
package's ``resolve_backend`` with names that fit a GPU:

  "cuda"   the hand-written kernel. Raises for a CPU tensor, or for a
           metric with no kernel.
  "torch"  the plain version in ``ref.py`` (the JAX package's "numpy").
  "auto"   "cuda" for a CUDA tensor, "torch" for a CPU tensor; metrics
           without a kernel always resolve to "torch" — a capability,
           not a fallback.

For a CUDA tensor the kernel launches or the call raises: nothing falls
back to the plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import compact as _compact
from repro_torch.kernels import histogram as _histogram
from repro_torch.kernels import mapassign as _mapassign
from repro_torch.kernels import pairdist as _pairdist
from repro_torch.kernels import ref

Tensor = torch.Tensor

METRICS = ref.METRICS
BACKENDS = ("torch", "cuda", "auto")
PRUNABLE_METRICS = ("l1", "l2", "linf")


def strict_fp32() -> None:
    """Switch TF32 off for matmuls and convolutions: the fp32 guard band of
    ``ref.prune_delta`` is derived for fp32 eps, and TF32 voids it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on; CUDA must be present when asked
    for (the entry points default to "cuda")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' needs a CUDA device; pass device='cpu' for the "
            "plain PyTorch path"
        )
    return dev


_LAUNCHES = (_pairdist.LAUNCHES, _mapassign.LAUNCHES, _compact.LAUNCHES, _histogram.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {k: v for counts in _LAUNCHES for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _LAUNCHES:
        for k in counts:
            counts[k] = 0


def supports_kernel(metric: str) -> bool:
    """True when ``metric`` has a CUDA kernel."""
    return metric in METRICS


def supports_prune(metric: str) -> bool:
    """True when the pivot filter is sound for ``metric`` on the kernel path
    (it needs the triangle inequality; cosine and dot are not metrics)."""
    return metric in PRUNABLE_METRICS


def resolve_backend(backend: str, metric: str | None, x: Tensor) -> str:
    """Resolve a backend request for tensor ``x`` to "torch" | "cuda"."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        if metric is not None and not supports_kernel(metric):
            return "torch"
        return "cuda" if x.is_cuda else "torch"
    if backend == "cuda":
        if metric is not None and not supports_kernel(metric):
            raise ValueError(f"metric {metric!r} has no CUDA kernel; supported: {METRICS}")
        if not x.is_cuda:
            raise ValueError(f"backend='cuda' needs CUDA tensors, got {x.device}")
    return backend


def _prep(x: Tensor, y: Tensor, metric: str) -> tuple[Tensor, Tensor]:
    """float32, contiguous, and cosine rows pre-normalised. No padding: the
    kernels mask their own ragged edges."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; kernels support {METRICS}")
    x = x.float()
    y = y.float()
    if metric == "cosine":
        x = ref._normalize(x)
        y = ref._normalize(y)
    return x.contiguous(), y.contiguous()


def pairdist(x: Tensor, y: Tensor, metric: str = "l2", *, backend: str = "auto") -> Tensor:
    """All-pairs distance matrix (a, b) float32."""
    if resolve_backend(backend, metric, x) == "torch":
        return ref.pairdist(x, y, metric)
    return _pairdist.pairdist_cuda(*_prep(x, y, metric), metric)


def pairdist_mask(
    x: Tensor, y: Tensor, delta: float, metric: str = "l2", *, backend: str = "auto"
) -> Tensor:
    """Fused thresholded join mask (a, b) bool — distances never reach
    device memory on the kernel path."""
    if resolve_backend(backend, metric, x) == "torch":
        return ref.pairdist_mask(x, y, delta, metric)
    return _pairdist.pairdist_cuda(*_prep(x, y, metric), metric, float(delta)).bool()


def pairdist_count(
    x: Tensor, y: Tensor, delta: float, metric: str = "l2", *, backend: str = "auto"
) -> Tensor:
    """Per-row join fan-out counts (a,) int32: the row sums of
    :func:`pairdist_mask` (on "cuda" the plain pairdist kernel's int8
    mask)."""
    return pairdist_mask(x, y, delta, metric, backend=backend).sum(-1).to(torch.int32)


def pairdist_mask_filtered(
    x: Tensor,
    y: Tensor,
    px: Tensor,
    py: Tensor,
    delta: float,
    metric: str = "l2",
    *,
    delta_bound: float | None = None,
    backend: str = "auto",
) -> Tensor:
    """Fused pivot-filter + thresholded join mask (a, b) bool; identical to
    :func:`pairdist_mask`, but the kernel skips the exact work of every
    CTA tile, and of every warp's 32x32 sub-tile, that the bound prunes
    entirely."""
    if not supports_prune(metric):
        raise ValueError(
            f"pivot filter is unsound for {metric!r} (needs the triangle "
            f"inequality); prunable kernel metrics: {PRUNABLE_METRICS}"
        )
    if delta_bound is None:
        delta_bound = ref.prune_delta(delta, metric)
    if resolve_backend(backend, metric, x) == "torch":
        return ref.pairdist_mask_filtered(x, y, px, py, delta, metric, delta_bound)
    xp, yp = _prep(x, y, metric)
    # Pivot coordinates ride un-normalised (they are distances, not payload).
    return _pairdist.pairdist_filtered_cuda(
        xp, yp, px.float().contiguous(), py.float().contiguous(), metric,
        float(delta), float(delta_bound),
    ).bool()


def _ids32(ids: Tensor) -> Tensor:
    """Ids as contiguous int32 (-1 = padding); raises on ids >= 2**31. An
    int32 input needs no check, so the engine's int32 ids cost no read."""
    if ids.dtype != torch.int32:
        if ids.numel() and int(ids.max()) >= 2**31:
            raise ValueError("verify_compact: ids must be below 2**31")
        ids = ids.to(torch.int32)
    return ids.contiguous()


def verify_compact(
    x: Tensor,
    y: Tensor,
    vids: Tensor,
    wids: Tensor,
    wcells: Tensor | None,
    cell_id: int,
    px: Tensor | None = None,
    py: Tensor | None = None,
    *,
    delta: float,
    metric: str,
    capacity: int,
    cross: bool = False,
    delta_bound: float | None = None,
    backend: str = "auto",
) -> tuple[Tensor, Tensor, Tensor]:
    """Fused single-launch reduce step: (filter,) distance, threshold,
    validity + min-cell de-dup, and on-device pair compaction.

    ``vids`` / ``wids`` / ``wcells``: (a,) / (b,) ids with padding = -1
    (``wcells`` unused when ``cross``); ``cell_id`` the verified cell,
    passed at run time. With ``px``/``py`` (mapped coordinates) the pivot
    bound is fused in front of the exact distance (prunable metrics only;
    ``delta_bound`` defaults to ``ref.prune_delta``).

    Returns ``(pairs, count, n_cand)``: ``pairs`` (capacity, 2) int32 id
    pairs padded with -1, ``count`` 0-d int32, the TRUE hit total
    (``count > capacity`` is overflow: the caller retries bigger),
    ``n_cand`` 0-d int32, the bound survivors among valid pairs (all valid
    pairs when unfiltered). Pair ORDER differs between backends (row-major
    on "torch", CTA order on "cuda"); callers sort. Plain version:
    ``ref.verify_compact``.
    """
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if px is not None:
        if not supports_prune(metric):
            raise ValueError(
                f"pivot filter is unsound for {metric!r} (needs the triangle "
                f"inequality); prunable kernel metrics: {PRUNABLE_METRICS}"
            )
        if delta_bound is None:
            delta_bound = ref.prune_delta(delta, metric)
    if resolve_backend(backend, metric, x) == "torch":
        return ref.verify_compact(
            x, y, vids, wids, wcells, cell_id, delta=delta, metric=metric,
            capacity=capacity, cross=cross, px=px, py=py, delta_bound=delta_bound,
        )
    a, b = x.shape[0], y.shape[0]
    if a == 0 or b == 0:  # empty tile: nothing to launch
        zero = torch.zeros((), dtype=torch.int32, device=x.device)
        return torch.full((capacity, 2), -1, dtype=torch.int32, device=x.device), zero, zero
    xp, yp = _prep(x, y, metric)
    prune = px is not None
    pairs, counts = _compact.verify_compact_cuda(
        xp, yp, _ids32(vids), _ids32(wids), None if cross else _ids32(wcells), int(cell_id),
        px.float().contiguous() if prune else None, py.float().contiguous() if prune else None,
        metric=metric, delta=float(delta),
        delta_bound=float(delta_bound) if prune else 0.0, capacity=capacity, cross=cross,
    )
    return pairs, counts[0], counts[1]


# ---------------------------------------------------------------------------
# Fused map phase: space map + kernel assign + packed whole membership
# ---------------------------------------------------------------------------

_ND_MULT = 8  # mapped-coordinate (anchor) axis padded to this multiple
_BIG = ref.BIG
WANTS = ("both", "cells", "member")


def _pad_const(x: Tensor, mult: int, axis: int, value: float) -> Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis) + 1] = pad  # F.pad lists the last axis first
    return torch.nn.functional.pad(x, widths, value=value)


def _prep_boxes(
    kernel_lo: Tensor, kernel_hi: Tensor, whole_lo: Tensor, whole_hi: Tensor
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Pad the (p, n) box edges for the kernel.

    Padded DIMENSIONS get (-BIG, +BIG) edges — any finite coordinate
    satisfies them, so they never veto containment. Padded PARTITIONS (up to
    a whole 32-bit word) get lo = +BIG — no finite coordinate reaches them,
    so they never match (neither half-open kernel nor closed whole)."""

    def pad(lo: Tensor, hi: Tensor) -> tuple[Tensor, Tensor]:
        lo = _pad_const(lo.float(), _ND_MULT, 1, -_BIG)
        hi = _pad_const(hi.float(), _ND_MULT, 1, _BIG)
        lo = _pad_const(lo, ref.MEMBER_WORD, 0, _BIG)
        hi = _pad_const(hi, ref.MEMBER_WORD, 0, _BIG)
        return lo.contiguous(), hi.contiguous()

    return (*pad(kernel_lo, kernel_hi), *pad(whole_lo, whole_hi))


def _want_flags(want: str) -> tuple[bool, bool]:
    if want not in WANTS:
        raise ValueError(f"unknown want {want!r}; expected one of {WANTS}")
    return want != "member", want != "cells"


def _ref_assign(xm, kernel_lo, kernel_hi, whole_lo, whole_hi, want_cells, want_member):
    """Plain assign with the same zero-fill contract as the kernel."""
    n_rows = xm.shape[0]
    words = -(-kernel_lo.shape[0] // ref.MEMBER_WORD)
    cells = (
        ref.assign_kernel_cells(xm, kernel_lo, kernel_hi)
        if want_cells
        else torch.zeros((n_rows,), dtype=torch.int32, device=xm.device)
    )
    bits = (
        ref.membership_bits(xm, whole_lo, whole_hi)
        if want_member
        else torch.zeros((n_rows, words), dtype=torch.int32, device=xm.device)
    )
    return cells, bits


def map_assign(
    x: Tensor,
    anchors: Tensor,
    kernel_lo: Tensor,
    kernel_hi: Tensor,
    whole_lo: Tensor,
    whole_hi: Tensor,
    metric: str = "l2",
    *,
    backend: str = "auto",
    want: str = "both",
) -> tuple[Tensor, Tensor, Tensor]:
    """Fused map phase over a set of rows: the mapped coordinates
    ``xm = D(x, anchors)`` (N, n), the kernel cell id (N,) int32 and the
    packed whole membership (N, ⌈p/32⌉) int32 (uint32 bit pattern; unpack
    with :func:`unpack_membership`). ``want``: "both" | "cells" | "member" —
    the skipped output is zero-filled."""
    n_dims = anchors.shape[0]
    p = kernel_lo.shape[0]
    words = -(-p // ref.MEMBER_WORD)
    want_cells, want_member = _want_flags(want)
    if resolve_backend(backend, metric, x) == "torch":
        xm = ref.pairdist(x, anchors, metric)
        cells, bits = _ref_assign(
            xm, kernel_lo, kernel_hi, whole_lo, whole_hi, want_cells, want_member
        )
        return xm, cells, bits
    xp, ap = _prep(x, anchors, metric)
    xm, cells, bits = _mapassign.map_assign_cuda(
        xp, ap, *_prep_boxes(kernel_lo, kernel_hi, whole_lo, whole_hi),
        metric=metric, n_dims=n_dims, want_cells=want_cells, want_member=want_member, p=p,
    )
    return xm, cells, bits[:, :words]


def assign_membership(
    xm: Tensor,
    kernel_lo: Tensor,
    kernel_hi: Tensor,
    whole_lo: Tensor,
    whole_hi: Tensor,
    *,
    backend: str = "auto",
    want: str = "both",
) -> tuple[Tensor, Tensor]:
    """Assign-only variant of :func:`map_assign`: ``xm`` (N, n) is already
    mapped (the kernel's ``metric=None`` mode). Returns (cells (N,) int32,
    bits (N, ⌈p/32⌉) int32)."""
    p = kernel_lo.shape[0]
    words = -(-p // ref.MEMBER_WORD)
    want_cells, want_member = _want_flags(want)
    if resolve_backend(backend, None, xm) == "torch":
        return _ref_assign(
            xm, kernel_lo, kernel_hi, whole_lo, whole_hi, want_cells, want_member
        )
    _, cells, bits = _mapassign.map_assign_cuda(
        xm.float().contiguous(), None,
        *_prep_boxes(kernel_lo, kernel_hi, whole_lo, whole_hi),
        metric=None, n_dims=xm.shape[1], want_cells=want_cells, want_member=want_member, p=p,
    )
    return cells, bits[:, :words]


def unpack_membership(bits: Tensor, p: int) -> Tensor:
    """(N, ⌈p/32⌉) packed words → (N, p) bool whole-membership mask."""
    return ref.unpack_membership(bits, p)


# ---------------------------------------------------------------------------
# GoF cell counts of the distributed stats stage
# ---------------------------------------------------------------------------


def histogram(u: Tensor, t: int, weights: Tensor | None = None, *, backend: str = "auto") -> Tensor:
    """Per-dimension histogram (m, t) float32 of CDF-space values u (n, m):
    the sum of each row's weight (default 1) over the rows whose
    ``clip(trunc(u·t), 0, t − 1)`` is the cell. Plain version:
    ``ref.histogram``."""
    if resolve_backend(backend, None, u) == "torch":
        return ref.histogram(u, t, weights)
    n = u.shape[0]
    w = (
        torch.ones((n,), dtype=torch.float32, device=u.device)
        if weights is None
        else weights.reshape(n).float()
    )
    return _histogram.histogram_cuda(u.float().contiguous(), w.contiguous(), int(t))
