"""CUDA wrapper: fused verify + on-device pair compaction.

``verify_compact_cuda`` replaces ``repro/kernels/compact.py::
verify_compact_blocked``; the kernel is in ``csrc/compact.cu`` (design notes
there). It computes what ``ref.verify_compact`` computes — the optional
pivot bound, the exact distance, ``<= delta``, validity and the min-cell
de-dup rule, then the surviving ``(v_id, w_id)`` pairs packed into a
(capacity, 2) buffer — except the order of the pairs, which depends on the
order the CTAs reach the global cursor (the engine sorts).

What bounds it on an H100: operations, as the filtered pairdist kernel
(the survivors' exact distance work on the CUDA cores, plus the bound
pass); what it writes is O(hits) — the pair buffer's filled slots and two
counters — instead of the (a, b) mask.

The wrapper allocates the -1-filled pair buffer and the zeroed counters,
passes ``cell_id``/``delta``/``delta_bound`` at run time (nothing is
recompiled per cell), and raises on CPU tensors, on ids that are not
int32, and on a failed launch. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairdist import launch_plan, stage_flags

Tensor = torch.Tensor

LAUNCHES = {"verify_compact": 0}


def verify_compact_cuda(
    x: Tensor,
    y: Tensor,
    vids: Tensor,
    wids: Tensor,
    wcells: Tensor | None,
    cell_id: int,
    px: Tensor | None,
    py: Tensor | None,
    *,
    metric: str,
    delta: float,
    delta_bound: float,
    capacity: int,
    cross: bool,
) -> tuple[Tensor, Tensor]:
    """Returns ``(pairs (capacity, 2) int32, counts (2,) int32)`` with
    ``counts = [true hit total, candidate count]``. ``x``/``y`` are float32
    (cosine rows pre-normalised by the caller); ids are int32 with -1 for
    padding; ``wcells`` is unused (may be None) when ``cross``. The CTA
    tile and the staging path are chosen as for the filtered pairdist
    kernel (``pairdist.launch_plan``, ``pairdist.stage_flags``)."""
    prune = px is not None
    _build.check_inputs("verify_compact", x, y, *((px, py) if prune else ()))
    _build.check_ids("verify_compact", vids, wids, *(() if cross else (wcells,)))
    a, b, m = x.shape[0], y.shape[0], x.shape[1]
    bp = px.shape[1] if prune else 0
    if y.shape[1] != m or vids.shape[0] != a or wids.shape[0] != b or (
        not cross and wcells.shape[0] != b
    ) or (prune and (px.shape[0] != a or py.shape != (b, bp))):
        raise ValueError(
            f"verify_compact: shapes disagree x{tuple(x.shape)} y{tuple(y.shape)} "
            f"vids{tuple(vids.shape)} wids{tuple(wids.shape)}"
        )
    pairs = torch.full((capacity, 2), -1, dtype=torch.int32, device=x.device)
    counts = torch.zeros((2,), dtype=torch.int32, device=x.device)
    if a and b:
        tile = launch_plan("verify_compact", x, a, b)
        lib = _build.lib("compact")
        rc = lib.verify_compact_launch(
            x.data_ptr(), y.data_ptr(),
            px.data_ptr() if prune else None, py.data_ptr() if prune else None,
            vids.data_ptr(), wids.data_ptr(), None if cross else wcells.data_ptr(),
            int(cell_id), a, b, m, bp, _build.METRIC_IDS[metric], int(prune), int(cross),
            float(delta), float(delta_bound), int(capacity), tile,
            stage_flags(x, y, px, py), pairs.data_ptr(), counts.data_ptr(),
            _build.stream_ptr(x.device),
        )
        LAUNCHES["verify_compact"] += 1
        _build.check("compact", rc, "verify_compact launch")
    return pairs, counts
