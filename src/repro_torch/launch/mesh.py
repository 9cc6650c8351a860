"""Device meshes over an initialised ``torch.distributed`` world, and the
H100's roofline constants (the port of ``repro.launch.mesh``).

The mesh constructors are FUNCTIONS, never module-level constants: importing
this module touches no process group and no device. Each builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the world
the caller initialised (``init_process_group`` with its own address, world
size and rank); none initialises a world itself (``fake_world`` is the
dry run's own). By default a mesh is on the card and needs an NCCL world;
``device="cpu"`` asks for a gloo one, ``device="fake"`` for the world of
``fake_world``: one process as rank 0 of the production mesh, collectives
that move nothing, on ``meta`` tensors. A world of the wrong backend or
size is an error, never a quiet fallback.

Mesh semantics (the reference's):
  single-pod (16, 16)    axes ("data", "model") — 256 ranks
  multi-pod  (2, 16, 16) axes ("pod", "data", "model") — 512 ranks

"data" (+"pod") carries batch/FSDP and is the SP-Join "local node" axis;
"model" carries TP/EP.

Serving: ``make_host_mesh`` is the mesh entry point of the query-serving
path — ``MetricIndex.to_distributed(make_host_mesh(axis="data")
.get_group("data"))`` pins the per-slot V buffers over the "data" axis
(``python -m repro_torch.launch.serve range``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_BACKEND = {"cuda": "nccl", "cpu": "gloo", "fake": "fake"}
_MESH_DEVICE = {"cuda": "cuda", "cpu": "cpu", "fake": "cpu"}


def _require_world() -> None:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised world: call "
                           "torch.distributed.init_process_group first")


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a world of ``n`` ranks whose collectives
    move nothing (torch's "fake" backend): the dry run's world. It refuses,
    touching nothing, when a world is already initialised, sets no
    environment variable, and destroys its group on the way out."""
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a world; one is initialised")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"torch {torch.__version__} has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg)") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    world (ranks in row-major order), on ``device`` ("cuda" with NCCL,
    "cpu" with gloo, or "fake" with ``fake_world``'s backend: a CPU mesh
    for ``meta`` tensors). Every rank of the world calls it."""
    if device not in _BACKEND:
        raise ValueError(f"device must be 'cuda' or 'cpu' ('fake' in fake_world), not {device!r}")
    _require_world()
    backend = dist.get_backend()
    if _BACKEND[device] not in backend:
        raise RuntimeError(f"a {device} mesh needs a {_BACKEND[device]} world; this world is {backend}")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the world has {dist.get_world_size()}")
    return DeviceMesh(_MESH_DEVICE[device], torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(n: int | None = None, axis: str = "data", device: str = "cuda"):
    """1-D mesh over the world — the serving-path default and the
    launcher's mesh. ``n=None`` takes every rank."""
    _require_world()
    return make_mesh((n or dist.get_world_size(),), (axis,), device)


def elastic_shape(live_hosts: int, chips_per_host: int = 4) -> tuple[int, int]:
    """(data, model) for the live host set: "model" the largest of 16, 8,
    4, 2, 1 that divides the device count."""
    total = live_hosts * chips_per_host
    model = 1
    for cand in (16, 8, 4, 2, 1):
        if total % cand == 0 and cand <= total:
            model = cand
            break
    return total // model, model


def make_elastic_mesh(live_hosts: int, chips_per_host: int = 4, device: str = "cuda"):
    """Elastic re-mesh: the mesh shape as a function of the LIVE host set.
    The data pipeline is step-addressed, so the global batch is unchanged
    by a re-mesh — only its sharding moves."""
    return make_mesh(elastic_shape(live_hosts, chips_per_host), ("data", "model"), device)


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-card constants (the roofline denominators). Defaults: one
    NVIDIA H100 SXM, dense rates from NVIDIA's data sheet at its 700 W
    limit."""

    peak_flops: float = 989e12  # bf16 FLOP/s, tensor cores, dense
    peak_flops_fp32: float = 67e12  # FLOP/s outside the tensor cores
    hbm_bw: float = 3.35e12  # bytes/s
    link_bw: float = 900e9  # NVLink 4 bytes/s per card (both directions)
    hbm_bytes: float = 80e9  # capacity

    def roofline_seconds(
        self, flops: float, bytes_hbm: float, bytes_coll: float, chips: int
    ) -> dict:
        return {
            "compute_s": flops / (chips * self.peak_flops),
            "memory_s": bytes_hbm / (chips * self.hbm_bw),
            "collective_s": bytes_coll / (chips * self.link_bw),
        }


H100_SXM = HardwareModel()
