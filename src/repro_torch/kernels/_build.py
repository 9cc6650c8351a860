"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. The libraries go into
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused. Every source is compiled at once (one ``nvcc`` process each,
started together) at the first launch of any kernel, or when a caller asks
with :func:`build_all`. Nothing here runs at import time: a machine without
``nvcc`` imports the package and runs the plain versions.

Every launch function returns the CUDA error code of its launch (0 on
success); :func:`check` raises on anything else.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("pairdist", "mapassign", "compact", "histogram")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Metric ids of csrc/distcore.cuh; -1 is map-assign's assign-only mode.
METRIC_IDS = {"l1": 0, "l2": 1, "linf": 2, "cosine": 3, "dot": 4}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "pairdist": {
        "pairdist_launch": [_P] * 4 + [_I] * 5 + [_F, _I, _I, _P],
        "pairdist_filtered_launch": [_P] * 5 + [_I] * 5 + [_F, _F, _I, _I, _P],
    },
    "mapassign": {
        "map_assign_launch": [_P] * 9 + [_I] * 16 + [_P],
        "map_assign_smem_bytes": [_I] * 5,
        "map_assign_occupancy": [_I] * 6,
    },
    "compact": {
        "verify_compact_launch": [_P] * 7 + [_I] * 8 + [_F, _F, _I, _I, _I] + [_P] * 3,
    },
    "histogram": {
        "histogram_launch": [_P] * 3 + [_I] * 10 + [_P],
        "histogram_smem_bytes": [_I] * 5,
        "histogram_occupancy": [_I],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
ptxas_log: dict[str, str] = {}  # nvcc's -Xptxas -v report per source


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.name == f"{name}.cu" or f.suffix == ".cuh":
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every source not yet built, all in parallel; load them all.
    Returns the seconds each compile took (0.0 when reused)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    seconds = {name: 0.0 for name in SOURCES}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        ptxas_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in SOURCES:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return seconds


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building on first use."""
    if name not in _libs:
        build_all()
    return _libs[name]


def check(name: str, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib(name).repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def check_inputs(name: str, *ts: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous 2-D float32 CUDA tensor —
    what the kernels take."""
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous 2-D float32, got {t.dtype} {tuple(t.shape)}"
            )


def check_ids(name: str, *ts: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous 1-D int32 CUDA tensor (the
    kernels' id vectors; int32 holds every id below 2**31)."""
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got {t.device}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous 1-D int32 ids, got {t.dtype} {tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``: the launch plans size their grids by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
