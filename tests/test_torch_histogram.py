"""The port's plain histogram (``repro_torch.kernels.ref.histogram``, what
``ops.histogram`` runs on a CPU tensor) against the JAX package's
``ref.histogram`` and its Pallas kernel ``histogram_blocked`` in interpret
mode: ragged n and m, t in {4, 8, 16}, weights with zeros, the edge values
of ``cell = clip(trunc(u·t), 0, t − 1)`` and empty inputs. Counts are
integers in float32, so equality is exact.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

jhist = importlib.import_module("repro.kernels.histogram")  # the module, not ops' jitted fn

# u = 0, the largest float below 1, 1, below 0, far above 1, NaN, ±inf.
EDGES = np.array(
    [0.0, 1.0 - 2.0**-24, 1.0, -0.5, -2.0, 7.0, 1e30, np.nan, np.inf, -np.inf], np.float32
)


def _inputs(n, m, seed=0, edges=True):
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.05, 1.05, size=(n, m)).astype(np.float32)
    if edges and n:
        rows = min(n, EDGES.size)
        u[:rows] = np.resize(EDGES, (m,))[None, :]
        for i in range(rows):  # each edge value in every column somewhere
            u[i] = np.roll(np.resize(EDGES, (m,)), i)
    w = (rng.uniform(size=n) > 0.25).astype(np.float32)
    return u, w


def _reference(u, w, t):
    a = np.asarray(jref.histogram(jnp.asarray(u), t, jnp.asarray(w)))
    b = np.asarray(jhist.histogram_blocked(
        jnp.asarray(u), jnp.asarray(w).reshape(-1, 1), t=t, bn=64, bmm=8, interpret=True))
    assert a.tobytes() == b.tobytes()
    return a


@pytest.mark.parametrize("t", (4, 8, 16))
@pytest.mark.parametrize("n,m", ((1000, 33), (257, 5), (64, 128), (1, 1), (13, 9)))
def test_histogram_matches_reference(n, m, t):
    u, w = _inputs(n, m, seed=n + m + t)
    want = _reference(u, w, t)
    got = ref.histogram(torch.as_tensor(u), t, torch.as_tensor(w))
    assert got.dtype == torch.float32 and got.shape == (m, t)
    assert got.numpy().tobytes() == want.tobytes()
    assert ops.histogram(torch.as_tensor(u), t, torch.as_tensor(w)).numpy().tobytes() == want.tobytes()
    # Zero-weight rows contribute nothing; every weighted value lands once.
    assert float(got.sum()) == float(w.sum()) * m


@pytest.mark.parametrize("t", (384, 1024))
def test_histogram_many_cells_matches_reference(t):
    """t past 383 cells (the kernel plan's shared histograms over narrower
    dim blocks): ``ops.histogram`` (the plain version on a CPU tensor)
    against the JAX package's ``ref.histogram``, exact."""
    u, w = _inputs(2000, 9, seed=t)
    want = np.asarray(jref.histogram(jnp.asarray(u), t, jnp.asarray(w)))
    got = ops.histogram(torch.as_tensor(u), t, torch.as_tensor(w))
    assert got.shape == (9, t) and got.numpy().tobytes() == want.tobytes()
    assert float(got.sum()) == float(w.sum()) * 9


@pytest.mark.parametrize("value", EDGES.tolist(), ids=lambda v: repr(v))
@pytest.mark.parametrize("t", (4, 8, 16))
def test_edge_value_cells(value, t):
    u = np.full((3, 2), value, np.float32)
    w = np.ones(3, np.float32)
    want = _reference(u, w, t)
    got = ref.histogram(torch.as_tensor(u), t, torch.as_tensor(w)).numpy()
    assert got.tobytes() == want.tobytes()
    (cell,) = np.flatnonzero(got[0])
    if np.isnan(value) or value <= 0.0:
        assert cell == 0
    elif value >= 1.0:
        assert cell == t - 1


def test_unweighted_and_empty():
    u, _ = _inputs(300, 7, seed=3)
    want = np.asarray(jref.histogram(jnp.asarray(u), 8))
    assert ref.histogram(torch.as_tensor(u), 8).numpy().tobytes() == want.tobytes()
    for n, m in ((0, 7), (9, 0), (0, 0)):
        u = np.zeros((n, m), np.float32)
        want = np.asarray(jhist.histogram_blocked(jnp.asarray(u), jnp.zeros((n, 1)), t=8))
        got = ref.histogram(torch.as_tensor(u), 8, torch.zeros(n))
        assert got.shape == (m, 8) and got.numpy().tobytes() == want.tobytes()


def test_dispatch_on_cpu_tensors():
    u, w = _inputs(50, 4)
    ut, wt = torch.as_tensor(u), torch.as_tensor(w)
    before = ops.launch_counts()["histogram"]
    assert ops.histogram(ut, 8, wt, backend="torch").numpy().tobytes() == \
        ref.histogram(ut, 8, wt).numpy().tobytes()
    assert ops.launch_counts()["histogram"] == before  # the plain path launches nothing
    with pytest.raises(ValueError, match="CUDA"):
        ops.histogram(ut, 8, wt, backend="cuda")
