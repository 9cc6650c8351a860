"""Fixture: every public backend= op reaches the oracle, the CUDA wrapper
and the dispatch, directly or through a same-module op."""
from repro_torch.kernels import pairdist as _pairdist
from repro_torch.kernels import ref


def resolve_backend(backend, metric, x):
    return "torch" if backend == "auto" else backend


def pairdist_mask(x, y, delta, metric="l2", *, backend="auto"):
    if resolve_backend(backend, metric, x) == "torch":
        return ref.pairdist_mask(x, y, delta, metric)
    return _pairdist.pairdist_cuda(x, y, metric, delta)


def pairdist_count(x, y, delta, metric="l2", *, backend="auto"):
    return pairdist_mask(x, y, delta, metric, backend=backend).sum(1)


def _private(x, *, backend="auto"):
    return x
