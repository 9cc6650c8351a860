"""Fixture: public backend= ops that miss legs of the triad."""
from repro_torch.kernels import pairdist as _pairdist
from repro_torch.kernels import ref


def resolve_backend(backend, metric, x):
    return "torch" if backend == "auto" else backend


def pairdist(x, y, metric="l2", *, backend="auto"):  # expect: dispatch-triad
    if resolve_backend(backend, metric, x) == "torch":
        return ref.pairdist(x, y, metric)
    return x @ y.T  # no CUDA wrapper


def pairdist_mask(x, y, delta, metric="l2", *, backend="auto"):  # expect: dispatch-triad
    return _pairdist.pairdist_cuda(x, y, metric, delta)  # no oracle, no dispatch
