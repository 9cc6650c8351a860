"""Fixture: core/ reaches the kernels only through ops and ref."""
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

USED = (ops, kref)
