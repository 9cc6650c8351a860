"""Fixture: the kernels' binding layer reached from core/."""
import ctypes  # expect: kernel-confined

from repro_torch.kernels import ops, pairdist  # expect: kernel-confined
from repro_torch.kernels._build import check  # expect: kernel-confined

USED = (ctypes, ops, pairdist, check)
