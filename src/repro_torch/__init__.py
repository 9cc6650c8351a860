"""SP-Join on PyTorch and CUDA: the port of the JAX package ``repro``.

Same layout as ``repro`` (``core/``, ``kernels/``, ``data/``) with the same
module and function names; the JAX package stays the reference the port is
held against. Entry point: ``repro_torch.core.spjoin.join``.
"""
