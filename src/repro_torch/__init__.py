"""SP-Join on PyTorch and CUDA: the port of the JAX package ``repro``.

Same layout as ``repro`` (``core/``, ``kernels/``, ``data/``, and the LM
stack's ``models/``, ``configs/``, ``train/``, ``launch/``) with the same
module and function names; the JAX package stays the reference the port is
held against. Entry points: ``repro_torch.core.spjoin.join``;
``repro_torch.launch.serve`` for serving.
"""
