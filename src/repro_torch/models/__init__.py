"""Model zoo (the port of ``repro.models``).

  base         — ParamDef system (init on a torch.Generator, meta tensors)
  config       — ArchConfig / ShapeConfig / skip rules
  layers       — norms, RoPE, MLP, embeddings
  attention    — chunked (flash-style) GQA + cached decode
  moe          — capacity-dispatch mixture of experts
  ssm          — chunked linear recurrence, Mamba2
  xlstm        — mLSTM, sLSTM
  transformer  — assembly: forward / init_state / decode_step, Transformer
"""
from repro_torch.models import attention, base, config, layers, moe, ssm, transformer, xlstm  # noqa: F401
