"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064 [arXiv:2404.14219]. RoPE + SwiGLU + GQA.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, mlp_kind="swiglu",
)

def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=128, attn_q_chunk=32, attn_kv_chunk=32,
    )
