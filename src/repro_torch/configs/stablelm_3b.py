"""stablelm-3b [dense]: 32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304
[hf:stabilityai/stablelm-2-1_6b family]. RoPE + SwiGLU decoder.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304, mlp_kind="swiglu",
)

def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=128, attn_q_chunk=32, attn_kv_chunk=32,
    )
