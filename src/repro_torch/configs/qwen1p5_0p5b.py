"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936 [hf:Qwen/Qwen1.5-0.5B]. QKV bias + tied embeddings — the huge
vocabulary dominates this model's FLOPs/bytes at small d_model.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936, qkv_bias=True, tie_embeddings=True,
    mlp_kind="swiglu",
)

def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, attn_q_chunk=32, attn_kv_chunk=32,
    )
