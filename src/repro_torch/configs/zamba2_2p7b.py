"""zamba2-2.7b [hybrid]: Mamba2 backbone + weight-shared attention blocks.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]. Shared attention applied every 6 Mamba2 layers
(9 applications of ONE weight-tied block, zamba2's defining trick).
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    shared_attn_every=6, mlp_kind="swiglu",
)

def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=128, ssm_state=8, ssm_head_dim=16, shared_attn_every=2,
        attn_q_chunk=32, attn_kv_chunk=32,
    )
