"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) vocab=102400,
fine-grained MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408,
first layer dense (d_ff=10944) [arXiv:2401.06066].
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
    first_layer_dense=True, mlp_kind="swiglu",
)

def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, n_experts=8, top_k=2, n_shared_experts=2, d_ff_expert=32,
        attn_q_chunk=32, attn_kv_chunk=32,
    )
