"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) expert
d_ff=8192 vocab=202048, 16 experts top-1 + 1 shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E]. Every layer is MoE (Scout's
interleave step = 1). 40 heads do not divide the 16-way model axis; the
flattened QKV projections shard and XLA re-shards the per-head compute —
flagged in EXPERIMENTS.md roofline notes.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab=202048,
    n_experts=16, top_k=1, n_shared_experts=1, d_ff_expert=8192,
    mlp_kind="swiglu",
)

def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        vocab=256, n_experts=4, top_k=1, n_shared_experts=1, d_ff_expert=64,
        attn_q_chunk=32, attn_kv_chunk=32,
    )
