"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 [arXiv:2405.04324] — GPTBigCode-style code model: multi-query
attention, GELU MLP. The single KV head cannot split over the 16-way model
axis, so the decode KV cache shards its *sequence* dim instead (partial
softmax combined by SPMD psum) — see models/attention.py.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, mlp_kind="gelu",
)

def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab=128, attn_q_chunk=32, attn_kv_chunk=32,
    )
