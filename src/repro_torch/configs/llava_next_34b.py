"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 [hf:llava-hf/llava-v1.6 family]. The anyres vision tower is a
STUB: input_specs() supplies (B, 2304, 1024) precomputed patch embeddings
(4 anyres tiles x 576 patches) which are projected and prepended to the
token sequence; the LM loss covers text positions.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, mlp_kind="swiglu",
    frontend="vision_patches", frontend_dim=1024, n_patches=2304,
)

def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, frontend_dim=32, n_patches=8,
        attn_q_chunk=32, attn_kv_chunk=32,
    )
