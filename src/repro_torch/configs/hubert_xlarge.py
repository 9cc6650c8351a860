"""hubert-xlarge [audio]: encoder-only transformer over frame embeddings.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 [arXiv:2106.07447].
The convolutional waveform frontend is a STUB: input_specs() supplies
precomputed (B, S, 512) frame features; the model projects + encodes +
classifies per frame (masked-prediction vocab of 504 clusters).
No decode shapes (encoder-only — see DESIGN.md §Arch-applicability).
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504, causal=False, mlp_kind="gelu",
    frontend="audio_frames", frontend_dim=512,
)

def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=64, frontend_dim=32, attn_q_chunk=32, attn_kv_chunk=32,
    )
