"""xlstm-1.3b [ssm]: 48 blocks d_model=2048 4H vocab=50304, d_ff=0 (all
projections live inside the blocks) [arXiv:2405.04517]. Ratio 7 mLSTM :
1 sLSTM (groups of 8). Matrix-memory state -> O(1) decode, runs long_500k.
"""
import dataclasses
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, ssm_expand=2, slstm_every=8,
)

def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        vocab=128, slstm_every=2,
    )
