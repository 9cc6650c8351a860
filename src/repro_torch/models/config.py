"""Architecture configuration: one dataclass covers the whole assigned zoo.

Families:
  dense   — standard decoder (stablelm / granite / phi3 / qwen1.5)
  moe     — mixture-of-experts decoder (llama4-scout / deepseek-moe)
  ssm     — xLSTM (mLSTM + sLSTM blocks)
  hybrid  — Mamba2 backbone + weight-shared attention blocks (zamba2)
  audio   — encoder-only transformer over frame embeddings (hubert)
  vlm     — decoder with prepended patch embeddings (llava-next)

The JAX package's ``repro.models.config``, copied (the port imports nothing
of it): the same dataclasses, fields, defaults and skip rules.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    # --- attention/MLP details ---
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 10_000.0
    causal: bool = True  # False for encoder-only (hubert)
    logit_softcap: float | None = None
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    first_layer_dense: bool = False  # deepseek-moe layer 0 is dense
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    shared_attn_every: int = 0  # zamba2: shared attn block period (0 = none)
    slstm_every: int = 0  # xlstm: every n-th block is sLSTM (0 = none)
    # --- modality frontends (stubs) ---
    frontend: str | None = None  # "audio_frames" | "vision_patches"
    frontend_dim: int = 0  # stub embedding dim
    n_patches: int = 0  # vlm: patch positions prepended
    # --- numerics ---
    param_dtype: str = "float32"
    act_dtype: str = "bfloat16"
    # --- scan/remat ---
    scan_layers: bool = True
    remat: str = "full"  # full | dots | none
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM/hybrid state-based.)"""
        return self.family in ("ssm", "hybrid")

    @property
    def n_params_active(self) -> tuple[int, int]:
        """(total, active) parameter estimate — feeds MODEL_FLOPS = 6·N·D."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d

        def mlp_params(dff: int) -> int:
            return d * dff * (3 if self.mlp_kind == "swiglu" else 2)

        if self.family == "moe":
            per_expert = mlp_params(self.d_ff_expert)
            shared = self.n_shared_experts * per_expert + (
                mlp_params(self.d_ff) if self.d_ff else 0
            )
            total_mlp = self.n_experts * per_expert + shared
            active_mlp = self.top_k * per_expert + shared
            n_moe = L - (1 if self.first_layer_dense else 0)
            dense_ff = mlp_params(self.d_ff or 4 * d) if self.first_layer_dense else 0
            total = emb + L * attn + n_moe * total_mlp + dense_ff
            active = emb + L * attn + n_moe * active_mlp + dense_ff
            return total, active
        if self.family == "ssm":  # xlstm: in/out proj + gates, no external FFN
            d_in = self.ssm_expand * d
            per = 2 * d * d_in + 4 * d_in * (d_in // max(self.n_heads, 1))
            total = emb + L * per
            return total, total
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            per = d * (2 * d_in + 2 * self.ssm_state + nheads) + d_in * d
            shared = attn + mlp_params(self.d_ff)
            total = emb + L * per + shared
            return total, total
        total = emb + L * (attn + mlp_params(self.d_ff))
        return total, total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The assignment's skip rules. Returns (runnable, reason_if_not)."""
    if arch.is_encoder and shape.kind in ("decode",):
        return False, "encoder-only arch has no autoregressive decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
