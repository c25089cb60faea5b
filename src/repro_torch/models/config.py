"""Architecture configuration — a copy of the JAX package's
``models/config.py`` (pure Python; the port imports nothing of ``repro``).

One `ModelConfig` describes any of the six family types; the port serves
all six (``repro_torch.configs``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # "dense" | "moe" | "ssm" | "hybrid" | "vlm" | "audio"
    n_layers: int
    d_model: int
    vocab_size: int
    # attention (unused for pure ssm)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    rope_mode: str = "1d"  # "1d" | "mrope"
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    sliding_window: int = 0  # 0 = full attention (training/prefill)
    # mlp
    d_ff: int = 0
    # moe
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # load-balance aux loss weight; computed on each model rank's token
    # shard and averaged (standard EP practice — differs from global-batch
    # statistics by O(1/shard) noise)
    moe_aux_coef: float = 0.01
    # ssm / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    hybrid_attn_every: int = 6  # hybrid: shared attn+mlp block cadence
    # enc-dec (audio)
    n_enc_layers: int = 0
    enc_frames_ratio: int = 2  # encoder frames = seq_len // ratio
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    # long-context policy for the long_500k shape:
    #   "native"          — sub-quadratic arch, run as-is
    #   "sliding_window"  — dense arch served with a ring-buffer window cache
    long_context: str = "sliding_window"
    long_context_window: int = 8192
    # source citation for the assigned-architecture pool
    source: str = ""

    # ---- derived ----
    def padded_vocab(self, tp: int) -> int:
        return -(-self.vocab_size // tp) * tp

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def is_moe(self) -> bool:
        return self.arch_type == "moe"

    @property
    def is_encoder_decoder(self) -> bool:
        return self.arch_type == "audio"

    def n_params(self) -> int:
        """Approximate logical parameter count (for 6ND model-flops)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        per_attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim \
            + self.n_heads * self.head_dim * d if self.has_attention else 0
        per_dense_mlp = 3 * d * self.d_ff if self.d_ff else 0
        per_moe = self.n_experts * 3 * d * self.moe_d_ff if self.is_moe else 0
        d_in = self.ssm_expand * d
        n_h = d_in // self.ssm_head_dim if self.ssm_state else 0
        per_ssm = (2 * d * d_in + 2 * d * self.ssm_state + d * n_h + d_in * d) if self.ssm_state else 0
        if self.arch_type in ("dense", "vlm"):
            total += self.n_layers * (per_attn + per_dense_mlp)
        elif self.arch_type == "moe":
            total += self.n_layers * (per_attn + per_moe)
        elif self.arch_type == "ssm":
            total += self.n_layers * per_ssm
        elif self.arch_type == "hybrid":
            total += self.n_layers * per_ssm + (per_attn + per_dense_mlp)  # shared block
        elif self.arch_type == "audio":
            total += (self.n_layers + self.n_enc_layers) * (per_attn + per_dense_mlp)
            total += self.n_layers * per_attn  # cross attention
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        per_attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim \
            + self.n_heads * self.head_dim * d
        per_moe_active = self.moe_top_k * 3 * d * self.moe_d_ff
        total = self.vocab_size * d + self.n_layers * (per_attn + per_moe_active)
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
