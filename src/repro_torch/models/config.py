"""Architecture configuration — a copy of the JAX package's
``models/config.py`` (pure Python; the port imports nothing of ``repro``).

One `ModelConfig` describes any of the six family types; this slice of the
port serves the dense family (``repro_torch.configs``: the paper's GPT
models).
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
