"""qwen3-moe-235b-a22b — 128-expert top-8 MoE decoder.
[hf:Qwen/Qwen3-30B-A3B family card]

Registered for its smoke config: GQA (2 KV heads) under MoE.  The full
config (94 layers, 128 experts, ~235 G parameters) does not fit one H100
and is never built on the card."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    n_layers=94,
    d_model=4096,
    vocab_size=151_936,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    n_experts=128,
    moe_top_k=8,
    moe_d_ff=1536,
    rope_theta=1_000_000.0,
    long_context="sliding_window",
    source="hf:Qwen/Qwen3-30B-A3B",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", arch_type="moe", n_layers=2, d_model=256,
        vocab_size=1024, n_heads=8, n_kv_heads=2, head_dim=32,
        n_experts=4, moe_top_k=2, moe_d_ff=128, source=CONFIG.source,
    )
