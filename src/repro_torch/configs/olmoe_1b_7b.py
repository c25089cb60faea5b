"""olmoe-1b-7b — 64-expert top-8 MoE decoder. [arXiv:2409.02060]

Served on one H100 at full width and depth (6.82 G parameters, 27.3 GB of
f32 rest weights)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    n_layers=16,
    d_model=2048,
    vocab_size=50_304,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    n_experts=64,
    moe_top_k=8,
    moe_d_ff=1024,
    long_context="sliding_window",
    source="arXiv:2409.02060",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke", arch_type="moe", n_layers=2, d_model=256,
        vocab_size=1024, n_heads=8, n_kv_heads=8, head_dim=32,
        n_experts=4, moe_top_k=2, moe_d_ff=128, source=CONFIG.source,
    )
