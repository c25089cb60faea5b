"""yi-34b — llama-architecture dense GQA decoder (56 heads: padded to 64 on
the 16-way model axis). [arXiv:2403.04652]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    arch_type="dense",
    n_layers=60,
    d_model=7168,
    vocab_size=64_000,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    rope_theta=5_000_000.0,
    long_context="sliding_window",
    source="arXiv:2403.04652",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke", arch_type="dense", n_layers=2, d_model=448,
        vocab_size=1024, n_heads=14, n_kv_heads=2, head_dim=32, d_ff=512,
        source=CONFIG.source,
    )
