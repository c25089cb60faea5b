"""yi-6b — llama-architecture dense GQA decoder. [arXiv:2403.04652]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    vocab_size=64_000,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11_008,
    rope_theta=5_000_000.0,
    long_context="sliding_window",
    source="arXiv:2403.04652",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-smoke", arch_type="dense", n_layers=2, d_model=256,
        vocab_size=1024, n_heads=8, n_kv_heads=4, head_dim=32, d_ff=512,
        source=CONFIG.source,
    )
