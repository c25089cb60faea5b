"""qwen2.5-3b — dense GQA decoder with QKV bias.
[hf:Qwen/Qwen2.5-0.5B family card; 3B: 36L d_model=2048 16H kv=2 d_ff=11008]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    n_layers=36,
    d_model=2048,
    vocab_size=151_936,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    qkv_bias=True,
    d_ff=11_008,
    rope_theta=1_000_000.0,
    long_context="sliding_window",
    source="hf:Qwen/Qwen2.5-0.5B",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-smoke", arch_type="dense", n_layers=2, d_model=256,
        vocab_size=1024, n_heads=8, n_kv_heads=2, head_dim=32, qkv_bias=True,
        d_ff=512, source=CONFIG.source,
    )
