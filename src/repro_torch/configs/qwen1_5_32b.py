"""qwen1.5-32b — dense GQA decoder with QKV bias (40 heads: padded to 48 on
the 16-way model axis, padded heads hard-masked). [hf:Qwen/Qwen1.5-0.5B]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    vocab_size=152_064,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    qkv_bias=True,
    d_ff=27_392,
    rope_theta=1_000_000.0,
    long_context="sliding_window",
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-smoke", arch_type="dense", n_layers=2, d_model=320,
        vocab_size=1024, n_heads=10, n_kv_heads=10, head_dim=32, qkv_bias=True,
        d_ff=512, source=CONFIG.source,
    )
