"""qwen2-vl-72b — VLM language backbone with M-RoPE and dynamic-resolution
vision input. [arXiv:2409.12191]  The ViT tower is a stub, as in the JAX
package: the prompt batch carries patch embeddings, a vision mask and the
three M-RoPE position streams.

71.46 G parameters, 286 GB of f32 rest weights: one H100 serves it at full
width cut to 16 of its 80 layers (15.29 G parameters, 61.2 GB)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    vocab_size=152_064,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    qkv_bias=True,
    d_ff=29_568,
    rope_mode="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    long_context="sliding_window",
    source="arXiv:2409.12191",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", arch_type="vlm", n_layers=2, d_model=256,
        vocab_size=1024, n_heads=8, n_kv_heads=2, head_dim=32, qkv_bias=True,
        d_ff=512, rope_mode="mrope", mrope_sections=(8, 4, 4),
        source=CONFIG.source,
    )
