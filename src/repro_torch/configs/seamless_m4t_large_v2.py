"""seamless-m4t-large-v2 — audio encoder-decoder transformer backbone.
[arXiv:2308.11596]  The mel/conformer audio frontend is a stub, as in the
JAX package: the prompt batch carries frame embeddings.

Served on one H100 at full width and depth (2.04 G parameters, 8.1 GB of
f32 rest weights)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    n_layers=24,       # decoder
    n_enc_layers=24,   # speech encoder backbone
    d_model=1024,
    vocab_size=256_206,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    enc_frames_ratio=2,
    tie_embeddings=False,
    long_context="sliding_window",
    source="arXiv:2308.11596",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-smoke", arch_type="audio", n_layers=2, n_enc_layers=2,
        d_model=256, vocab_size=1024, n_heads=8, n_kv_heads=8, head_dim=32,
        d_ff=512, tie_embeddings=False, source=CONFIG.source,
    )
