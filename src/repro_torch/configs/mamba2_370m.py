"""mamba2-370m — attention-free SSD (state-space duality) decoder.
[arXiv:2405.21060]

Served on one H100 at full width and depth (367.6 M parameters)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    vocab_size=50_280,
    d_ff=0,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    long_context="native",
    source="arXiv:2405.21060",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", arch_type="ssm", n_layers=2, d_model=256,
        vocab_size=1024, ssm_state=16, ssm_head_dim=32, ssm_chunk=32,
        long_context="native", source=CONFIG.source,
    )
