"""gpt-125m — the paper's smallest GPT-2 pretraining target (Table 1).
Implemented on this repo's decoder substrate (RMSNorm/SwiGLU/RoPE); the
QSDP claims being validated concern communication + quantization, which are
block-agnostic (DESIGN.md §1)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt-125m",
    arch_type="dense",
    n_layers=12,
    d_model=768,
    vocab_size=50_304,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    rope_theta=10_000.0,
    source="Radford et al. 2018; Mos [2022] MosaicML LLM examples",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gpt-125m-smoke", arch_type="dense", n_layers=2, d_model=256,
        vocab_size=1024, n_heads=8, n_kv_heads=8, head_dim=32, d_ff=512,
        rope_theta=10_000.0, source=CONFIG.source,
    )
