"""gpt-350m — the paper's mid GPT pretraining target (Table 1)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt-350m",
    arch_type="dense",
    n_layers=24,
    d_model=1024,
    vocab_size=50_304,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    rope_theta=10_000.0,
    source="Radford et al. 2018; Mos [2022] MosaicML LLM examples",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gpt-350m-smoke", arch_type="dense", n_layers=2, d_model=256,
        vocab_size=1024, n_heads=8, n_kv_heads=8, head_dim=32, d_ff=512,
        rope_theta=10_000.0, source=CONFIG.source,
    )
