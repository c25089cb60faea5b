"""gpt-1.3b — the paper's largest GPT pretraining target (Table 1, Figure 3:
2.2x end-to-end speedup at 10 Gbps)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt-1.3b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    vocab_size=50_304,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    rope_theta=10_000.0,
    source="Radford et al. 2018; Mos [2022] MosaicML LLM examples",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gpt-1.3b-smoke", arch_type="dense", n_layers=2, d_model=256,
        vocab_size=1024, n_heads=8, n_kv_heads=8, head_dim=32, d_ff=512,
        rope_theta=10_000.0, source=CONFIG.source,
    )
