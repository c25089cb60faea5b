"""zamba2-7b — hybrid Mamba2 backbone with a shared attention+MLP block
invoked every 6 Mamba blocks (the shared block's params are FSDP-sharded
once and re-gathered, quantized, at every invocation). [arXiv:2411.15242]

Served on one H100 at full width and depth (6.63 G parameters, 24.7 GiB of
f32 rest weights)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    vocab_size=32_000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14_336,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    hybrid_attn_every=6,
    # long-context policy applies to the *shared attention block* only (the
    # Mamba2 state is O(1) natively); its KV ring uses the sliding window.
    long_context="sliding_window",
    source="arXiv:2411.15242",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", arch_type="hybrid", n_layers=3, d_model=256,
        vocab_size=1024, n_heads=8, n_kv_heads=8, head_dim=32, d_ff=512,
        ssm_state=16, ssm_head_dim=32, ssm_chunk=32, hybrid_attn_every=2,
        long_context="native", source=CONFIG.source,
    )
