"""Shared serve-engine setup: model config (registry name or ModelConfig),
mesh, QSDP engine, ring-sized DecodeSpec, ServeEngine, the prompt batch and
the continuous scheduler, built the same way for every entry point.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no CUDA device and no device given they raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import configs
from ..core import prng
from ..core.qsdp import MeshSpec, QSDPConfig
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.decode import DecodeSpec
from ..models.transformer import Model
from .engine import ServeEngine


def decode_cache_len(cfg: ModelConfig, prompt_len: int, gen: int, tp: int) -> int:
    """KV ring for prompt_len + gen tokens, rounded up to a multiple of the
    model-axis size."""
    if cfg.arch_type == "ssm":
        return 0
    ring = prompt_len + gen
    return ring + (-ring) % tp


def make_serve_spec(cfg: ModelConfig, ms: MeshSpec, batch: int, prompt_len: int,
                    gen: int, *, sampling: bool = False, rowquant_mlp: bool = False,
                    batch_sharded: Optional[bool] = None, kv_block_size: int = 0,
                    kv_pool_blocks: int = 0, draft_bits: int = 0,
                    draft_depth: int = 0) -> DecodeSpec:
    """The DecodeSpec every serve entry point derives from (arch, shape).
    kv_block_size > 0 turns on the paged KV pool (chunked prefill only, an
    unsharded batch axis); kv_pool_blocks sizes it (0 = one full window per
    slot).  draft_bits + draft_depth > 1 turn on self-speculative decoding:
    a draft_bits-bit draft of the same weights drafts up to draft_depth
    tokens per slot per step, verified at serving precision.  The audio
    family's cross KV holds prompt_len // enc_frames_ratio encoder frames
    (at least one per model rank)."""
    if batch_sharded is None:
        batch_sharded = batch % ms.fsdp_size == 0 and not kv_block_size
    cache_len = decode_cache_len(cfg, prompt_len, gen, ms.model_size)
    if kv_block_size and cache_len:
        # the window tiles into whole blocks, each split over the model axis
        kv_block_size += (-kv_block_size) % ms.model_size
        cache_len += (-cache_len) % kv_block_size
    return DecodeSpec(cache_len=cache_len, batch_global=batch, batch_sharded=batch_sharded,
                      enc_len=(max(prompt_len // cfg.enc_frames_ratio, ms.model_size)
                               if cfg.arch_type == "audio" else 0),
                      rowquant_mlp=rowquant_mlp, sampling=sampling,
                      kv_block_size=kv_block_size if cache_len else 0,
                      kv_pool_blocks=kv_pool_blocks, draft_bits=draft_bits,
                      draft_depth=draft_depth)


@dataclasses.dataclass
class ServeSetup:
    """Everything a serve entry point needs, built identically everywhere."""

    cfg: ModelConfig
    model: Model
    params: dict
    ms: MeshSpec
    spec: DecodeSpec
    engine: ServeEngine
    device: torch.device


def build_serve_setup(arch, *, data_par: int = 1, model_par: int = 1,
                      smoke: bool = True, qsdp: Optional[QSDPConfig] = None,
                      batch: int = 8, prompt_len: int = 32, gen: int = 16,
                      seed: int = 0, sampling: bool = False, rowquant_mlp: bool = False,
                      batch_sharded: Optional[bool] = None, kv_block_size: int = 0,
                      kv_pool_blocks: int = 0, draft_bits: int = 0, draft_depth: int = 0,
                      params: Optional[dict] = None, device=None) -> ServeSetup:
    """Build (model, params, DecodeSpec, ServeEngine) for serving.  `arch` is
    a registry name (smoke or full config) or a ModelConfig; `params`
    (optional) are rest-layout weights, e.g. from
    ``weights.params_from_jax``; else they are drawn from `seed`."""
    device = resolve_device(device)
    ms = MeshSpec(axes=("data", "model"), shape=(data_par, model_par))
    if isinstance(arch, ModelConfig):
        cfg = arch
    else:
        cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    model = Model(cfg, ms, qsdp if qsdp is not None else QSDPConfig())
    if params is None:
        params = model.init_params(seed, device)
    spec = make_serve_spec(cfg, ms, batch, prompt_len, gen, sampling=sampling,
                           rowquant_mlp=rowquant_mlp, batch_sharded=batch_sharded,
                           kv_block_size=kv_block_size, kv_pool_blocks=kv_pool_blocks,
                           draft_bits=draft_bits, draft_depth=draft_depth)
    return ServeSetup(cfg=cfg, model=model, params=params, ms=ms, spec=spec,
                      engine=ServeEngine(model, spec, device), device=device)


def make_prompt_batch(cfg: ModelConfig, spec: DecodeSpec, ms: MeshSpec,
                      tokens, device, *, seed: int = 1) -> dict:
    """The prefill batch {"tokens": (B, S) int64} on `device`, with the
    reference's modality stubs (``serve/common.py:131-149``): VLM, zero
    "vision_embeds" (B, S, d) bf16, a false "vision_mask" and "positions"
    arange(S) in all three M-RoPE streams (3, B, S); audio, "audio_embeds"
    0.1 * ``jax.random.normal(PRNGKey(seed), (B, enc_len, d), bfloat16)``,
    drawn on the host with the threefry twin, byte-equal to the reference's
    draw."""
    tokens = torch.as_tensor(tokens, dtype=torch.int64)
    b, s = tokens.shape
    batch = {"tokens": tokens}
    if cfg.arch_type == "vlm":
        batch.update(vision_embeds=torch.zeros((b, s, cfg.d_model), dtype=torch.bfloat16),
                     vision_mask=torch.zeros((b, s), dtype=torch.bool),
                     positions=torch.arange(s).expand(3, b, s))
    if cfg.arch_type == "audio":
        z = prng.normal(prng.PRNGKey(seed), (b, spec.enc_len, cfg.d_model),
                        dtype=torch.bfloat16)
        batch["audio_embeds"] = torch.tensor(0.1, dtype=torch.bfloat16) * z
    return {k: v.to(device) for k, v in batch.items()}


def scheduler_batch_builder(cfg: ModelConfig, spec: DecodeSpec, ms: MeshSpec, device):
    """The ContinuousScheduler `batch_builder`: the batch-of-1 prefill batch
    of blocking admission, modality stubs included."""
    pf_spec = dataclasses.replace(spec, batch_global=1, batch_sharded=False)

    def build(tokens):
        return make_prompt_batch(cfg, pf_spec, ms, tokens, device)

    return build


def make_scheduler(setup: ServeSetup, *, gather_key=None, prefill_chunk: int = 0,
                   prefill_buckets: int = 4, prefill_interleave: int = 1,
                   kv_quant_bits: int = 0, kv_quant_horizon: int = 0,
                   kv_prefix_share: bool = True):
    """The ContinuousScheduler every serve entry point builds from a
    ServeSetup; the kv_quant_* knobs configure the paged pool's cold tier."""
    from .scheduler import ContinuousScheduler
    return ContinuousScheduler(
        setup.model, setup.spec, setup.params, setup.device, gather_key=gather_key,
        batch_builder=scheduler_batch_builder(setup.cfg, setup.spec, setup.ms, setup.device),
        prefill_chunk=prefill_chunk, prefill_buckets=prefill_buckets,
        prefill_interleave=prefill_interleave, kv_quant_bits=kv_quant_bits,
        kv_quant_horizon=kv_quant_horizon, kv_prefix_share=kv_prefix_share)
