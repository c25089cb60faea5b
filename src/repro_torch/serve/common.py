"""Shared serve-engine setup: model config (registry name or ModelConfig),
mesh, QSDP engine, ring-sized DecodeSpec, ServeEngine and the prompt batch,
built the same way for every entry point.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no CUDA device and no device given they raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import configs
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
                    gen: int, *, rowquant_mlp: bool = False,
                    batch_sharded: Optional[bool] = None) -> DecodeSpec:
    if batch_sharded is None:
        batch_sharded = batch % ms.fsdp_size == 0
    return DecodeSpec(cache_len=decode_cache_len(cfg, prompt_len, gen, ms.model_size),
                      batch_global=batch, batch_sharded=batch_sharded,
                      rowquant_mlp=rowquant_mlp)


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
                      seed: int = 0, rowquant_mlp: bool = False,
                      batch_sharded: Optional[bool] = None,
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
    spec = make_serve_spec(cfg, ms, batch, prompt_len, gen, rowquant_mlp=rowquant_mlp,
                           batch_sharded=batch_sharded)
    return ServeSetup(cfg=cfg, model=model, params=params, ms=ms, spec=spec,
                      engine=ServeEngine(model, spec, device), device=device)


def make_prompt_batch(cfg: ModelConfig, spec: DecodeSpec, ms: MeshSpec,
                      tokens, device) -> dict:
    """The prefill batch {"tokens": (B, S) int64} on `device` (dense family:
    no modality stubs)."""
    return {"tokens": torch.as_tensor(tokens, dtype=torch.int64).to(device)}
