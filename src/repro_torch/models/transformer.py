"""Model composition: parameter specs of the dense family and the bound
QSDP engine (the serve subset of the JAX package's ``models/transformer.py``;
the training forward comes with ROADMAP A5, the other families with A11).

Parameters live in the engine's rest layout, ``(stack?, 1, 1, n_local)`` on
the one-rank mesh, and are gathered per layer — quantized — inside every
prefill and decode step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.qsdp import MeshSpec, ParamSpec, QSDPConfig, QSDPEngine
from .attention import AttnConfig
from .config import ModelConfig

Params = dict[str, torch.Tensor]


def _attn_specs(d: int, a: AttnConfig, stack: Optional[int], bias: bool,
                out_scale: float) -> dict[str, ParamSpec]:
    hp = a.n_heads_padded * a.head_dim
    kvd = a.n_kv * a.head_dim
    kv_tp = a.kv_mode == "tp"
    s = {
        "wq": ParamSpec((d, hp), tp_axis=1, stack=stack, init="scaled_normal", init_scale=1.0),
        "wk": ParamSpec((d, kvd), tp_axis=1 if kv_tp else None, stack=stack,
                        init="scaled_normal", init_scale=1.0),
        "wv": ParamSpec((d, kvd), tp_axis=1 if kv_tp else None, stack=stack,
                        init="scaled_normal", init_scale=1.0),
        "wo": ParamSpec((hp, d), tp_axis=0, stack=stack, init="scaled_normal",
                        init_scale=out_scale),
    }
    if bias:
        s["bq"] = ParamSpec((hp,), tp_axis=0, stack=stack, init="zeros", quantize=False)
        s["bk"] = ParamSpec((kvd,), tp_axis=0 if kv_tp else None, stack=stack,
                            init="zeros", quantize=False)
        s["bv"] = ParamSpec((kvd,), tp_axis=0 if kv_tp else None, stack=stack,
                            init="zeros", quantize=False)
    return s


def _mlp_specs(d: int, ff: int, stack: Optional[int], out_scale: float) -> dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d, ff), tp_axis=1, stack=stack, init="scaled_normal", init_scale=1.0),
        "w_up": ParamSpec((d, ff), tp_axis=1, stack=stack, init="scaled_normal", init_scale=1.0),
        "w_down": ParamSpec((ff, d), tp_axis=0, stack=stack, init="scaled_normal",
                            init_scale=out_scale),
    }


def _norm_spec(d: int, stack: Optional[int]) -> ParamSpec:
    return ParamSpec((d,), tp_axis=None, stack=stack, init="ones", quantize=False)


class Model:
    """Binds ModelConfig + MeshSpec + QSDPConfig into the parameter layout
    and the QSDP engine that gathers it."""

    def __init__(self, cfg: ModelConfig, ms: MeshSpec, qcfg: QSDPConfig):
        if cfg.arch_type != "dense":
            raise NotImplementedError(
                f"arch_type {cfg.arch_type!r} is not ported yet (ROADMAP A11); "
                "this slice serves the dense family")
        self.cfg = cfg
        self.ms = ms
        self.qcfg = qcfg
        self.acfg = AttnConfig(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                               head_dim=cfg.head_dim, tp=ms.model_size, causal=True,
                               sliding_window=cfg.sliding_window,
                               mxu_bf16=qcfg.attn_bf16)
        self.vp = cfg.padded_vocab(ms.model_size)
        self.specs = self._build_specs()
        self.engine = QSDPEngine(ms, qcfg, self.specs)
        self.compute_dtype = self.engine.compute_dtype

    def _build_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        d, nl = cfg.d_model, cfg.n_layers
        out_scale = 1.0 / math.sqrt(2 * max(nl, 1))
        s = {"embed": ParamSpec((self.vp, d), tp_axis=0, init="normal", init_scale=0.02),
             "final_norm": _norm_spec(d, None)}
        if not cfg.tie_embeddings:
            s["lm_head"] = ParamSpec((self.vp, d), tp_axis=0, init="normal", init_scale=0.02)
        block = {**_attn_specs(d, self.acfg, nl, cfg.qkv_bias, out_scale),
                 **_mlp_specs(d, cfg.d_ff, nl, out_scale),
                 "attn_norm": _norm_spec(d, nl), "mlp_norm": _norm_spec(d, nl)}
        s.update({f"layers/{k}": v for k, v in block.items()})
        return s

    def init_params(self, seed: int, device) -> Params:
        return self.engine.init_params(seed, device)

    def _group(self, params: Params, prefix: str) -> Params:
        pl = len(prefix) + 1
        return {k[pl:]: v for k, v in params.items() if k.startswith(prefix + "/")}
