"""Model composition: parameter specs of the dense family, the bound QSDP
engine and the training forward (the dense subset of the JAX package's
``models/transformer.py``; the other families come with ROADMAP A11).

Parameters live in the engine's rest layout, ``(stack?, 1, 1, n_local)`` on
the one-rank mesh, and are gathered per layer — quantized — inside every
train, prefill and decode step.  Training checkpoints each layer with its
gather inside (``torch.utils.checkpoint``): the backward re-gathers the
layer from the same key, then reduce-scatters its gradient once — FSDP's
gather -> compute -> discard -> re-gather schedule.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core import prng
from ..core.qsdp import MeshSpec, ParamSpec, QSDPConfig, QSDPEngine
from . import attention as attn_mod
from . import layers as L
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
                "the port runs the dense family")
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

    # -- training --------------------------------------------------------------

    def loss_fn(self, params: Params, batch: dict, key: prng.Key) -> torch.Tensor:
        """Mean token cross-entropy of one microbatch, {"tokens", "labels"}
        (B, S); every weight gathered quantized under `key`."""
        cfg, eng = self.cfg, self.engine
        tokens = batch["tokens"]
        b, s = tokens.shape
        emb = eng.gather("embed", params["embed"], key)
        x = L.embed_vocab_parallel(tokens, emb)
        positions = torch.arange(s, device=tokens.device)
        cos, sin = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        x = self._run_stack(params, x, key, cos, sin, positions)
        fn = eng.gather("final_norm", params["final_norm"], key)
        x = L.rms_norm(x, fn, cfg.norm_eps)
        head = emb if cfg.tie_embeddings else eng.gather("lm_head", params["lm_head"], key)
        return L.vocab_parallel_xent(x.reshape(b * s, -1), head,
                                     batch["labels"].reshape(b * s))

    def _run_stack(self, params, x, key, cos, sin, positions):
        return self._scan_layers(params, "layers", x, key, cos, sin, positions,
                                 self._dense_layer)

    def _scan_layers(self, params, prefix, x, key, cos, sin, positions, layer_fn):
        """Run a stacked layer group, gathering layer i's weights under
        ``fold_in(key, i)`` inside its checkpointed body (the reference's
        rematerialized scan, non-prefetch branch)."""
        eng = self.engine
        grp = self._group(params, prefix)
        names = sorted(grp)
        # one UnbindBackward per stack: a layer's gradient lands in its own
        # slice instead of a zero-padded copy of the whole stack
        slices = [grp[n].unbind(0) for n in names]

        def body(x, idx, *lw):
            w = eng.gather_layer(f"{prefix}/", dict(zip(names, lw)), prng.fold_in(key, idx))
            return layer_fn(x, w, cos, sin, positions)

        for idx in range(len(slices[0])):
            x = checkpoint(body, x, idx, *[sl[idx] for sl in slices], use_reentrant=False,
                           preserve_rng_state=False)
        return x

    def _dense_layer(self, x, w, cos, sin, positions):
        cfg = self.cfg
        h = L.rms_norm(x, w["attn_norm"], cfg.norm_eps)
        a, _ = attn_mod.self_attention(h, w, self.acfg, cos, sin, positions)
        x = x + a
        h = L.rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        return x + L.swiglu_mlp(h, w["w_gate"], w["w_up"], w["w_down"])
