"""Model composition: parameter specs of all six families, the bound QSDP
engine and the training forward of every family (the JAX package's
``models/transformer.py``).  Serving runs through ``models/decode.py``,
which shares the embedding (the VLM's vision splice and rotary tables
included) and the audio encoder with the training forward.

Parameters live in the engine's rest layout, each rank holding its block
``(stack?, 1, 1, n_local)``, and are gathered per layer — quantized — inside every
train, prefill and decode step.  Training checkpoints each layer with its
gather inside (``torch.utils.checkpoint``): the backward re-gathers the
layer from the same key, then reduce-scatters its gradient once — FSDP's
gather -> compute -> discard -> re-gather schedule.  Under
``QSDPConfig(remat_policy="dots")`` the checkpoint keeps the outputs of the
layer's 2-D matmuls and recomputes the rest (the reference's
``dots_with_no_batch_dims_saveable``); the gather still replays, since the
backward needs the weights.  A MoE layer's load-balance loss rides the
checkpointed body beside the activations and is summed over the layers in
layer order, in f32, onto the cross-entropy.

The hybrid family runs its Mamba2 stack in groups of ``hybrid_attn_every``
layers, each group followed by the shared attention+MLP block, and a tail
of the remaining layers; group g's layers are gathered under ``fold_in(
fold_in(key, 1000 + g), i)``, its shared-block invocation under
``fold_in(key, 1000 + g)``, tail layer j under ``fold_in(fold_in(key,
2000), j)``.  Every Mamba2 layer and every shared-block invocation is
checkpointed with its gather inside.  The reference also remats each group
as a whole around them; the port does not nest that checkpoint (the values
are the same, since a gather under a fixed key is deterministic; nesting
would gather every layer of a group three times a step instead of twice).
Under ``QSDPConfig(prefetch=True)`` every layer loop that gathers through
the engine pipelines its gathers (:meth:`Model._scan_layers`): the dense,
MoE, VLM and SSM stacks, the hybrid's groups and tail, the audio encoder
and decoder.
The shared block's gradient is the sum of one quantized reduce-scatter per
invocation, accumulated by autograd from the last invocation to the first,
as the reference's scan transpose does.

The audio family is an encoder-decoder: an encoder stack of non-causal
self-attention layers over the frame embeddings (its own parameter group
``enc/``, gathered under ``fold_in(fold_in(key, 3000), i)`` so that its
quantization keys never equal the decoder's, which shares its short names)
and ``enc_final_norm``; a decoder stack ``dec/`` whose layers add
cross-attention (``dec/x{wq,wk,wv,wo}``, no rotation, full mask) over the
encoder's output between self-attention and the MLP; and an untied
``lm_head``.  Both stacks are checkpointed layer by layer; the encoder's
output enters every checkpointed decoder body as an explicit input, so its
gradient, the sum of one cross-attention contribution per decoder layer,
flows back into the encoder under either remat policy.  The VLM family is
the dense stack with M-RoPE: three position streams (temporal, height,
width) rotate sections of the frequencies, and the batch's vision
embeddings replace the token embeddings where ``vision_mask`` is set.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core import prng
from ..core.qsdp import MeshSpec, ParamSpec, QSDPConfig, QSDPEngine
from . import attention as attn_mod
from . import layers as L
from .attention import AttnConfig
from .config import ModelConfig
from . import mamba as mamba_mod
from . import moe as moe_mod
from .mamba import MambaConfig
from .moe import MoEConfig

Params = dict[str, torch.Tensor]

# key folds of the stacks that share a parent key (the reference's
# models/transformer.py): hybrid group g gathers under GROUP_OFFSET + g, the
# hybrid tail under TAIL_OFFSET, the audio encoder under ENC_OFFSET
GROUP_OFFSET, TAIL_OFFSET, ENC_OFFSET = 1000, 2000, 3000


def _attn_specs(d: int, a: AttnConfig, stack: Optional[int], bias: bool,
                out_scale: float) -> dict[str, ParamSpec]:
    hp = a.n_heads_padded * a.head_dim
    kvd = a.n_kv * a.head_dim
    kv_tp = a.kv_mode == "tp"
    s = {
        "wq": ParamSpec((d, hp), tp_axis=1, stack=stack, init="scaled_normal", init_scale=1.0),
        "wk": ParamSpec((d, kvd), tp_axis=1 if kv_tp else None, stack=stack,
                        init="scaled_normal", init_scale=1.0, grad_sync_model=not kv_tp),
        "wv": ParamSpec((d, kvd), tp_axis=1 if kv_tp else None, stack=stack,
                        init="scaled_normal", init_scale=1.0, grad_sync_model=not kv_tp),
        "wo": ParamSpec((hp, d), tp_axis=0, stack=stack, init="scaled_normal",
                        init_scale=out_scale),
    }
    if bias:
        s["bq"] = ParamSpec((hp,), tp_axis=0, stack=stack, init="zeros", quantize=False)
        s["bk"] = ParamSpec((kvd,), tp_axis=0 if kv_tp else None, stack=stack,
                            init="zeros", quantize=False, grad_sync_model=not kv_tp)
        s["bv"] = ParamSpec((kvd,), tp_axis=0 if kv_tp else None, stack=stack,
                            init="zeros", quantize=False, grad_sync_model=not kv_tp)
    return s


def _mlp_specs(d: int, ff: int, stack: Optional[int], out_scale: float) -> dict[str, ParamSpec]:
    return {
        "w_gate": ParamSpec((d, ff), tp_axis=1, stack=stack, init="scaled_normal", init_scale=1.0),
        "w_up": ParamSpec((d, ff), tp_axis=1, stack=stack, init="scaled_normal", init_scale=1.0),
        "w_down": ParamSpec((ff, d), tp_axis=0, stack=stack, init="scaled_normal",
                            init_scale=out_scale),
    }


def _moe_specs(d: int, e: int, ffe: int, stack: Optional[int],
               out_scale: float) -> dict[str, ParamSpec]:
    """The router rides the layer's wire buffer unquantized (an fp segment);
    the expert stacks are sharded over the model axis on the expert axis."""
    return {
        "router": ParamSpec((d, e), tp_axis=None, stack=stack, init="scaled_normal",
                            init_scale=1.0, quantize=False),
        "w_gate": ParamSpec((e, d, ffe), tp_axis=0, stack=stack, init="scaled_normal",
                            init_scale=1.0),
        "w_up": ParamSpec((e, d, ffe), tp_axis=0, stack=stack, init="scaled_normal",
                          init_scale=1.0),
        "w_down": ParamSpec((e, ffe, d), tp_axis=0, stack=stack, init="scaled_normal",
                            init_scale=out_scale),
    }


def _mamba_specs(m: MambaConfig, stack: Optional[int], out_scale: float) -> dict[str, ParamSpec]:
    """The Mamba2 mixer's parameters, in the reference's order
    (``transformer.py:85``); the convs, A, dt bias, D and the norm ride the
    layer's wire buffer unquantized (fp segments)."""
    d, din, h, n, k = m.d_model, m.d_inner, m.n_heads, m.d_state, m.conv_k
    return {
        "w_z": ParamSpec((d, din), tp_axis=1, stack=stack, init="scaled_normal", init_scale=1.0),
        "w_x": ParamSpec((d, din), tp_axis=1, stack=stack, init="scaled_normal", init_scale=1.0),
        "w_bc": ParamSpec((d, 2 * n), tp_axis=None, stack=stack, init="scaled_normal",
                          init_scale=1.0, grad_sync_model=True),
        "w_dt": ParamSpec((d, h), tp_axis=1, stack=stack, init="scaled_normal", init_scale=1.0),
        "conv_x": ParamSpec((din, k), tp_axis=0, stack=stack, init="normal", init_scale=0.3,
                            quantize=False),
        "conv_bc": ParamSpec((2 * n, k), tp_axis=None, stack=stack, init="normal",
                             init_scale=0.3, quantize=False, grad_sync_model=True),
        "a_log": ParamSpec((h,), tp_axis=0, stack=stack, init="constant", init_scale=0.5,
                           quantize=False),
        "dt_bias": ParamSpec((h,), tp_axis=0, stack=stack, init="constant", init_scale=-4.0,
                             quantize=False),
        "d_skip": ParamSpec((h,), tp_axis=0, stack=stack, init="ones", quantize=False),
        "norm": ParamSpec((din,), tp_axis=0, stack=stack, init="ones", quantize=False),
        "w_out": ParamSpec((din, d), tp_axis=0, stack=stack, init="scaled_normal",
                           init_scale=out_scale),
    }


def _norm_spec(d: int, stack: Optional[int]) -> ParamSpec:
    return ParamSpec((d,), tp_axis=None, stack=stack, init="ones", quantize=False)


class Model:
    """Binds ModelConfig + MeshSpec + QSDPConfig into the parameter layout
    and the QSDP engine that gathers it."""

    def __init__(self, cfg: ModelConfig, ms: MeshSpec, qcfg: QSDPConfig, group=None,
                 model_group=None, model_rank: Optional[int] = None, pod_group=None,
                 inner_group=None):
        """`group` and `model_group`: the ``torch.distributed`` groups of this
        rank's data (FSDP) and model axes (None: one rank each; `model_rank`:
        see ``QSDPEngine``); on a pod mesh `pod_group` and `inner_group` the
        two-level exchanges' (``QSDPEngine``).  Above one rank only the dense
        family runs; the others are held to the JAX package at one rank only
        (ROADMAP A11h)."""
        n_ranks = ms.fsdp_size * ms.model_size
        if n_ranks > 1 and cfg.arch_type != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.arch_type} family over "
                f"{' x '.join(map(str, ms.shape))} ({' x '.join(ms.axes)}) ranks is not ported "
                "yet (ROADMAP A11h); the dense family runs over ranks")
        self.cfg = cfg
        self.ms = ms
        self.qcfg = qcfg
        if cfg.has_attention:
            self.acfg = AttnConfig(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                                   head_dim=cfg.head_dim, tp=ms.model_size, causal=True,
                                   sliding_window=cfg.sliding_window,
                                   mxu_bf16=qcfg.attn_bf16)
            # the audio encoder's self-attention sees every frame
            self.enc_acfg = dataclasses.replace(self.acfg, causal=False)
        if cfg.arch_type in ("ssm", "hybrid"):
            self.mcfg = MambaConfig(d_model=cfg.d_model, d_state=cfg.ssm_state,
                                    head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
                                    conv_k=cfg.ssm_conv, chunk=cfg.ssm_chunk,
                                    tp=ms.model_size)
        if cfg.is_moe:
            self.ecfg = MoEConfig(n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                                  d_model=cfg.d_model, d_ff=cfg.moe_d_ff, tp=ms.model_size,
                                  capacity_factor=cfg.moe_capacity_factor,
                                  aux_coef=cfg.moe_aux_coef)
        self.vp = cfg.padded_vocab(ms.model_size)
        self.specs = self._build_specs()
        self.engine = QSDPEngine(ms, qcfg, self.specs, group, model_group, model_rank,
                                 pod_group, inner_group)
        self.compute_dtype = self.engine.compute_dtype

    def _build_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        d, nl = cfg.d_model, cfg.n_layers
        out_scale = 1.0 / math.sqrt(2 * max(nl, 1))
        s = {"embed": ParamSpec((self.vp, d), tp_axis=0, init="normal", init_scale=0.02),
             "final_norm": _norm_spec(d, None)}
        if not cfg.tie_embeddings:
            s["lm_head"] = ParamSpec((self.vp, d), tp_axis=0, init="normal", init_scale=0.02)
        if cfg.arch_type in ("ssm", "hybrid"):
            s.update({f"layers/{k}": v for k, v in _mamba_specs(self.mcfg, nl, out_scale).items()})
            s["layers/pre_norm"] = _norm_spec(d, nl)
            if cfg.arch_type == "hybrid":
                # the shared transformer block, re-gathered at every invocation
                shared = {**_attn_specs(d, self.acfg, None, cfg.qkv_bias, out_scale),
                          **_mlp_specs(d, cfg.d_ff, None, out_scale),
                          "attn_norm": _norm_spec(d, None), "mlp_norm": _norm_spec(d, None)}
                s.update({f"shared/{k}": v for k, v in shared.items()})
            return s
        if cfg.arch_type == "audio":
            return self._encdec_specs(s, out_scale)
        mlp = (_moe_specs(d, cfg.n_experts, cfg.moe_d_ff, nl, out_scale) if cfg.is_moe
               else _mlp_specs(d, cfg.d_ff, nl, out_scale))
        block = {**_attn_specs(d, self.acfg, nl, cfg.qkv_bias, out_scale), **mlp,
                 "attn_norm": _norm_spec(d, nl), "mlp_norm": _norm_spec(d, nl)}
        s.update({f"layers/{k}": v for k, v in block.items()})
        return s

    def _encdec_specs(self, s: dict, out_scale: float) -> dict[str, ParamSpec]:
        """The audio family's groups after embed/final_norm/lm_head, in the
        reference's order (``transformer.py:192-203``): the encoder's
        attention, MLP and norms, ``enc_final_norm``, the decoder's
        self-attention and MLP, its cross-attention projections ``dec/x*``
        and its three norms."""
        cfg = self.cfg
        d, nl, ne = cfg.d_model, cfg.n_layers, cfg.n_enc_layers
        enc = {**_attn_specs(d, self.acfg, ne, cfg.qkv_bias, out_scale),
               **_mlp_specs(d, cfg.d_ff, ne, out_scale),
               "attn_norm": _norm_spec(d, ne), "mlp_norm": _norm_spec(d, ne)}
        s.update({f"enc/{k}": v for k, v in enc.items()})
        s["enc_final_norm"] = _norm_spec(d, None)
        dec = {**_attn_specs(d, self.acfg, nl, cfg.qkv_bias, out_scale),
               **_mlp_specs(d, cfg.d_ff, nl, out_scale),
               **{f"x{k}": v for k, v in _attn_specs(d, self.acfg, nl, cfg.qkv_bias,
                                                       out_scale).items()},
               "attn_norm": _norm_spec(d, nl), "xattn_norm": _norm_spec(d, nl),
               "mlp_norm": _norm_spec(d, nl)}
        s.update({f"dec/{k}": v for k, v in dec.items()})
        return s

    def init_params(self, seed: int, device) -> Params:
        return self.engine.init_params(seed, device)

    def _group(self, params: Params, prefix: str) -> Params:
        pl = len(prefix) + 1
        return {k[pl:]: v for k, v in params.items() if k.startswith(prefix + "/")}

    # -- training --------------------------------------------------------------

    def loss_fn(self, params: Params, batch: dict, key: prng.Key) -> torch.Tensor:
        """Mean token cross-entropy of one microbatch, {"tokens", "labels"}
        (B, S) with the family's modality inputs (VLM: "vision_embeds" (B, S,
        d), "vision_mask" (B, S), "positions" (3, B, S); audio:
        "audio_embeds" (B, S_enc, d)), plus the MoE layers' load-balance
        loss; every weight gathered quantized under `key`."""
        if self.cfg.arch_type == "audio":
            return self._loss_encdec(params, batch, key)
        emb, x, positions, cos, sin = self._embed(params, batch, key)
        x, aux = self._run_stack(params, x, key, cos, sin, positions)
        loss = self._head_loss(params, x, emb, batch["labels"], key)
        return loss if aux is None else loss + aux.to(loss.dtype)

    def _embed(self, params: Params, batch: dict, key: prng.Key):
        """(gathered embedding, x (B, S, d), positions arange(S), cos, sin)
        of the tokens: the VLM's vision embeddings, cast to the compute
        dtype, replace the token embeddings where ``vision_mask`` is set
        (reference ``transformer.py:241``); the rotary tables are M-RoPE's
        per-row ones where the model has M-RoPE.  The training forward and
        the prefill start here."""
        tokens = batch["tokens"]
        emb = self.engine.gather("embed", params["embed"], key)
        eng = self.engine
        x = L.embed_vocab_parallel(tokens, emb, eng.model_rank, eng.model_group)
        if self.cfg.arch_type == "vlm":
            x = torch.where(batch["vision_mask"][..., None],
                            batch["vision_embeds"].to(x.dtype), x)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        return (emb, x, positions) + self._rope(positions, batch)

    def _head_loss(self, params: Params, x, emb, labels, key: prng.Key) -> torch.Tensor:
        """``final_norm``, then the cross-entropy of the (tied or untied)
        head's logits against `labels` (B, S; negative labels masked)."""
        cfg, eng = self.cfg, self.engine
        x = L.rms_norm(x, eng.gather("final_norm", params["final_norm"], key), cfg.norm_eps)
        head = emb if cfg.tie_embeddings else eng.gather("lm_head", params["lm_head"], key)
        return L.vocab_parallel_xent(x.reshape(-1, x.shape[-1]), head, labels.reshape(-1),
                                     eng.model_rank, eng.model_group)

    def _loss_encdec(self, params: Params, batch: dict, key: prng.Key) -> torch.Tensor:
        """The audio family's loss (reference ``_loss_encdec``,
        ``transformer.py:426-453``): the encoder over ``batch["audio_embeds"]``
        (:meth:`_encode`), then the embedding and the decoder stack under
        `key`, every decoder layer cross-attending to the encoder's output,
        then the head."""
        mem = self._encode(params, batch["audio_embeds"], key)
        emb, x, positions, cos, sin = self._embed(params, batch, key)
        names, layers = self._unbind_stack(params, "dec")
        x = self._scan_layers("dec", names, layers, x, key, cos, sin, positions,
                              self._dec_layer, memory=mem)
        return self._head_loss(params, x, emb, batch["labels"], key)

    def _encode(self, params: Params, audio, key: prng.Key, layers=None, gather=None):
        """The audio encoder over the frame embeddings `audio` (B, S_enc, d),
        cast to the compute dtype: 1-D RoPE over the frames, non-causal
        layers, layer i gathered under ``fold_in(fold_in(key, 3000), i)``
        inside its checkpointed body; then ``enc_final_norm`` gathered under
        `key`.  The loss and the audio prefill both run it; the prefill
        passes its own `layers` ((names, per layer the tuple of its slices),
        wire-form slices included) and `gather` (see :meth:`_scan_layers`)."""
        cfg = self.cfg
        audio = audio.to(self.compute_dtype)
        pe = torch.arange(audio.shape[1], device=audio.device)
        cos, sin = L.rope_cos_sin(pe, cfg.head_dim, cfg.rope_theta)
        names, lws = self._unbind_stack(params, "enc") if layers is None else layers
        mem = self._scan_layers("enc", names, lws, audio, prng.fold_in(key, ENC_OFFSET), cos,
                                sin, pe, self._enc_layer, gather=gather)
        efn = self.engine.gather("enc_final_norm", params["enc_final_norm"], key)
        return L.rms_norm(mem, efn, cfg.norm_eps)

    def _rope(self, positions, batch: Optional[dict] = None):
        """(cos, sin) of the rotary embedding at `positions` (S,); M-RoPE
        reads the batch's three position streams ``batch["positions"]`` (3,
        B, S) instead and gives per-row (B, S, hd/2) tables; (None, None)
        for a model without attention."""
        cfg = self.cfg
        if not cfg.has_attention:
            return None, None
        if cfg.rope_mode == "mrope":
            return L.mrope_cos_sin(batch["positions"], cfg.head_dim, cfg.rope_theta,
                                   cfg.mrope_sections)
        return L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    def _run_stack(self, params, x, key, cos, sin, positions):
        """(x, summed aux loss) after the layer stack; aux is None but for
        the MoE family."""
        arch = self.cfg.arch_type
        if arch == "hybrid":
            return self._hybrid_stack(params, x, key, cos, sin, positions), None
        names, layers = self._unbind_stack(params, "layers")
        if arch == "moe":
            return self._scan_layers("layers", names, layers, x, key, cos, sin, positions,
                                     self._moe_layer, carry_aux=True)
        layer_fn = self._mamba_layer if arch == "ssm" else self._dense_layer
        return self._scan_layers("layers", names, layers, x, key, cos, sin, positions,
                                 layer_fn), None

    def _unbind_stack(self, params, prefix):
        """(sorted tensor names, per layer the tuple of its slices) of a
        stacked group.  A leaf given as a sequence of per-layer tensors (the
        train step's: each slice its own autograd leaf, so a layer's
        gradient lands in that slice's ``.grad`` and no copy of the whole
        stack is ever made) is taken as it is; a tensor is unbound."""
        grp = self._group(params, prefix)
        names = sorted(grp)
        return names, list(zip(*(grp[n] if isinstance(grp[n], (tuple, list))
                                 else grp[n].unbind(0) for n in names)))

    def _checkpoint(self, fn, *args):
        """``fn(*args)`` with its activations rematerialized in the backward
        (the gathers inside replay) under the remat policy; a plain call
        where autograd records nothing (the prefill)."""
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = dict(use_reentrant=False, preserve_rng_state=False)
        if self.qcfg.remat_policy == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _save_dots)
        return checkpoint(fn, *args, **kw)

    def stack_traversals(self, prefix: str) -> list[int]:
        """The lengths of the layer loops one forward pass runs over the
        stacked group `prefix`: the whole stack, but for the hybrid's
        groups of ``hybrid_attn_every`` layers and its tail."""
        cfg = self.cfg
        n = self.specs[next(k for k in self.specs if k.startswith(prefix + "/"))].stack
        if cfg.arch_type == "hybrid" and prefix == "layers":
            n_groups, rem = divmod(n, cfg.hybrid_attn_every)
            return [cfg.hybrid_attn_every] * n_groups + ([rem] if rem else [])
        return [n]

    def pipelined(self, prefix: str, n_layers: int) -> bool:
        """Does a loop over `n_layers` layers of the group `prefix` (through
        the engine's own gather) run the prefetch pipeline?  Where
        ``prefetch`` is set, the loop holds more than one layer and the
        group's layer gather is coalesced (``coalesce_max_bytes`` may veto
        it): the reference's condition (``transformer.py:307-309``)."""
        names = tuple(sorted(k for k in self.specs if k.startswith(prefix + "/")))
        return (self.qcfg.prefetch and n_layers > 1
                and self.engine.layer_coalesced(names))

    def _scan_layers(self, prefix, names, layers, x, key, cos, sin, positions, layer_fn,
                     carry_aux=False, memory=None, gather=None):
        """Run the layers `layers` (each a tuple of slices of `names`),
        gathering layer i's weights under ``fold_in(key, i)`` inside its
        checkpointed body (the reference's rematerialized scan), by
        ``gather(prefix, {name: slice}, key)`` (the engine's coalesced
        ``gather_layer`` unless given).  With `carry_aux` the body carries
        (x, aux), aux starting at an f32 zero; with `memory` (the audio
        encoder's output) every body takes it as an explicit input and hands
        it to ``layer_fn`` after `positions`.  Returns the carry.

        Where :meth:`pipelined` holds (and no `gather` is given) the loop is
        the reference's double-buffered pipeline: layer 0's gather starts
        before the loop (``engine.gather_layer_start``), and before layer i
        computes, layer i + 1's starts, outside layer i's checkpoint (on the
        card on the engine's side stream, so its K1 and all-gather can run
        beside layer i's compute).  The checkpointed body takes layer i's wire
        buffer as an input and decodes it (``engine.gather_layer_finish``),
        so the backward's replay decodes each layer again but encodes none.
        The reference's wrapped-around gather of layer 0 on the last layer,
        whose result it discards, is not issued (ROADMAP C5)."""
        eng = self.engine
        pipe = gather is None and self.pipelined(prefix, len(layers))
        if gather is None:
            def gather(pfx, w, lkey):
                return eng.gather_layer(f"{pfx}/", w, lkey)

        def body(x, aux, mem, idx, wire, *lw):
            w, lkey = dict(zip(names, lw)), prng.fold_in(key, idx)
            w = (gather(prefix, w, lkey) if wire is None
                 else eng.gather_layer_finish(f"{prefix}/", w, wire, lkey))
            extra = () if mem is None else (mem,)
            return layer_fn((x, aux) if carry_aux else x, w, cos, sin, positions, *extra)

        def start(i):
            if not pipe or i == len(layers):
                return None
            return eng.gather_layer_start(f"{prefix}/", dict(zip(names, layers[i])),
                                          prng.fold_in(key, i))

        carry = (x, torch.zeros((), dtype=torch.float32, device=x.device)) if carry_aux else x
        wire = start(0)
        for idx, lw in enumerate(layers):
            nxt = start(idx + 1)
            args = carry if carry_aux else (carry, None)
            carry = self._checkpoint(body, *args, memory, idx, wire, *lw)
            wire = nxt
        return carry

    def _hybrid_stack(self, params, x, key, cos, sin, positions):
        """n_layers // every groups of Mamba2 layers, each followed by the
        shared block, then the remaining layers as a tail."""
        every = self.cfg.hybrid_attn_every
        n_groups, rem = divmod(self.cfg.n_layers, every)
        names, layers = self._unbind_stack(params, "layers")
        shared = self._group(params, "shared")
        snames = sorted(shared)

        def shared_block(x, gkey, *sw):
            w = self.engine.gather_layer("shared/", dict(zip(snames, sw)), gkey)
            return self._dense_layer(x, w, cos, sin, positions)

        for g in range(n_groups):
            gkey = prng.fold_in(key, GROUP_OFFSET + g)
            x = self._scan_layers("layers", names, layers[g * every:(g + 1) * every], x, gkey,
                                  cos, sin, positions, self._mamba_layer)
            x = self._checkpoint(shared_block, x, gkey, *(shared[n] for n in snames))
        if rem:
            x = self._scan_layers("layers", names, layers[n_groups * every:], x,
                                  prng.fold_in(key, TAIL_OFFSET), cos, sin, positions,
                                  self._mamba_layer)
        return x

    def _dense_layer(self, x, w, cos, sin, positions):
        """One dense layer at this rank's model rank: its heads and its
        columns of the MLP, the partial outputs summed over the model group."""
        cfg, eng = self.cfg, self.engine
        h = L.rms_norm(x, w["attn_norm"], cfg.norm_eps)
        a, _ = attn_mod.self_attention(h, w, self.acfg, cos, sin, positions,
                                       rank=eng.model_rank, group=eng.model_group)
        x = x + a
        h = L.rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        return x + L.swiglu_mlp(h, w["w_gate"], w["w_up"], w["w_down"], eng.model_group)

    def _enc_layer(self, x, w, cos, sin, positions):
        """One audio encoder layer: non-causal self-attention, then the MLP."""
        cfg = self.cfg
        h = L.rms_norm(x, w["attn_norm"], cfg.norm_eps)
        a, _ = attn_mod.self_attention(h, w, self.enc_acfg, cos, sin, positions)
        x = x + a
        h = L.rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        return x + L.swiglu_mlp(h, w["w_gate"], w["w_up"], w["w_down"])

    def _dec_layer(self, x, w, cos, sin, positions, memory, cache_slice: bool = False):
        """One audio decoder layer over the encoder output `memory` (B,
        S_enc, d): causal self-attention, cross-attention, then the MLP.
        With `cache_slice`, returns (x, (k, v)) of the self-attention, for
        the prefill's KV ring."""
        cfg = self.cfg
        h = L.rms_norm(x, w["attn_norm"], cfg.norm_eps)
        a, kv = attn_mod.self_attention(h, w, self.acfg, cos, sin, positions,
                                        cache_slice=cache_slice)
        x = x + a
        h = L.rms_norm(x, w["xattn_norm"], cfg.norm_eps)
        xw = {"wq": w["xwq"], "wk": w["xwk"], "wv": w["xwv"], "wo": w["xwo"]}
        x = x + attn_mod.cross_attention(h, memory, xw, self.acfg)
        h = L.rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        x = x + L.swiglu_mlp(h, w["w_gate"], w["w_up"], w["w_down"])
        return (x, kv) if cache_slice else x

    def _moe_layer(self, carry, w, cos, sin, positions):
        x, aux = carry
        cfg = self.cfg
        h = L.rms_norm(x, w["attn_norm"], cfg.norm_eps)
        a, _ = attn_mod.self_attention(h, w, self.acfg, cos, sin, positions)
        x = x + a
        h = L.rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        b, s, d = h.shape
        moe_w = {k: w[k] for k in ("router", "w_gate", "w_up", "w_down")}
        y, a_l = moe_mod.moe_layer(h.reshape(b * s, d), moe_w, self.ecfg)
        return x + y.reshape(b, s, d), aux + a_l

    def _mamba_layer(self, x, w, cos, sin, positions):
        h = L.rms_norm(x, w["pre_norm"], self.cfg.norm_eps)
        mw = {k: v for k, v in w.items() if k != "pre_norm"}
        return x + mamba_mod.mamba2_block(h, mw, self.mcfg)


# the matmuls without batch dimensions (the projections, the dense MLP, the
# router), whose outputs remat "dots" keeps: jax.checkpoint_policies'
# dots_with_no_batch_dims_saveable
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE
