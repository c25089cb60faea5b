"""Serving paths of the dense family: whole-prompt prefill (builds the KV
ring) and one-token greedy decode, wired through the QSDP engine.

FSDP serving: weights stay sharded at rest and are re-gathered — quantized —
layer by layer inside every prefill and decode step, so one decode step
runs the quantize kernel (K1) once per quantized tensor and the dequantize
kernel (K2) once per densely decoded one.  With
``DecodeSpec(rowquant_mlp=True)`` the decode MLP weights stay in wire-code
form and go through the rowquant kernel (K3) instead of K2.

Cache layout: KV (L, B, S_loc, n_kv, hd) bf16, a ring along S.  Python
loops take the place of the reference's ``lax.scan``, and the cache is
updated in place (the reference returns a new one).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import prng
from . import attention as attn_mod
from . import layers as L
from .transformer import Model

Params = dict[str, torch.Tensor]
Cache = dict[str, torch.Tensor]

# dense-MLP weights that may stay in wire-code form through swiglu_mlp
ROWQUANT_MLP = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Static decode-time configuration (the ring-cache greedy subset of
    the reference's DecodeSpec; paged KV, sampling and speculation come
    with ROADMAP A10)."""

    cache_len: int        # ring size
    batch_global: int
    batch_sharded: bool   # shard the batch over the FSDP axes?
    rowquant_mlp: bool = False


def make_decode_spec(model: Model, shape, rowquant_mlp: bool = False) -> DecodeSpec:
    """Decode configuration for a ShapeConfig."""
    cfg = model.cfg
    s = shape.seq_len
    cache_len = cfg.long_context_window if (
        s > 65536 and cfg.long_context == "sliding_window") else s
    return DecodeSpec(cache_len=cache_len, batch_global=shape.global_batch,
                      batch_sharded=shape.global_batch % model.ms.fsdp_size == 0,
                      rowquant_mlp=rowquant_mlp)


class DecodeModel:
    """Prefill / decode step functions for a bound Model."""

    def __init__(self, model: Model, spec: DecodeSpec):
        self.m = model
        self.spec = spec
        self.tp = model.ms.model_size
        if spec.cache_len % self.tp:
            raise ValueError(f"cache_len {spec.cache_len} must split over {self.tp} ranks")
        self.s_loc = spec.cache_len // self.tp
        self.b_loc = (spec.batch_global // model.ms.fsdp_size if spec.batch_sharded
                      else spec.batch_global)

    def cache_struct(self) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """Global cache shapes and dtypes."""
        cfg = self.m.cfg
        shp = (cfg.n_layers, self.spec.batch_global, self.spec.cache_len,
               self.m.acfg.n_kv, cfg.head_dim)
        return {"k": (shp, torch.bfloat16), "v": (shp, torch.bfloat16)}

    def init_cache_local(self, device) -> Cache:
        """This rank's zero cache: batch b_loc, ring S_loc."""
        out = {}
        for k, (shp, dt) in self.cache_struct().items():
            shp = list(shp)
            shp[1] = self.b_loc
            shp[2] //= self.tp
            out[k] = torch.zeros(shp, dtype=dt, device=device)
        return out

    # ------------------------------------------------------------------
    # Decode (one token)
    # ------------------------------------------------------------------

    def decode_fn(self, params: Params, cache: Cache, tokens: torch.Tensor,
                  pos: torch.Tensor, key: prng.Key) -> tuple[torch.Tensor, Cache]:
        """tokens (B,) current input; pos (B,) its per-slot position (< 0 =
        dead lane).  Returns (next tokens (B,), cache updated in place)."""
        m, cfg = self.m, self.m.cfg
        pos = pos.expand(tokens.shape) if pos.ndim == 0 else pos
        emb = m.engine.gather("embed", params["embed"], key)
        x = L.embed_vocab_parallel(tokens[:, None], emb)[:, 0]
        cos, sin = L.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
        x = self._decode_attn_stack(params, "layers", x, cache, pos, cos, sin, key)
        fn = m.engine.gather("final_norm", params["final_norm"], key)
        x = L.rms_norm(x, fn, cfg.norm_eps)
        head = emb if cfg.tie_embeddings else m.engine.gather("lm_head", params["lm_head"], key)
        logits = L.vocab_parallel_logits(x, head)
        return self._sample(logits, head.shape[0]), cache

    def _sample(self, logits: torch.Tensor, v_local: int) -> torch.Tensor:
        """Greedy next token (sampling: ROADMAP A10)."""
        return L.greedy_sample_vocab_parallel(logits, v_local)

    def _write_token_kv(self, kc_all, vc_all, layer: int, k1, v1, pos) -> None:
        """Write this token's KV at (layer, b, ring slot of pos[b]) in place;
        a dead lane (pos < 0) keeps its bytes."""
        s_loc = kc_all.shape[2]
        idx, is_mine = attn_mod.ring_slot(pos, self.spec.cache_len, s_loc)
        bi = torch.arange(k1.shape[0], device=k1.device)
        mine = (is_mine & attn_mod.slot_valid_mask(pos))[:, None, None]
        kc_all[layer, bi, idx] = torch.where(mine, k1.to(kc_all.dtype), kc_all[layer, bi, idx])
        vc_all[layer, bi, idx] = torch.where(mine, v1.to(vc_all.dtype), vc_all[layer, bi, idx])

    def _decode_attn_layer(self, x, w, kc_all, vc_all, layer: int, pos, cos, sin):
        m, cfg = self.m, self.m.cfg
        h = L.rms_norm(x, w["attn_norm"], cfg.norm_eps)
        q_all, k1, v1 = attn_mod.decode_new_kv(h, w, m.acfg, cos, sin)
        self._write_token_kv(kc_all, vc_all, layer, k1, v1, pos)
        o = attn_mod.decode_attend(q_all, kc_all[layer], vc_all[layer], m.acfg, pos,
                                   self.spec.cache_len)
        x = x + attn_mod.decode_out_proj(o, w, m.acfg, x.dtype)
        h = L.rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        return x + L.swiglu_mlp(h, w["w_gate"], w["w_up"], w["w_down"])

    def _gather_layer_w(self, prefix: str, names, lw: Params, lkey: prng.Key,
                        mlp=None) -> dict:
        """One layer's weights: one coalesced gather for the dense ones; with
        rowquant decode (mlp="dense") the MLP matmul weights come back as
        RowQuantWeights, gathered separately, that stay in code form."""
        m = self.m
        rq = [n for n in names
              if self.spec.rowquant_mlp and mlp == "dense" and n in ROWQUANT_MLP]
        out = m.engine.gather_layer(f"{prefix}/", {n: lw[n] for n in names if n not in rq},
                                    lkey)
        for n in rq:
            out[n] = m.engine.gather_rowquant(f"{prefix}/{n}", lw[n], lkey)
        return out

    def _decode_attn_stack(self, params, prefix, x, cache, pos, cos, sin, key):
        grp = self.m._group(params, prefix)
        names = list(grp)
        for idx in range(next(iter(grp.values())).shape[0]):
            lkey = prng.fold_in(key, idx)
            w = self._gather_layer_w(prefix, names, {n: grp[n][idx] for n in names},
                                     lkey, mlp="dense")
            x = self._decode_attn_layer(x, w, cache["k"], cache["v"], idx, pos, cos, sin)
        return x

    # ------------------------------------------------------------------
    # Prefill (build the cache from a whole prompt)
    # ------------------------------------------------------------------

    def prefill_fn(self, params: Params, batch: dict, key: prng.Key,
                   cache: Cache) -> tuple[torch.Tensor, Cache]:
        """batch {"tokens": (B, S)}; writes the prompt's KV into `cache` (a
        zero cache from :meth:`init_cache_local`) and returns (next tokens
        from the last position (B,), cache)."""
        m, cfg = self.m, self.m.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        if s > self.spec.cache_len:
            raise ValueError(f"prompt ({s}) exceeds the KV ring ({self.spec.cache_len})")
        emb = m.engine.gather("embed", params["embed"], key)
        x = L.embed_vocab_parallel(tokens, emb)
        positions = torch.arange(s, device=tokens.device)
        cos, sin = L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
        x = self._prefill_attn_stack(params, "layers", x, key, cos, sin, positions, cache)
        fn = m.engine.gather("final_norm", params["final_norm"], key)
        h = L.rms_norm(x[:, -1], fn, cfg.norm_eps)
        head = emb if cfg.tie_embeddings else m.engine.gather("lm_head", params["lm_head"], key)
        logits = L.vocab_parallel_logits(h, head)
        return self._sample(logits, head.shape[0]), cache

    def _slice_seq(self, kv: torch.Tensor, rank: int = 0) -> torch.Tensor:
        """(B, S, n_kv, hd) prompt KV -> this rank's S_loc ring chunk,
        zero-padded when the prompt is shorter than the ring."""
        pad = self.spec.cache_len - kv.shape[1]
        if pad:
            kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, pad))
        return kv[:, rank * self.s_loc:(rank + 1) * self.s_loc]

    def _prefill_attn_layer(self, x, w, cos, sin, positions):
        m, cfg = self.m, self.m.cfg
        h = L.rms_norm(x, w["attn_norm"], cfg.norm_eps)
        a, (kf, vf) = attn_mod.self_attention(h, w, m.acfg, cos, sin, positions,
                                              cache_slice=True)
        x = x + a
        h = L.rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        x = x + L.swiglu_mlp(h, w["w_gate"], w["w_up"], w["w_down"])
        return (x, self._slice_seq(kf).to(torch.bfloat16),
                self._slice_seq(vf).to(torch.bfloat16))

    def _prefill_attn_stack(self, params, prefix, x, key, cos, sin, positions, cache):
        grp = self.m._group(params, prefix)
        names = list(grp)
        for idx in range(next(iter(grp.values())).shape[0]):
            lkey = prng.fold_in(key, idx)
            # mlp=None: rowquant is a decode-only path, as in the reference
            w = self._gather_layer_w(prefix, names, {n: grp[n][idx] for n in names}, lkey)
            x, cache["k"][idx], cache["v"][idx] = self._prefill_attn_layer(
                x, w, cos, sin, positions)
        return x
