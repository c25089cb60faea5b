"""Serving paths of the dense family: whole-prompt prefill (builds the KV
ring), chunked prefill over the whole slot pool, and one-token decode with
greedy or per-request sampling, over a private KV ring per slot or a paged
pool of KV blocks; wired through the QSDP engine.

FSDP serving: weights stay sharded at rest and are re-gathered — quantized —
layer by layer inside every prefill and decode step, so one step runs the
quantize kernel (K1) once per quantized tensor and the dequantize kernel
(K2) once per gathered buffer.  With ``DecodeSpec(rowquant_mlp=True)`` the
decode MLP weights stay in wire-code form and go through the rowquant
kernel (K3) instead of K2.  Sampled rows draw their Gumbel noise with
``kernels.ops.random_bits``.

Cache layout: KV (L, B, S_loc, n_kv, hd) bf16, a ring along S; paged, (L, R,
S_row, n_kv, hd) with R pool rows read as blocks through per-slot block
tables.  Python loops take the place of the reference's ``lax.scan``, and
the cache is updated in place (the reference returns a new one).  PyTorch
has no drop-mode scatter: the KV writes of the paged and chunked paths
index only the targets that are kept (live lanes, valid chunk tokens,
allocated blocks), found on the host once per call from the host-side
positions and tables, and every layer writes through that one index.

Control tensors (positions, chunk offsets and lengths, block tables, the
``sample`` tree) live on the host, where the scheduler keeps them; the
functions move what the device math needs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import prng
from . import attention as attn_mod
from . import layers as L
from .transformer import Model

Params = dict[str, torch.Tensor]
Cache = dict[str, torch.Tensor]

# dense-MLP weights that may stay in wire-code form through swiglu_mlp
ROWQUANT_MLP = ("w_gate", "w_up", "w_down")

# families whose prompts may prefill chunk-at-a-time into the pool cache
# (the reference's pure attention stacks; the port has the dense family)
CHUNKED_PREFILL_ARCHS = ("dense", "moe")


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Static decode-time configuration (the reference's DecodeSpec less the
    encoder length of the audio family)."""

    cache_len: int        # ring size (the logical window of a slot)
    batch_global: int
    batch_sharded: bool   # shard the batch over the FSDP axes?
    rowquant_mlp: bool = False
    # per-slot sampling: decode/prefill take a `sample` tree of per-slot
    # (temp, top_k, key); rows at temp <= 0 or top_k == 1 stay greedy
    sampling: bool = False
    # paged KV pool (serve/kv_pool.py): blocks of kv_block_size tokens
    # addressed through per-slot block tables; 0 = one private ring per slot
    kv_block_size: int = 0
    # physical blocks (0 = batch_global * cache_len // kv_block_size),
    # rounded up to whole pool rows
    kv_pool_blocks: int = 0
    # self-speculative decoding: not ported yet (ROADMAP A10c)
    draft_bits: int = 0
    draft_depth: int = 0

    @property
    def paged(self) -> bool:
        return self.kv_block_size > 0

    @property
    def speculative(self) -> bool:
        return self.draft_depth > 1 and self.draft_bits > 0

    @property
    def blocks_per_slot(self) -> int:
        """Logical blocks per slot ring (== physical blocks per pool row)."""
        return self.cache_len // self.kv_block_size

    def pool_rows(self) -> int:
        if not self.paged:
            return self.batch_global
        want = self.kv_pool_blocks or self.batch_global * self.blocks_per_slot
        return -(-want // self.blocks_per_slot)

    def pool_blocks(self) -> int:
        """Physical blocks actually materialized (whole rows)."""
        return self.pool_rows() * self.blocks_per_slot


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
        if spec.speculative:
            raise NotImplementedError(
                f"speculative decode (draft_bits={spec.draft_bits}, draft_depth="
                f"{spec.draft_depth}) is not ported yet (ROADMAP A10c)")
        if spec.paged:
            if spec.batch_sharded:
                raise ValueError("paged KV requires batch_sharded=False: block tables "
                                 "may point any lane at any pool row")
            if spec.kv_block_size % self.tp:
                raise ValueError(f"kv_block_size ({spec.kv_block_size}) must be a "
                                 f"multiple of the model-axis size ({self.tp})")
            if spec.cache_len % spec.kv_block_size:
                raise ValueError(f"cache_len ({spec.cache_len}) must be a multiple of "
                                 f"kv_block_size ({spec.kv_block_size})")
        self.s_loc = spec.cache_len // self.tp
        self.b_loc = (spec.batch_global // model.ms.fsdp_size if spec.batch_sharded
                      else spec.batch_global)

    def cache_struct(self) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """Global cache shapes and dtypes."""
        cfg = self.m.cfg
        shp = (cfg.n_layers, self.spec.pool_rows(), self.spec.cache_len,
               self.m.acfg.n_kv, cfg.head_dim)
        return {"k": (shp, torch.bfloat16), "v": (shp, torch.bfloat16)}

    def init_cache_local(self, device) -> Cache:
        """This rank's zero cache: batch b_loc (paged: all pool rows), ring
        S_loc."""
        out = {}
        for k, (shp, dt) in self.cache_struct().items():
            shp = list(shp)
            if not self.spec.paged:
                shp[1] = self.b_loc
            shp[2] //= self.tp
            out[k] = torch.zeros(shp, dtype=dt, device=device)
        return out

    # ------------------------------------------------------------------
    # Decode (one token)
    # ------------------------------------------------------------------

    def decode_fn(self, params: Params, cache: Cache, tokens: torch.Tensor,
                  pos: torch.Tensor, key: prng.Key, sample: Optional[dict] = None,
                  block_tables: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, Cache]:
        """tokens (B,) current input; pos (B,) its per-slot position (< 0 =
        dead lane: no KV write, nothing valid to attend, greedy).  `sample`
        (iff ``spec.sampling``): host tensors {"temp": (B,) f32, "top_k":
        (B,) int, "key": (B, 2) u32 keys as int64}; the token produced at
        position pos + 1 is keyed by fold_in(slot key, pos + 1).  Paged
        specs take block_tables (B, blocks_per_slot) of physical block ids
        (-1: unallocated).  Returns (next tokens (B,), cache updated in
        place)."""
        m, cfg = self.m, self.m.cfg
        dev = cache["k"].device
        pos_in = torch.as_tensor(pos)
        if pos_in.ndim == 0:
            pos_in = pos_in.expand(tokens.shape)
        pos = pos_in.to(dev)
        if self.spec.paged and block_tables is None:
            raise ValueError("paged DecodeSpec: decode_fn needs block_tables")
        writes = bt = None
        if block_tables is not None:
            pos_h = pos_in.cpu()
            writes = self._paged_writes(pos_h, attn_mod.slot_valid_mask(pos_h),
                                        block_tables, dev)
            bt = block_tables.to(dev)
        emb = m.engine.gather("embed", params["embed"], key)
        x = L.embed_vocab_parallel(tokens.to(dev)[:, None], emb)[:, 0]
        cos, sin = L.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
        x = self._decode_attn_stack(params, "layers", x, cache, pos, cos, sin, key,
                                    writes, bt)
        fn = m.engine.gather("final_norm", params["final_norm"], key)
        x = L.rms_norm(x, fn, cfg.norm_eps)
        head = emb if cfg.tie_embeddings else m.engine.gather("lm_head", params["lm_head"], key)
        logits = L.vocab_parallel_logits(x, head)
        if sample is None:
            return self._sample(logits, head.shape[0]), cache
        pos_h = pos_in.cpu()
        return self._sample(logits, head.shape[0], sample, pos_h + 1,
                            attn_mod.slot_valid_mask(pos_h)), cache

    def _sample(self, logits: torch.Tensor, v_local: int, sample: Optional[dict] = None,
                n_consumed: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy argmax, or per-slot sampling keyed by fold_in(request key,
        n_consumed), the global position of the token being produced (the
        same for a request alone or interleaved).  Rows not `valid` (dead
        lanes) are clamped to temp 0 / top-k 1: the draw-free greedy path.
        The keys are folded on the host, one threefry block per row."""
        if sample is None:
            return L.greedy_sample_vocab_parallel(logits, v_local)
        temp, top_k = sample["temp"], sample["top_k"]
        if valid is not None:
            temp = torch.where(valid, temp, torch.zeros_like(temp))
            top_k = torch.where(valid, top_k, torch.ones_like(top_k))
        skeys = prng.fold_in_rows(sample["key"], n_consumed)
        return L.sample_vocab_parallel(logits, v_local, temp, top_k, skeys)

    def _paged_writes(self, pos_h: torch.Tensor, keep_h: torch.Tensor,
                      block_tables: torch.Tensor, dev) -> tuple:
        """The KV writes of positions pos_h (B,) or (B, Lq) into the paged
        pool, found on the host: (source index into the (B[, Lq]) k/v, pool
        rows, row seq indices) on `dev`, holding only the positions that
        `keep_h` keeps, this rank holds and whose block is allocated."""
        bl_loc = self.spec.kv_block_size // self.tp
        bt = block_tables.to(torch.int64).cpu()
        row, seq, mine = attn_mod.paged_slot(pos_h, self.spec.cache_len,
                                             self.spec.kv_block_size, bl_loc, bt)
        src = torch.nonzero(keep_h & mine & (row >= 0), as_tuple=True)
        return (tuple(i.to(dev) for i in src), row[src].to(dev), seq[src].to(dev))

    @staticmethod
    def _write_kv(kc_all, vc_all, layer: int, k1, v1, writes) -> None:
        """Write the kept k1/v1 rows (``writes`` from :meth:`_paged_writes`
        or :meth:`_ring_chunk_writes`) into layer `layer` in place: the
        reference's drop-mode scatters of the paged ``_write_token_kv`` and
        of ``_write_chunk_kv`` (``decode.py:359, 589``).  The targets are
        distinct (a slot's positions are distinct mod its window, and no two
        slots hold one writable block), so the order of the writes does not
        matter."""
        src, row, seq = writes
        kc_all[layer][row, seq] = k1[src].to(kc_all.dtype)
        vc_all[layer][row, seq] = v1[src].to(vc_all.dtype)

    def _write_token_kv(self, kc_all, vc_all, layer: int, k1, v1, pos) -> None:
        """Write this token's KV at (layer, b, ring slot of pos[b]) in place;
        a dead lane (pos < 0) keeps its bytes."""
        s_loc = kc_all.shape[2]
        idx, is_mine = attn_mod.ring_slot(pos, self.spec.cache_len, s_loc)
        bi = torch.arange(k1.shape[0], device=k1.device)
        mine = (is_mine & attn_mod.slot_valid_mask(pos))[:, None, None]
        kc_all[layer, bi, idx] = torch.where(mine, k1.to(kc_all.dtype), kc_all[layer, bi, idx])
        vc_all[layer, bi, idx] = torch.where(mine, v1.to(vc_all.dtype), vc_all[layer, bi, idx])

    def _decode_attn_layer(self, x, w, kc_all, vc_all, layer: int, pos, cos, sin,
                           writes=None, bt=None):
        m, cfg = self.m, self.m.cfg
        h = L.rms_norm(x, w["attn_norm"], cfg.norm_eps)
        q_all, k1, v1 = attn_mod.decode_new_kv(h, w, m.acfg, cos, sin)
        if bt is None:
            self._write_token_kv(kc_all, vc_all, layer, k1, v1, pos)
        else:
            self._write_kv(kc_all, vc_all, layer, k1, v1, writes)
        o = attn_mod.decode_attend(q_all, kc_all[layer], vc_all[layer], m.acfg, pos,
                                   self.spec.cache_len, bt, self.spec.kv_block_size)
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

    def _decode_attn_stack(self, params, prefix, x, cache, pos, cos, sin, key,
                           writes=None, bt=None):
        grp = self.m._group(params, prefix)
        names = list(grp)
        for idx in range(next(iter(grp.values())).shape[0]):
            lkey = prng.fold_in(key, idx)
            w = self._gather_layer_w(prefix, names, {n: grp[n][idx] for n in names},
                                     lkey, mlp="dense")
            x = self._decode_attn_layer(x, w, cache["k"], cache["v"], idx, pos, cos, sin,
                                        writes, bt)
        return x

    # ------------------------------------------------------------------
    # Prefill (build the cache from a whole prompt)
    # ------------------------------------------------------------------

    def prefill_fn(self, params: Params, batch: dict, key: prng.Key,
                   cache: Cache, sample: Optional[dict] = None) -> tuple[torch.Tensor, Cache]:
        """batch {"tokens": (B, S)}; writes the prompt's KV into `cache` (a
        zero cache from :meth:`init_cache_local`) and returns (next tokens
        from the last position (B,), cache).  `sample` as for
        :meth:`decode_fn`; the first token is keyed by fold_in(slot key, S).
        Ring caches only: a paged spec prefills through
        :meth:`prefill_chunk_fn`."""
        m, cfg = self.m, self.m.cfg
        if self.spec.paged:
            raise NotImplementedError("whole-prompt prefill is ring-only; paged specs "
                                      "prefill through prefill_chunk_fn")
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
        return self._sample(logits, head.shape[0], sample,
                            torch.full((b,), s, dtype=torch.int64)), cache

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

    # ------------------------------------------------------------------
    # Chunked prefill (one prompt chunk per slot, over the whole pool)
    # ------------------------------------------------------------------

    def _ring_chunk_writes(self, pos_h: torch.Tensor, keep_h: torch.Tensor, dev) -> tuple:
        """:meth:`_paged_writes` for the private rings: (source index, lane,
        ring index) of the kept chunk positions this rank holds."""
        idx, mine = attn_mod.ring_slot(pos_h, self.spec.cache_len, self.s_loc)
        src = torch.nonzero(keep_h & mine, as_tuple=True)
        return tuple(i.to(dev) for i in src), src[0].to(dev), idx[src].to(dev)

    def _chunk_attn_layer(self, x, w, kc_all, vc_all, layer: int, pos, cos, sin,
                          writes, bt=None):
        """One layer over a (B, Lq, d) chunk: the chunk's KV is written first,
        then the chunk attends the whole ring (its own earlier tokens and
        every earlier chunk), as decode attends the prefix."""
        m, cfg = self.m, self.m.cfg
        b, lq, _ = x.shape
        h = L.rms_norm(x, w["attn_norm"], cfg.norm_eps)
        q_all, k1, v1 = attn_mod.chunk_new_kv(h, w, m.acfg, cos, sin)
        self._write_kv(kc_all, vc_all, layer, k1, v1, writes)
        o = attn_mod.chunk_attend(q_all, kc_all[layer], vc_all[layer], m.acfg, pos,
                                  self.spec.cache_len, bt, self.spec.kv_block_size)
        a = attn_mod.decode_out_proj(o.reshape(b * lq, o.shape[2], cfg.head_dim), w,
                                     m.acfg, x.dtype)
        x = x + a.reshape(b, lq, -1)
        h = L.rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        return x + L.swiglu_mlp(h, w["w_gate"], w["w_up"], w["w_down"])

    def _chunk_attn_stack(self, params, prefix, x, cache, pos, cos, sin, key, writes,
                          bt=None):
        grp = self.m._group(params, prefix)
        names = list(grp)
        for idx in range(next(iter(grp.values())).shape[0]):
            lkey = prng.fold_in(key, idx)
            # mlp=None: the gathers of whole-prompt prefill, so both prefill
            # paths dequantize bit-identical weights (reference decode.py:680)
            w = self._gather_layer_w(prefix, names, {n: grp[n][idx] for n in names}, lkey)
            x = self._chunk_attn_layer(x, w, cache["k"], cache["v"], idx, pos, cos, sin,
                                       writes, bt)
        return x

    def prefill_chunk_fn(self, params: Params, cache: Cache, tokens: torch.Tensor,
                         offset: torch.Tensor, n_valid: torch.Tensor, key: prng.Key,
                         sample: Optional[dict] = None,
                         block_tables: Optional[torch.Tensor] = None,
                         compute_len: int = 0) -> tuple[torch.Tensor, Cache]:
        """Chunked prefill over the whole slot pool.  tokens (B, Lb): one
        right-padded prompt chunk per slot; offset (B,) each chunk's first
        position; n_valid (B,) its real length (0: the lane is not
        prefilling and nothing of it is written).  Writes each chunk's KV at
        its positions in place and returns (next tokens (B,), cache): the
        token after the chunk's last valid position, keyed by fold_in(slot
        key, offset + n_valid), meaningful for lanes whose chunk ends the
        prompt.

        `compute_len` > Lb pads the chunk to that many tokens before any
        compute: the scheduler and the solo path pass their top bucket, so
        every launch of a serving configuration computes at one shape and a
        token's bits do not depend on the chunk lengths of the lanes beside
        it (the card's GEMMs are not row-invariant across row counts)."""
        m, cfg = self.m, self.m.cfg
        if cfg.arch_type not in CHUNKED_PREFILL_ARCHS:
            raise NotImplementedError(f"chunked prefill supports {CHUNKED_PREFILL_ARCHS}, "
                                      f"not {cfg.arch_type!r}")
        if self.spec.paged and block_tables is None:
            raise ValueError("paged DecodeSpec requires block_tables")
        dev = cache["k"].device
        tokens = torch.as_tensor(tokens).cpu().to(torch.int64)
        if compute_len > tokens.shape[1]:
            tokens = torch.nn.functional.pad(tokens, (0, compute_len - tokens.shape[1]))
        b, lq = tokens.shape
        offset = torch.as_tensor(offset).cpu().to(torch.int64)
        n_valid = torch.as_tensor(n_valid).cpu().to(torch.int64)
        pos_h = offset[:, None] + torch.arange(lq)[None, :]
        tok_valid = torch.arange(lq)[None, :] < n_valid[:, None]
        if block_tables is not None:
            writes = self._paged_writes(pos_h, tok_valid, block_tables, dev)
            bt = block_tables.to(dev)
        else:
            writes, bt = self._ring_chunk_writes(pos_h, tok_valid, dev), None
        pos = pos_h.to(dev)
        emb = m.engine.gather("embed", params["embed"], key)
        x = L.embed_vocab_parallel(tokens.to(dev), emb)
        cos, sin = L.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
        x = self._chunk_attn_stack(params, "layers", x, cache, pos, cos, sin, key,
                                   writes, bt)
        fn = m.engine.gather("final_norm", params["final_norm"], key)
        last = (n_valid - 1).clamp(0, lq - 1).to(dev)
        h = L.rms_norm(x[torch.arange(b, device=dev), last], fn, cfg.norm_eps)
        head = emb if cfg.tie_embeddings else m.engine.gather("lm_head", params["lm_head"], key)
        logits = L.vocab_parallel_logits(h, head)
        return self._sample(logits, head.shape[0], sample, offset + n_valid,
                            n_valid > 0), cache
