"""Serving paths of all six families: whole-prompt prefill (builds the KV
ring, the recurrent state or the encoder's cross KV), chunked prefill over
the whole slot pool, and one-token decode with greedy or per-request
sampling, over a private KV ring per slot or a paged pool of KV blocks;
wired through the QSDP engine.  Chunked prefill, the paged pool and
speculative decoding serve the attention-only decoder stacks (dense, MoE),
as in the reference.

SSM and hybrid: every layer is a Mamba2 mixer whose state (the conv ring of
the last K-1 inputs and the SSM state, both f32) replaces the KV ring; the
hybrid family runs one shared attention+MLP block after every
``hybrid_attn_every`` layers, re-gathered (quantized) at each invocation,
with a KV ring per invocation.  Layer i of the SSM stack is gathered under
``fold_in(key, i)``; in the hybrid stack group g's layers under
``fold_in(fold_in(key, 1000 + g), i)``, its shared block under
``fold_in(key, 5000 + g)`` and the tail's under ``fold_in(fold_in(key,
2000), j)`` (reference ``decode.py:748-839``, ``:971-1021``).  Dead lanes
run the recurrence like live ones; admission overwrites a lane's state.

VLM: the dense stack with M-RoPE.  Prefill splices the batch's
``vision_embeds`` into the token embeddings where ``vision_mask`` is set
and rotates with the three position streams of ``batch["positions"]`` (3,
B, S).  Decode rotates with the slot's position broadcast to all three
streams (reference ``decode.py:350-357``), which gives the angles of 1-D
RoPE at that position: a prompt whose image patches advanced the streams
by less than their count continues at its sequence index, not at upstream
Qwen2-VL's next M-RoPE position.  The port mirrors the reference.

Audio (encoder-decoder): prefill runs the encoder stack over the batch's
``audio_embeds`` (layer i gathered under ``fold_in(fold_in(key, 3000),
i)``, ``enc_final_norm`` under `key`), then the decoder layers (layer i
under ``fold_in(key, i)``), each writing its self-attention ring and its
cross KV ``ck/cv`` (L, lanes, enc_len, n_kv, hd) bf16 from the encoder
output; decode runs each decoder layer's self-attention, its
cross-attention against ``ck/cv`` and its MLP, which rowquant serves
through K3 (reference ``decode.py:841-870``, ``:1023-1074``).

The MoE layer dispatches drop-free on every launch of the decode path
(decode, chunks, verify): capacity drops would let dead lanes, padding or
other requests evict a token's expert slot.  Whole-prompt prefill keeps the
reference's capacity drops (``models/moe.py``).

FSDP serving: weights stay sharded at rest and are re-gathered — quantized —
layer by layer inside every prefill and decode step, so one step runs the
quantize kernel (K1) once per quantized tensor and the dequantize kernel
(K2) once per gathered buffer.  With ``DecodeSpec(rowquant_mlp=True)`` the
decode MLP weights stay in wire-code form and go through the rowquant
kernel (K3) instead of K2.  Sampled rows draw their Gumbel noise with
``kernels.ops.random_bits``.

Cache layout: KV (L, B, S_loc, n_kv, hd) bf16, a ring along S (audio: and
the cross KV (L, B, enc_len_loc, n_kv, hd) bf16); paged, (L, R, S_row, n_kv,
hd) with R pool rows read as blocks through per-slot block
tables.  Python loops take the place of the reference's ``lax.scan``, and
the cache is updated in place (the reference returns a new one).  PyTorch
has no drop-mode scatter: the KV writes of the paged and chunked paths
index only the targets that are kept (live lanes, valid chunk tokens,
allocated blocks), found on the host once per call from the host-side
positions and tables, and every layer writes through that one index.

Control tensors (positions, chunk offsets and lengths, block tables, the
``sample`` tree) live on the host, where the scheduler keeps them; the
functions move what the device math needs.

Fixed launch shapes: cuBLAS's GEMMs and batched attention products are not
row-invariant across row counts on the card, so a request's bits would
depend on how many lanes share its launch.  Every launch of the decode
path (decode, chunked prefill, speculative verify) therefore computes at
blocks of ``lane_block`` lanes: an engine's lanes are padded with dead
lanes to a multiple of it, and a launch over more lanes runs one block at
a time.  A batch-of-1 engine and the scheduler's pool then launch every
GEMM and attention product at one shape.  ServeEngine picks
``LANE_BLOCK`` on the card and, on the CPU, the plain shapes (all lanes in
one launch) unless the spec names a block.

Self-speculative decoding (``DecodeSpec.draft_bits/draft_depth``): a draft
engine over :func:`serve.engine.make_draft_params` runs :meth:`decode_fn`
with low-bit wire-form layer weights (K2 for the attention projections, K3
for the MLP), and :meth:`verify_fn` scores the drafted tokens at serving
precision with a decode step's launches, token by token.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import prng
from ..core.quant import QuantizedParam
from . import attention as attn_mod
from . import layers as L
from . import mamba as mamba_mod
from . import moe as moe_mod
from .transformer import GROUP_OFFSET, TAIL_OFFSET, Model

Params = dict[str, torch.Tensor]
Cache = dict[str, torch.Tensor]

# dense-MLP weights that may stay in wire-code form through swiglu_mlp
ROWQUANT_MLP = ("w_gate", "w_up", "w_down")

# families whose prompts may prefill chunk-at-a-time into the pool cache
# (the reference's pure attention stacks)
CHUNKED_PREFILL_ARCHS = ("dense", "moe")

# the hybrid family's shared block, in the order the reference gathers it
SHARED_NAMES = ("attn_norm", "wq", "wk", "wv", "wo", "bq", "bk", "bv", "mlp_norm",
                "w_gate", "w_up", "w_down")

# lanes per launch of the decode path on the card (the continuous cell's
# slot count): every GEMM and attention product runs at this many lanes
LANE_BLOCK = 4
# the hybrid decode gathers group g's shared block under SAMPLE_OFFSET + g
# (the reference's models/decode.py)
SAMPLE_OFFSET = 5000


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Static decode-time configuration (the reference's DecodeSpec, plus
    the lanes of a launch block)."""

    cache_len: int        # ring size (the logical window of a slot)
    batch_global: int
    batch_sharded: bool   # shard the batch over the FSDP axes?
    enc_len: int = 0      # audio: frames of encoder memory in the cross KV
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
    # self-speculative decoding: a draft_bits-bit forward of the same model
    # drafts up to draft_depth tokens per slot per step, verified at serving
    # precision; draft_depth <= 1 is plain decode
    draft_bits: int = 0
    draft_depth: int = 0
    # lanes per launch block of the decode path (0: LANE_BLOCK on the card,
    # all lanes in one launch on the CPU; see the module docstring)
    lane_block: int = 0

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
    if cfg.arch_type == "ssm":
        cache_len = 0  # the state is O(1): no KV ring
    elif s > 65536 and cfg.long_context == "sliding_window":
        cache_len = cfg.long_context_window
    else:
        cache_len = s
    return DecodeSpec(cache_len=cache_len, batch_global=shape.global_batch,
                      batch_sharded=shape.global_batch % model.ms.fsdp_size == 0,
                      enc_len=(min(4096, s // cfg.enc_frames_ratio)
                               if cfg.arch_type == "audio" else 0),
                      rowquant_mlp=rowquant_mlp)


class DecodeModel:
    """Prefill / decode step functions for a bound Model."""

    def __init__(self, model: Model, spec: DecodeSpec, lane_block: int = 0):
        """`lane_block`: lanes per launch of the decode path (0: all of
        them in one launch, unpadded)."""
        self.m = model
        self.spec = spec
        self.tp = model.ms.model_size
        cfg = model.cfg
        if spec.cache_len % self.tp:
            raise ValueError(f"cache_len {spec.cache_len} must split over {self.tp} ranks")
        if spec.speculative and cfg.arch_type not in CHUNKED_PREFILL_ARCHS:
            raise ValueError(f"speculative decode (draft_depth={spec.draft_depth}) supports "
                             f"{CHUNKED_PREFILL_ARCHS}, not {cfg.arch_type!r}")
        if spec.draft_bits and not 2 <= spec.draft_bits <= 8:
            raise ValueError(f"draft_bits must be in [2, 8], got {spec.draft_bits}")
        if lane_block < 0:
            raise ValueError(f"lane_block must be >= 0, got {lane_block}")
        if spec.paged:
            if cfg.arch_type not in CHUNKED_PREFILL_ARCHS:
                raise ValueError(f"paged KV (kv_block_size={spec.kv_block_size}) supports "
                                 f"{CHUNKED_PREFILL_ARCHS}, not {cfg.arch_type!r}")
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
        self.lane_block = lane_block or self.b_loc
        # lanes the decode path computes: b_loc padded to whole lane blocks
        self.lanes = -(-self.b_loc // self.lane_block) * self.lane_block

    def cache_struct(self) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """Global cache shapes and dtypes: the KV ring or pool (L, rows, S,
        n_kv, hd) bf16; audio: and the cross KV (L, B, enc_len, n_kv, hd)
        bf16; SSM: the conv ring (L, B, K-1, d_inner + 2N) and the state (L,
        B, H, P, N), both f32; hybrid: those and the shared block's KV rings
        (n_layers // every, B, S, n_kv, hd)."""
        cfg = self.m.cfg

        def kv(prefix, layers, rows=self.spec.pool_rows(), seq=self.spec.cache_len):
            shp = (layers, rows, seq, self.m.acfg.n_kv, cfg.head_dim)
            return {prefix + "k": (shp, torch.bfloat16), prefix + "v": (shp, torch.bfloat16)}

        if cfg.arch_type == "audio":
            return {**kv("", cfg.n_layers),
                    **kv("c", cfg.n_layers, self.spec.batch_global, self.spec.enc_len)}
        if cfg.arch_type not in ("ssm", "hybrid"):
            return kv("", cfg.n_layers)
        mc, b = self.m.mcfg, self.spec.batch_global
        out = {"conv": ((cfg.n_layers, b, mc.conv_k - 1,
                         self.tp * (mc.d_inner_local + 2 * mc.d_state)), torch.float32),
               "ssm": ((cfg.n_layers, b, mc.n_heads, mc.head_dim, mc.d_state), torch.float32)}
        if cfg.arch_type == "hybrid":
            out.update(kv("shared_", cfg.n_layers // cfg.hybrid_attn_every))
        return out

    def init_cache_local(self, device) -> Cache:
        """This rank's zero cache over the engine's lanes (b_loc padded to
        whole lane blocks; paged: all pool rows): the ring S_loc, the conv
        ring's and the state's local channels and heads."""
        out = {}
        for k, (shp, dt) in self.cache_struct().items():
            shp = list(shp)
            if not self.spec.paged:
                shp[1] = self.lanes
            shp[3 if k == "conv" else 2] //= self.tp
            out[k] = torch.zeros(shp, dtype=dt, device=device)
        return out

    @property
    def min_prompt_len(self) -> int:
        """The shortest prompt whole-prompt prefill takes: a Mamba2 layer's
        conv state needs K-1 prompt tokens (ROADMAP C7)."""
        return self.m.mcfg.conv_k - 1 if self.m.cfg.arch_type in ("ssm", "hybrid") else 1

    # ------------------------------------------------------------------
    # Lane blocks (fixed launch shapes)
    # ------------------------------------------------------------------

    def _pad_lanes(self, t, fill) -> torch.Tensor:
        """(B, ...) -> (lanes, ...), the extra lanes filled with `fill`."""
        t = torch.as_tensor(t)
        extra = self.lanes - t.shape[0]
        if extra < 0:
            raise ValueError(f"{t.shape[0]} lanes given, the engine has {self.lanes}")
        return torch.cat([t, t.new_full((extra, *t.shape[1:]), fill)]) if extra else t

    def _pad_sample(self, sample: Optional[dict]) -> Optional[dict]:
        """The padded lanes of a `sample` tree are greedy."""
        if sample is None:
            return None
        return {"temp": self._pad_lanes(sample["temp"], 0.0),
                "top_k": self._pad_lanes(sample["top_k"], 1),
                "key": self._pad_lanes(sample["key"], 0)}

    def _blocks(self, pos, keep_h, block_tables, dev) -> list[_Block]:
        """One :class:`_Block` per lane_block lanes of positions `pos` (lanes,)
        or (lanes, Lq): its positions and rope on `dev` and, where the
        writes index kept targets (paged; chunks), the KV writes of the
        positions `keep_h` keeps, found on the host."""
        cfg = self.m.cfg
        out = []
        for i in range(0, self.lanes, self.lane_block):
            sl = slice(i, i + self.lane_block)
            p = pos[sl]
            pd = p.to(dev)
            cos = sin = None
            if cfg.has_attention:
                # M-RoPE too: the reference's _decode_rope puts the slot's
                # position in all three streams, which is 1-D RoPE's angles
                cos, sin = L.rope_cos_sin(pd, cfg.head_dim, cfg.rope_theta)
            writes = bt = None
            if block_tables is not None:
                writes = self._paged_writes(p.cpu(), keep_h[sl], block_tables[sl], dev)
                bt = block_tables[sl].to(dev)
            elif p.dim() == 2:
                writes = self._ring_chunk_writes(p.cpu(), keep_h[sl], dev)
            out.append(_Block(sl, pd, cos, sin, writes, bt))
        return out

    @staticmethod
    def _per_block(x: torch.Tensor, blocks: list, fn) -> torch.Tensor:
        """fn(lanes of x, block) for each block, joined along the lanes."""
        if len(blocks) == 1:
            return fn(x, blocks[0])
        return torch.cat([fn(x[b.sl], b) for b in blocks])

    def _lane_cache(self, cache: Cache, blk: _Block, prefix: str = ""):
        """The k/v caches a block reads and writes: its lanes of the rings (a
        view, written in place), or the whole paged pool.  `prefix` "shared_"
        names the hybrid family's shared-block rings."""
        if self.spec.paged:
            return cache["k"], cache["v"]
        return cache[prefix + "k"][:, blk.sl], cache[prefix + "v"][:, blk.sl]

    def _logits(self, x: torch.Tensor, fn: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        """Final norm and f32 logits of (lanes, d), lane_block rows per launch."""
        eps, lb = self.m.cfg.norm_eps, self.lane_block
        parts = [L.vocab_parallel_logits(L.rms_norm(x[i:i + lb], fn, eps), head)
                 for i in range(0, x.shape[0], lb)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

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
        (-1: unallocated).  B <= the engine's lanes; the rest run dead.
        Returns (next tokens (B,), cache updated in place)."""
        m, cfg = self.m, self.m.cfg
        dev = next(iter(cache.values())).device
        if self.spec.paged and block_tables is None:
            raise ValueError("paged DecodeSpec: decode_fn needs block_tables")
        b = tokens.shape[0]
        pos_in = torch.as_tensor(pos)
        if pos_in.ndim == 0:
            pos_in = pos_in.expand(tokens.shape)
        pos_in = self._pad_lanes(pos_in, -1)
        bt = keep = None
        if block_tables is not None:
            bt = self._pad_lanes(block_tables.to(torch.int64).cpu(), -1)
            keep = attn_mod.slot_valid_mask(pos_in.cpu())
        blocks = self._blocks(pos_in, keep, bt, dev)
        emb = m.engine.gather("embed", params["embed"], key)
        x = L.embed_vocab_parallel(self._pad_lanes(tokens, 0).to(dev)[:, None], emb)[:, 0]
        if cfg.arch_type in ("ssm", "hybrid"):
            x = self._decode_mamba(params, x, cache, blocks, key)
        elif cfg.arch_type == "audio":
            x = self._decode_audio(params, x, cache, blocks, key)
        else:
            x = self._decode_attn_stack(params, "layers", x, cache, blocks, key)
        fn = m.engine.gather("final_norm", params["final_norm"], key)
        head = emb if cfg.tie_embeddings else m.engine.gather("lm_head", params["lm_head"], key)
        logits = self._logits(x, fn, head)
        if sample is None:
            return self._sample(logits, head.shape[0])[:b], cache
        pos_h = pos_in.cpu()
        return self._sample(logits, head.shape[0], self._pad_sample(sample), pos_h + 1,
                            attn_mod.slot_valid_mask(pos_h))[:b], cache

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

    @property
    def _mlp_kind(self) -> str:
        """The feed-forward of the decode-path gathers: "dense" (rowquant may
        take it) or "moe"."""
        return "moe" if self.m.cfg.is_moe else "dense"

    def _mlp(self, h: torch.Tensor, w: dict, no_drop: bool) -> torch.Tensor:
        """The layer's feed-forward over h (..., d): the dense SwiGLU, or the
        MoE layer over the flattened tokens (reference ``decode.py:418``,
        ``:658``, ``:943``)."""
        if not self.m.cfg.is_moe:
            return L.swiglu_mlp(h, w["w_gate"], w["w_up"], w["w_down"])
        y, _ = moe_mod.moe_layer(h.reshape(-1, h.shape[-1]), w, self.m.ecfg, no_drop=no_drop)
        return y.reshape(h.shape)

    def _decode_self_attn(self, x, w, cache: Cache, layer: int, blk: _Block,
                          prefix: str = ""):
        """x plus layer `layer`'s self-attention of one lane block's tokens x
        (lane_block, d), its KV written first; `prefix` "shared_": the
        hybrid family's shared block at invocation `layer`."""
        m = self.m
        kc_all, vc_all = self._lane_cache(cache, blk, prefix)
        h = L.rms_norm(x, w["attn_norm"], m.cfg.norm_eps)
        q_all, k1, v1 = attn_mod.decode_new_kv(h, w, m.acfg, blk.cos, blk.sin)
        if blk.bt is None:
            self._write_token_kv(kc_all, vc_all, layer, k1, v1, blk.pos)
        else:
            self._write_kv(kc_all, vc_all, layer, k1, v1, blk.writes)
        o = attn_mod.decode_attend(q_all, kc_all[layer], vc_all[layer], m.acfg, blk.pos,
                                   self.spec.cache_len, blk.bt, self.spec.kv_block_size)
        return x + attn_mod.decode_out_proj(o, w, m.acfg, x.dtype)

    def _decode_attn_layer(self, x, w, cache: Cache, layer: int, blk: _Block,
                           prefix: str = ""):
        """One layer over one lane block's tokens x (lane_block, d); `prefix`
        as for :meth:`_decode_self_attn`."""
        x = self._decode_self_attn(x, w, cache, layer, blk, prefix)
        h = L.rms_norm(x, w["mlp_norm"], self.m.cfg.norm_eps)
        return x + self._mlp(h, w, no_drop=True)

    def _gather_layer_w(self, prefix: str, names, lw: Params, lkey: prng.Key,
                        mlp=None) -> dict:
        """One layer's weights: one coalesced gather for the dense ones; with
        rowquant decode (mlp="dense": never the MoE experts) the MLP matmul
        weights come back as RowQuantWeights, gathered separately, that stay
        in code form.

        Weights that arrive as wire codes (QuantizedParam: a quantized
        checkpoint served through ``prepare_wire_params``, or the low-bit
        draft of ``make_draft_params``) are gathered as those codes, never
        re-quantized: MLP weights whose buckets tile their rows stay in code
        form for K3 (``QSDPEngine.gather_rowquant_wire``), the rest decode
        densely, all of the layer's in one K2 launch
        (``QSDPEngine.gather_wire_dequant``); reference ``decode.py:430``."""
        m = self.m
        wire = [n for n in names if isinstance(lw[n], QuantizedParam)]
        rq = [n for n in names if n not in wire
              and self.spec.rowquant_mlp and mlp == "dense" and n in ROWQUANT_MLP]
        out = m.engine.gather_layer(
            f"{prefix}/", {n: lw[n] for n in names if n not in rq and n not in wire}, lkey)
        rq_wire = [n for n in wire if n in ROWQUANT_MLP
                   and m.engine.rowquant_wire_eligible(f"{prefix}/{n}", lw[n])]
        for n in rq_wire:
            out[n] = m.engine.gather_rowquant_wire(f"{prefix}/{n}", lw[n])
        out.update(m.engine.gather_wire_dequant(
            f"{prefix}/", {n: lw[n] for n in wire if n not in rq_wire}))
        for n in rq:
            out[n] = m.engine.gather_rowquant(f"{prefix}/{n}", lw[n], lkey)
        return out

    def _decode_attn_stack(self, params, prefix, x, cache, blocks, key):
        grp = self.m._group(params, prefix)
        names = list(grp)
        for idx in range(_n_layers(grp)):
            w = self._gather_layer_w(prefix, names, _layer(grp, idx), prng.fold_in(key, idx),
                                     mlp=self._mlp_kind)
            x = self._per_block(x, blocks, lambda xb, blk, w=w, idx=idx:
                                self._decode_attn_layer(xb, w, cache, idx, blk))
        return x

    # ------------------------------------------------------------------
    # Encoder-decoder (audio)
    # ------------------------------------------------------------------

    def _decode_audio_layer(self, x, w, cache: Cache, layer: int, blk: _Block):
        """One decoder layer over one lane block's tokens x (lane_block, d):
        self-attention over its ring, cross-attention over its lanes' cached
        encoder KV, then the MLP (reference ``decode.py:847-864``)."""
        m, cfg = self.m, self.m.cfg
        x = self._decode_self_attn(x, w, cache, layer, blk)
        h = L.rms_norm(x, w["xattn_norm"], cfg.norm_eps)
        xw = {"wq": w["xwq"], "wk": w["xwk"], "wv": w["xwv"], "wo": w["xwo"]}
        x = x + attn_mod.decode_cross_attention(h, xw, m.acfg, cache["ck"][layer, blk.sl],
                                                cache["cv"][layer, blk.sl],
                                                self.spec.enc_len)
        h = L.rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        return x + L.swiglu_mlp(h, w["w_gate"], w["w_up"], w["w_down"])

    def _decode_audio(self, params, x, cache, blocks, key):
        """The decoder stack of one decode step; layer i gathered under
        ``fold_in(key, i)``, its MLP in code form for K3 under rowquant."""
        grp = self.m._group(params, "dec")
        names = list(grp)
        for idx in range(_n_layers(grp)):
            w = self._gather_layer_w("dec", names, _layer(grp, idx), prng.fold_in(key, idx),
                                     mlp="dense")
            x = self._per_block(x, blocks, lambda xb, blk, w=w, idx=idx:
                                self._decode_audio_layer(xb, w, cache, idx, blk))
        return x

    def _prefill_audio(self, params, batch, x, key, cos, sin, positions, cache):
        """The audio prefill (reference ``decode.py:1023-1074``): the
        encoder over ``batch["audio_embeds"]`` (B, S_enc, d), the training
        forward's (``Model._encode``: layer i gathered under
        ``fold_in(fold_in(key, 3000), i)``, ``enc_final_norm`` under `key`),
        its layers gathered as the decode path gathers; then each decoder
        layer under ``fold_in(key, i)``, which writes its
        self-attention ring and its cross KV, the first enc_len frames of
        ``memory @ xwk`` / ``memory @ xwv`` in bf16, into the first rows of
        `cache`."""
        m, cfg = self.m, self.m.cfg
        b, s_enc, _ = batch["audio_embeds"].shape
        e_loc = self.spec.enc_len // self.tp
        if s_enc < self.spec.enc_len:
            raise ValueError(f"audio_embeds has {s_enc} frames, the cross KV holds "
                             f"enc_len = {self.spec.enc_len}")
        grp = m._group(params, "enc")
        names = list(grp)
        layers = [tuple(_layer(grp, i)[n] for n in names) for i in range(_n_layers(grp))]
        mem = m._encode(params, batch["audio_embeds"], key, layers=(names, layers),
                        gather=lambda pfx, w, lkey: self._gather_layer_w(pfx, list(w), w, lkey))
        grp = m._group(params, "dec")
        names = list(grp)
        kv_shape = (b, s_enc, m.acfg.kv_local, cfg.head_dim)
        for idx in range(_n_layers(grp)):
            w = self._gather_layer_w("dec", names, _layer(grp, idx), prng.fold_in(key, idx))
            x, (kf, vf) = m._dec_layer(x, w, cos, sin, positions, mem, cache_slice=True)
            cache["k"][idx, :b] = self._slice_seq(kf).to(torch.bfloat16)
            cache["v"][idx, :b] = self._slice_seq(vf).to(torch.bfloat16)
            # one model rank: the local frames of the cross KV are the first e_loc
            for c, wn in (("ck", "xwk"), ("cv", "xwv")):
                cache[c][idx, :b] = (mem @ w[wn]).reshape(kv_shape)[:, :e_loc].to(
                    torch.bfloat16)
        return x

    # ------------------------------------------------------------------
    # SSM and hybrid stacks
    # ------------------------------------------------------------------

    def _mamba_plan(self, key: prng.Key) -> list[tuple[str, int, prng.Key]]:
        """The SSM/hybrid stack in order, with each gather's key: ("mamba",
        layer, key) and, for the hybrid family, ("shared", group, key) after
        every `hybrid_attn_every` layers, then the tail's layers."""
        cfg = self.m.cfg
        if cfg.arch_type == "ssm":
            return [("mamba", i, prng.fold_in(key, i)) for i in range(cfg.n_layers)]
        every = cfg.hybrid_attn_every
        n_groups, rem = divmod(cfg.n_layers, every)
        plan = []
        for g in range(n_groups):
            gkey = prng.fold_in(key, GROUP_OFFSET + g)
            plan += [("mamba", g * every + i, prng.fold_in(gkey, i)) for i in range(every)]
            plan.append(("shared", g, prng.fold_in(key, SAMPLE_OFFSET + g)))
        tkey = prng.fold_in(key, TAIL_OFFSET)
        return plan + [("mamba", n_groups * every + j, prng.fold_in(tkey, j))
                       for j in range(rem)]

    def _mamba_gathers(self, params: Params, key: prng.Key, shared_mlp=None):
        """(kind, index, gathered weights) along :meth:`_mamba_plan`; the
        shared block's MLP goes through rowquant where `shared_mlp` is
        "dense" (the decode path)."""
        grp = self.m._group(params, "layers")
        names = list(grp)
        shared = {n: params[f"shared/{n}"] for n in SHARED_NAMES if f"shared/{n}" in params}
        for kind, i, k in self._mamba_plan(key):
            if kind == "mamba":
                yield kind, i, self._gather_layer_w("layers", names, _layer(grp, i), k)
            else:
                yield kind, i, self._gather_layer_w("shared", list(shared), shared, k,
                                                    mlp=shared_mlp)

    def _decode_mamba_layer(self, x, w, cache: Cache, layer: int, blk: _Block):
        """One Mamba2 layer over one lane block's tokens x (lane_block, d),
        its lanes' conv ring and state updated in place."""
        conv, ssm = cache["conv"][layer, blk.sl], cache["ssm"][layer, blk.sl]
        h = L.rms_norm(x, w["pre_norm"], self.m.cfg.norm_eps)
        y, conv_new, ssm_new = mamba_mod.mamba2_decode(h, w, self.m.mcfg, conv, ssm)
        conv.copy_(conv_new)
        ssm.copy_(ssm_new)
        return x + y

    def _decode_mamba(self, params, x, cache, blocks, key):
        """The SSM/hybrid decode stack (reference ``decode.py:741-839``); the
        shared block reuses the attention layer on the "shared_" rings."""
        for kind, i, w in self._mamba_gathers(params, key, shared_mlp="dense"):
            if kind == "mamba":
                x = self._per_block(x, blocks, lambda xb, blk, w=w, i=i:
                                    self._decode_mamba_layer(xb, w, cache, i, blk))
            else:
                x = self._per_block(x, blocks, lambda xb, blk, w=w, i=i:
                                    self._decode_attn_layer(xb, w, cache, i, blk, "shared_"))
        return x

    def _prefill_mamba(self, params, x, key, cos, sin, positions, cache):
        """The SSM/hybrid prefill stack (reference ``decode.py:971-1021``):
        each layer's conv ring (the last K-1 pre-conv inputs, the B/C part
        rounded to the compute dtype, stored f32) and final state, and the
        shared block's KV, written into the first rows of `cache`."""
        b, eps = x.shape[0], self.m.cfg.norm_eps
        for kind, i, w in self._mamba_gathers(params, key):
            if kind == "mamba":
                h = L.rms_norm(x, w["pre_norm"], eps)
                y, (cx, cbc, hf) = mamba_mod.mamba2_block(h, w, self.m.mcfg, return_state=True)
                cache["conv"][i, :b] = torch.cat([cx, cbc.to(cx.dtype)], dim=-1).float()
                cache["ssm"][i, :b] = hf.float()
                x = x + y
            else:
                x, kf, vf = self._prefill_attn_layer(x, w, cos, sin, positions)
                cache["shared_k"][i, :b], cache["shared_v"][i, :b] = kf, vf
        return x

    # ------------------------------------------------------------------
    # Speculative verify (score K drafted tokens with a decode step's launches)
    # ------------------------------------------------------------------

    def verify_fn(self, params: Params, cache: Cache, tokens: torch.Tensor,
                  pos: torch.Tensor, n_spec: torch.Tensor, key: prng.Key,
                  sample: Optional[dict] = None,
                  block_tables: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, Cache]:
        """Serving-precision verify of up to K drafted tokens per slot
        (reference ``decode.py:489``).  tokens (B, K): token j of slot b is
        fed at position pos[b] + j, [t0, g1, .., g_{K-1}] with t0 the slot's
        feed token and g its draft chain; pos (B,) the feed positions (< 0:
        dead lane); n_spec (B,) how many of the K tokens the slot runs (token
        j >= n_spec[b] runs dead).  Returns (out (B, K), cache): out[b, j] is
        the model's token after tokens[b, :j+1], out[b, 0] what decode_fn
        would emit, and every run token's KV is (re)written at serving
        precision, over what the draft left there.

        Each layer's weights are gathered once; inside the layer the K token
        positions run one after another, each as :meth:`decode_fn` runs its
        token (write its KV, then attend), at the same lanes and blocks;
        the final norm, logits and sampling run per token too.  So every
        launch has a decode step's shape, and a committed token is bit for
        bit the token that sequential decode_fn calls produce."""
        m, cfg = self.m, self.m.cfg
        if cfg.arch_type not in CHUNKED_PREFILL_ARCHS:
            raise NotImplementedError(f"speculative verify supports {CHUNKED_PREFILL_ARCHS}, "
                                      f"not {cfg.arch_type!r}")
        if self.spec.paged and block_tables is None:
            raise ValueError("paged DecodeSpec: verify_fn needs block_tables")
        dev = cache["k"].device
        b, kmax = tokens.shape
        tokens = self._pad_lanes(torch.as_tensor(tokens).to(torch.int64), 0).to(dev)
        pos_h = self._pad_lanes(torch.as_tensor(pos).cpu().to(torch.int64), -1)
        n_spec = self._pad_lanes(torch.as_tensor(n_spec).cpu().to(torch.int64), 0)
        js = torch.arange(kmax)
        # (K, lanes) positions, the dead sentinel past each slot's depth
        pjs = torch.where((js[:, None] < n_spec[None, :]) & attn_mod.slot_valid_mask(pos_h)[None],
                          pos_h[None] + js[:, None], -1)
        bt = (None if block_tables is None
              else self._pad_lanes(block_tables.to(torch.int64).cpu(), -1))
        blocks = [self._blocks(pj, attn_mod.slot_valid_mask(pj), bt, dev) for pj in pjs]
        emb = m.engine.gather("embed", params["embed"], key)
        xs = [L.embed_vocab_parallel(tokens[:, j, None], emb)[:, 0] for j in range(kmax)]
        grp = m._group(params, "layers")
        names = list(grp)
        for idx in range(_n_layers(grp)):
            w = self._gather_layer_w("layers", names, _layer(grp, idx), prng.fold_in(key, idx),
                                     mlp=self._mlp_kind)
            for j in range(kmax):
                xs[j] = self._per_block(xs[j], blocks[j], lambda xb, blk, w=w, idx=idx:
                                        self._decode_attn_layer(xb, w, cache, idx, blk))
        fn = m.engine.gather("final_norm", params["final_norm"], key)
        head = emb if cfg.tie_embeddings else m.engine.gather("lm_head", params["lm_head"], key)
        sample = self._pad_sample(sample)
        outs = []
        for x, pj in zip(xs, pjs):
            logits = self._logits(x, fn, head)
            outs.append(self._sample(logits, head.shape[0]) if sample is None else
                        self._sample(logits, head.shape[0], sample, pj + 1,
                                     attn_mod.slot_valid_mask(pj)))
        return torch.stack(outs, dim=1)[:b], cache

    # ------------------------------------------------------------------
    # Prefill (build the cache from a whole prompt)
    # ------------------------------------------------------------------

    def prefill_fn(self, params: Params, batch: dict, key: prng.Key,
                   cache: Cache, sample: Optional[dict] = None) -> tuple[torch.Tensor, Cache]:
        """batch {"tokens": (B, S)} and the family's modality stubs (VLM:
        "vision_embeds" (B, S, d), "vision_mask" (B, S), "positions" (3, B,
        S); audio: "audio_embeds" (B, S_enc >= enc_len, d)); writes the
        prompt's caches into `cache` (a zero cache from
        :meth:`init_cache_local`) and returns (next tokens from the last
        position (B,), cache).  `sample` as for
        :meth:`decode_fn`; the first token is keyed by fold_in(slot key, S).
        Ring caches only: a paged spec prefills through
        :meth:`prefill_chunk_fn`."""
        m, cfg = self.m, self.m.cfg
        if self.spec.paged:
            raise NotImplementedError("whole-prompt prefill is ring-only; paged specs "
                                      "prefill through prefill_chunk_fn")
        tokens = batch["tokens"]
        b, s = tokens.shape
        if cfg.has_attention and s > self.spec.cache_len:
            raise ValueError(f"prompt ({s}) exceeds the KV ring ({self.spec.cache_len})")
        if s < self.min_prompt_len:
            raise ValueError(f"a prompt of {s} tokens is shorter than the {cfg.arch_type} "
                             f"prefill's minimum of {self.min_prompt_len} (the Mamba2 conv "
                             "state holds the last conv_k - 1 prompt tokens)")
        emb, x, positions, cos, sin = m._embed(params, batch, key)
        if cfg.arch_type in ("ssm", "hybrid"):
            x = self._prefill_mamba(params, x, key, cos, sin, positions, cache)
        elif cfg.arch_type == "audio":
            x = self._prefill_audio(params, batch, x, key, cos, sin, positions, cache)
        else:
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
        # the reference's whole-prompt prefill keeps the capacity drops
        x = x + self._mlp(h, w, no_drop=False)
        return (x, self._slice_seq(kf).to(torch.bfloat16),
                self._slice_seq(vf).to(torch.bfloat16))

    def _prefill_attn_stack(self, params, prefix, x, key, cos, sin, positions, cache):
        grp = self.m._group(params, prefix)
        names = list(grp)
        for idx in range(_n_layers(grp)):
            lkey = prng.fold_in(key, idx)
            # mlp=None: rowquant is a decode-only path, as in the reference
            w = self._gather_layer_w(prefix, names, _layer(grp, idx), lkey)
            x, kf, vf = self._prefill_attn_layer(x, w, cos, sin, positions)
            cache["k"][idx, :x.shape[0]], cache["v"][idx, :x.shape[0]] = kf, vf
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

    def _chunk_attn_layer(self, x, w, cache: Cache, layer: int, blk: _Block):
        """One layer over one lane block's (lane_block, Lq, d) chunk: the
        chunk's KV is written first, then the chunk attends the whole ring
        (its own earlier tokens and every earlier chunk), as decode attends
        the prefix."""
        m, cfg = self.m, self.m.cfg
        b, lq, _ = x.shape
        kc_all, vc_all = self._lane_cache(cache, blk)
        h = L.rms_norm(x, w["attn_norm"], cfg.norm_eps)
        q_all, k1, v1 = attn_mod.chunk_new_kv(h, w, m.acfg, blk.cos, blk.sin)
        self._write_kv(kc_all, vc_all, layer, k1, v1, blk.writes)
        o = attn_mod.chunk_attend(q_all, kc_all[layer], vc_all[layer], m.acfg, blk.pos,
                                  self.spec.cache_len, blk.bt, self.spec.kv_block_size)
        a = attn_mod.decode_out_proj(o.reshape(b * lq, o.shape[2], cfg.head_dim), w,
                                     m.acfg, x.dtype)
        x = x + a.reshape(b, lq, -1)
        h = L.rms_norm(x, w["mlp_norm"], cfg.norm_eps)
        return x + self._mlp(h, w, no_drop=True)

    def _chunk_attn_stack(self, params, prefix, x, cache, blocks, key):
        grp = self.m._group(params, prefix)
        names = list(grp)
        for idx in range(_n_layers(grp)):
            # mlp=None: the gathers of whole-prompt prefill, so both prefill
            # paths dequantize bit-identical weights (reference decode.py:680)
            w = self._gather_layer_w(prefix, names, _layer(grp, idx), prng.fold_in(key, idx))
            x = self._per_block(x, blocks, lambda xb, blk, w=w, idx=idx:
                                self._chunk_attn_layer(xb, w, cache, idx, blk))
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
        b = tokens.shape[0]
        tokens = self._pad_lanes(torch.as_tensor(tokens).cpu().to(torch.int64), 0)
        if compute_len > tokens.shape[1]:
            tokens = torch.nn.functional.pad(tokens, (0, compute_len - tokens.shape[1]))
        lq = tokens.shape[1]
        offset = self._pad_lanes(torch.as_tensor(offset).cpu().to(torch.int64), 0)
        n_valid = self._pad_lanes(torch.as_tensor(n_valid).cpu().to(torch.int64), 0)
        pos_h = offset[:, None] + torch.arange(lq)[None, :]
        tok_valid = torch.arange(lq)[None, :] < n_valid[:, None]
        bt = (None if block_tables is None
              else self._pad_lanes(block_tables.to(torch.int64).cpu(), -1))
        blocks = self._blocks(pos_h, tok_valid, bt, dev)
        emb = m.engine.gather("embed", params["embed"], key)
        x = L.embed_vocab_parallel(tokens.to(dev), emb)
        x = self._chunk_attn_stack(params, "layers", x, cache, blocks, key)
        fn = m.engine.gather("final_norm", params["final_norm"], key)
        last = (n_valid - 1).clamp(0, lq - 1).to(dev)
        head = emb if cfg.tie_embeddings else m.engine.gather("lm_head", params["lm_head"], key)
        logits = self._logits(x[torch.arange(self.lanes, device=dev), last], fn, head)
        return self._sample(logits, head.shape[0], self._pad_sample(sample), offset + n_valid,
                            n_valid > 0)[:b], cache


@dataclasses.dataclass
class _Block:
    """One lane block of a launch: its lanes, their positions and rope on
    the device, the KV writes of its kept targets (paged; chunks) and its
    block tables (paged)."""

    sl: slice
    pos: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    writes: Optional[tuple]
    bt: Optional[torch.Tensor]


def _n_layers(grp: dict) -> int:
    v = next(iter(grp.values()))
    return (v.wire if isinstance(v, QuantizedParam) else v).shape[0]


def _layer(grp: dict, idx: int) -> dict:
    """Layer idx of a stacked group; a wire-form leaf (split per stack
    slice, ``qparam_split_stack``) gives that layer's segment."""
    return {n: QuantizedParam(v.wire[idx], v.cell_shape, v.cfg) if isinstance(v, QuantizedParam)
            else v[idx] for n, v in grp.items()}
