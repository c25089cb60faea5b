"""Attention: GQA with the JAX package's tensor-parallel layout, chunked
(flash) attention for training and prefill, ring-cache and paged-pool
decode, the multi-query attend of chunked prefill, and the audio family's
encoder-decoder cross-attention, whole-prompt and one token against the
cached encoder KV (``models/attention.py`` of the JAX package).

These are plain PyTorch tensor ops: the JAX package has no Pallas
attention kernel.  Query heads are padded to a multiple of the model-axis
size and padded heads are masked; the KV ring is sequence-sharded over the
model axis.  ``rank`` is the model-axis index and ``group`` the model group
of the training path (serving runs on one model rank, ROADMAP A10e).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.collectives import require_one_rank
from ..core.tp import tp_copy, tp_reduce
from .layers import apply_rope


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv: int
    head_dim: int
    tp: int
    causal: bool = True
    sliding_window: int = 0
    q_chunk: int = 1024
    kv_chunk: int = 1024
    mxu_bf16: bool = False

    @property
    def n_heads_padded(self) -> int:
        return -(-self.n_heads // self.tp) * self.tp

    @property
    def heads_local(self) -> int:
        return self.n_heads_padded // self.tp

    @property
    def kv_mode(self) -> str:
        ok = (self.n_kv % self.tp == 0 and self.n_heads_padded == self.n_heads
              and self.n_heads % self.n_kv == 0)
        return "tp" if ok else "replicated"

    @property
    def kv_local(self) -> int:
        return self.n_kv // self.tp if self.kv_mode == "tp" else self.n_kv

    @property
    def group(self) -> int:
        return max(self.n_heads // self.n_kv, 1)


def _local_head_mask(cfg: AttnConfig, device, rank: int = 0) -> torch.Tensor:
    gidx = rank * cfg.heads_local + torch.arange(cfg.heads_local, device=device)
    return (gidx < cfg.n_heads).to(torch.float32)


def _expand_kv_local(k: torch.Tensor, cfg: AttnConfig, rank: int = 0) -> torch.Tensor:
    """(..., kv_local, hd) -> (..., heads_local, hd)."""
    if cfg.kv_mode == "tp":
        return torch.repeat_interleave(k, cfg.heads_local // max(cfg.kv_local, 1), dim=-2)
    gidx = rank * cfg.heads_local + torch.arange(cfg.heads_local, device=k.device)
    return k[..., (gidx // cfg.group).clamp(0, cfg.n_kv - 1), :]


def flash_attention(q, k, v, q_pos, kv_pos, causal: bool, window: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    mxu_bf16: bool = False) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, D) over k/v (B, Skv, H, D) in the
    reference's order (``attention.py:114-191``): q chunks of `q_chunk`, and
    within each an online softmax over kv chunks of `kv_chunk` with running
    (max, sum-exp, out) in f32.  Differentiable by autograd; memory is
    bounded by one layer at a time under the per-layer checkpoint."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    cq, ckv = min(q_chunk, sq), min(kv_chunk, skv)
    if sq % cq or skv % ckv:
        raise ValueError(f"sequence lengths ({sq}, {skv}) must be multiples of the "
                         f"chunks ({cq}, {ckv})")
    scale = 1.0 / math.sqrt(d)
    outs = []
    for q0 in range(0, sq, cq):
        qi = q[:, q0:q0 + cq].float()
        qp = q_pos[q0:q0 + cq]
        m = torch.full((b, h, cq), float("-inf"), device=q.device)
        l_ = torch.zeros((b, h, cq), device=q.device)
        o = torch.zeros((b, h, cq, d), device=q.device)
        for k0 in range(0, skv, ckv):
            kp = kv_pos[k0:k0 + ckv]
            s = torch.einsum("bqhd,bkhd->bhqk", qi, k[:, k0:k0 + ckv].float()) * scale
            msk = torch.ones((cq, ckv), dtype=torch.bool, device=q.device)
            if causal:
                msk &= qp[:, None] >= kp[None, :]
            if window:
                msk &= kp[None, :] > qp[:, None] - window
            s = s.masked_fill(~msk, float("-inf"))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            m_safe = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
            p = torch.exp(s - m_safe[..., None]).masked_fill(~msk, 0.0)
            m_fin = torch.where(torch.isinf(m), torch.zeros_like(m), m)
            corr = torch.exp(m_fin - m_safe) * (~torch.isinf(m)).float()
            l_ = l_ * corr + p.sum(-1)
            if mxu_bf16:  # the reference feeds bf16 probabilities to the PV dot
                p = p.to(q.dtype).float()
            pv = torch.einsum("bhqk,bkhd->bhqd", p, v[:, k0:k0 + ckv].float())
            o = o * corr[..., None] + pv
            m = m_new
        out = o / torch.clamp(l_, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2))
    return torch.cat(outs, dim=1).to(q.dtype)


def _proj(x, w: dict, name: str):
    """x @ w[name] (+ its bias, where the model has one)."""
    y = x @ w[f"w{name}"]
    return y + w[f"b{name}"].to(x.dtype) if f"b{name}" in w else y


def self_attention(x, w: dict, cfg: AttnConfig, cos, sin, positions,
                   cache_slice: bool = False, rank: int = 0, group=None):
    """Training / prefill self-attention of model rank `rank`'s heads
    (reference ``attention.py:195-228``), its output summed over the model
    group `group`.  Returns (out (B, S, d), (k_full, v_full) if cache_slice
    else None), k/v (B, S, n_kv, hd) rope-applied; the prefill's KV runs on
    one model rank (serving over ranks is ROADMAP A10e)."""
    if cache_slice:
        require_one_rank(group, "A10e")
    b, s, _ = x.shape
    hd = cfg.head_dim
    xi = tp_copy(x, group)
    q, k, v = (_proj(xi, w, n) for n in "qkv")
    q = apply_rope(q.reshape(b, s, cfg.heads_local, hd), cos, sin)
    k = apply_rope(k.reshape(b, s, cfg.kv_local, hd), cos, sin)
    v = v.reshape(b, s, cfg.kv_local, hd)
    o = flash_attention(q, _expand_kv_local(k, cfg, rank), _expand_kv_local(v, cfg, rank),
                        positions, positions, cfg.causal, cfg.sliding_window,
                        cfg.q_chunk, cfg.kv_chunk, cfg.mxu_bf16)
    o = o * _local_head_mask(cfg, x.device, rank)[None, None, :, None].to(o.dtype)
    out = tp_reduce(o.reshape(b, s, cfg.heads_local * hd) @ w["wo"], group)
    if not cache_slice:
        return out, None
    return out, (k, v)  # one model rank: the local KV heads are all heads


def cross_attention(x, memory, w: dict, cfg: AttnConfig):
    """Encoder-decoder cross-attention of x (B, S, d) over the encoder
    output memory (B, S_enc, d): no rotation, every frame visible (flash
    attention with causal=False over S_enc keys); w holds wq/wk/wv/wo (the
    reference applies no bias here)."""
    b, s, _ = x.shape
    s_enc, hd = memory.shape[1], cfg.head_dim
    xi, mi = tp_copy(x), tp_copy(memory)
    q = (xi @ w["wq"]).reshape(b, s, cfg.heads_local, hd)
    k = (mi @ w["wk"]).reshape(b, s_enc, cfg.kv_local, hd)
    v = (mi @ w["wv"]).reshape(b, s_enc, cfg.kv_local, hd)
    o = flash_attention(q, _expand_kv_local(k, cfg), _expand_kv_local(v, cfg),
                        torch.arange(s, device=x.device), torch.arange(s_enc, device=x.device),
                        causal=False, window=0, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                        mxu_bf16=cfg.mxu_bf16)
    o = o * _local_head_mask(cfg, x.device)[None, None, :, None].to(o.dtype)
    return tp_reduce(o.reshape(b, s, cfg.heads_local * hd) @ w["wo"])


def decode_cross_attention(x, w: dict, cfg: AttnConfig, ck_cache, cv_cache, enc_len: int,
                           rank: int = 0):
    """One token's cross-attention, x (B, d), against the prefill's cached
    encoder KV ck/cv (B, S_enc_loc, n_kv, hd) bf16, this rank's frames;
    frames at or past `enc_len` are masked.  Scores and the softmax in f32
    over operands in the compute dtype, as :func:`decode_attend` (on one
    model rank the reference's pmax/psum are the identity).  Returns (B, d)."""
    b = x.shape[0]
    hd, s_loc = cfg.head_dim, ck_cache.shape[1]
    q_all = (x @ w["wq"]).reshape(b, cfg.heads_local, hd)  # one rank: all heads
    qr, ck_cache, cv_cache = _kv_major_q(q_all, ck_cache, cv_cache, cfg)
    valid = (rank * s_loc + torch.arange(s_loc, device=x.device)) < enc_len
    dt = q_all.dtype
    s_ij = torch.einsum("bkgd,bskd->bkgs", qr.float(), ck_cache.to(dt).float()) \
        * (1.0 / math.sqrt(hd))
    s_ij = s_ij.masked_fill(~valid, float("-inf"))
    m = torch.amax(s_ij, dim=-1)
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s_ij - m_safe[..., None]).masked_fill(~valid, 0.0)
    l_ = p.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(dt).float(), cv_cache.to(dt).float())
    o = (o / torch.clamp(l_, min=1e-30)[..., None]).reshape(b, cfg.n_heads, hd)
    if cfg.n_heads_padded > cfg.n_heads:
        o = torch.nn.functional.pad(o, (0, 0, 0, cfg.n_heads_padded - cfg.n_heads))
    return decode_out_proj(o, w, cfg, x.dtype, rank)


def decode_new_kv(x, w: dict, cfg: AttnConfig, cos, sin):
    """This token's q (all padded heads) and k1/v1 (B, n_kv, hd); cos/sin
    (hd//2,) shared or (B, hd//2) per slot."""
    b, _ = x.shape
    hd = cfg.head_dim
    q, k1, v1 = (_proj(x, w, n) for n in "qkv")
    q = q.reshape(b, cfg.heads_local, hd)
    k1 = k1.reshape(b, cfg.kv_local, hd)
    v1 = v1.reshape(b, cfg.kv_local, hd)
    cb = cos[None] if cos.ndim == 1 else cos[:, None]
    sb = sin[None] if sin.ndim == 1 else sin[:, None]
    q = apply_rope(q[:, None], cb, sb)[:, 0]
    k1 = apply_rope(k1[:, None], cb, sb)[:, 0]
    return q, k1, v1  # one model rank: nothing to all-gather


def chunk_new_kv(x, w: dict, cfg: AttnConfig, cos, sin):
    """Multi-token :func:`decode_new_kv` for chunked prefill: x (B, Lq, d),
    cos/sin (B, Lq, hd//2) per slot and token.  Returns (q_all (B, Lq, Hp,
    hd), k1/v1 (B, Lq, n_kv, hd)), the shapes the KV cache stores."""
    b, lq, _ = x.shape
    hd = cfg.head_dim
    q, k1, v1 = (_proj(x, w, n) for n in "qkv")
    q = apply_rope(q.reshape(b, lq, cfg.heads_local, hd), cos, sin)
    k1 = apply_rope(k1.reshape(b, lq, cfg.kv_local, hd), cos, sin)
    return q, k1, v1.reshape(b, lq, cfg.kv_local, hd)  # one model rank


def ring_slot(pos: torch.Tensor, window: int, s_loc: int, rank: int = 0):
    """Ring addressing of (per-slot) positions: (local index, is_mine)."""
    slot = torch.remainder(pos, window)
    owner = torch.div(slot, s_loc, rounding_mode="floor")
    return slot - owner * s_loc, owner == rank


def slot_valid_mask(pos: torch.Tensor) -> torch.Tensor:
    """THE dead-lane test: ``pos >= 0``."""
    return pos >= 0


# Paged block-pool addressing (``serve/kv_pool.py``).  The pool keeps the
# ring tensors' shape, (R, S_row, n_kv, hd) per layer, each row read as
# S_row // block_loc physical blocks of block_loc = block_size // tp tokens;
# a slot's logical ring maps through its block table bt[j] -> physical id,
# logical position p in logical block (p % window) // block_size.  Attend
# gathers a slot's blocks into logical order first, so the math downstream
# is the ring math on the gathered view, whatever the placement.


def paged_gather_kv(cache: torch.Tensor, block_tables: torch.Tensor,
                    block_loc: int) -> torch.Tensor:
    """(R, S_row, n_kv, hd) pool -> (B, n_log * block_loc, n_kv, hd), each
    slot's logical view through its table (B, n_log) of physical ids.  Read
    only: unallocated entries (< 0) read block 0, positions the caller's
    validity mask excludes (they lie past the slot's write head)."""
    r, s_row, nk, hd = cache.shape
    bpr = s_row // block_loc
    pool = cache.reshape(r * bpr, block_loc, nk, hd)
    b, n_log = block_tables.shape
    return pool[block_tables.clamp(0, r * bpr - 1)].reshape(b, n_log * block_loc, nk, hd)


def paged_s_glob(window: int, block_size: int, block_loc: int, rank: int = 0,
                 device=None) -> torch.Tensor:
    """Global ring offsets of this rank's slice of the gathered view: index
    i sits in logical block i // block_loc at offset rank * block_loc +
    i % block_loc."""
    i = torch.arange((window // block_size) * block_loc, device=device)
    return (i // block_loc) * block_size + rank * block_loc + i % block_loc


def paged_slot(pos: torch.Tensor, window: int, block_size: int, block_loc: int,
               block_tables: torch.Tensor, rank: int = 0):
    """Paged write addressing of positions pos (B,) or (B, Lq) through
    block_tables (B, n_log): (pool row, row seq index, is_mine).  Writers
    keep only the targets of valid positions that this rank holds, and
    whose table entry is allocated (>= 0): there is no drop mode to send
    the others to."""
    lp = torch.remainder(pos, window)
    j = torch.div(lp, block_size, rounding_mode="floor")
    o = lp - j * block_size
    phys = torch.gather(block_tables, 1, j.reshape(j.shape[0], -1)).reshape(j.shape)
    bpr = window // block_size  # pool rows are ring-length
    row = torch.div(phys, bpr, rounding_mode="floor")
    seq = (phys - row * bpr) * block_loc + o % block_loc
    return row, seq, torch.div(o, block_loc, rounding_mode="floor") == rank


def _kv_major_q(q_all, k_cache, v_cache, cfg: AttnConfig):
    *lead, _, hd = q_all.shape
    if cfg.n_heads == cfg.n_kv * cfg.group:
        return (q_all[..., : cfg.n_heads, :].reshape(*lead, cfg.n_kv, cfg.group, hd),
                k_cache, v_cache)
    kv_idx = (torch.arange(cfg.n_heads, device=q_all.device) // cfg.group).clamp(
        0, cfg.n_kv - 1)
    return (q_all[..., : cfg.n_heads, :].reshape(*lead, cfg.n_heads, 1, hd),
            k_cache[:, :, kv_idx], v_cache[:, :, kv_idx])


def decode_attend(q_all, k_cache, v_cache, cfg: AttnConfig, pos: torch.Tensor,
                  window: int, block_tables=None, block_size: int = 0,
                  rank: int = 0) -> torch.Tensor:
    """Decode attention over the ring cache without a GQA-expanded copy:
    q (B, Hp, hd) at per-slot positions pos (B,) against k/v (B, S_loc,
    n_kv, hd), the token's own KV already written; operands in their own
    dtype, f32 accumulation.  A chunk's queries (B, Lq, Hp, hd) at (B, Lq)
    positions take the same math (``chunk_attend``): each query sees the
    slots whose held position is causally visible.  With `block_tables`
    the caches are the (R, S_row, ...) paged pool, gathered into each
    slot's logical view first.  Returns q's shape in f32."""
    *lead, hp, hd = q_all.shape
    if block_tables is not None:
        bl_loc = block_size // cfg.tp
        k_cache = paged_gather_kv(k_cache, block_tables, bl_loc)
        v_cache = paged_gather_kv(v_cache, block_tables, bl_loc)
        s_glob = paged_s_glob(window, block_size, bl_loc, rank, q_all.device)
    else:
        s_loc = k_cache.shape[1]
        s_glob = rank * s_loc + torch.arange(s_loc, device=q_all.device)
    qr, k_cache, v_cache = _kv_major_q(q_all, k_cache, v_cache, cfg)
    # slot s holds position p_s = pos - ((pos - s) mod W)
    p_s = pos[..., None] - torch.remainder(pos[..., None] - s_glob, window)
    valid = ((p_s >= 0) & slot_valid_mask(pos)[..., None])[..., None, None, :]
    sc, pv = (("blkgd,bskd->blkgs", "blkgs,bskd->blkgd") if len(lead) == 2
              else ("bkgd,bskd->bkgs", "bkgs,bskd->bkgd"))
    dt = q_all.dtype
    s_ij = torch.einsum(sc, qr.float(), k_cache.to(dt).float()) * (1.0 / math.sqrt(hd))
    s_ij = s_ij.masked_fill(~valid, float("-inf"))
    m = torch.amax(s_ij, dim=-1)
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s_ij - m_safe[..., None]).masked_fill(~valid, 0.0)
    l_ = p.sum(-1)
    o = torch.einsum(pv, p.to(dt).float(), v_cache.to(dt).float())
    o = (o / torch.clamp(l_, min=1e-30)[..., None]).reshape(*lead, cfg.n_heads, hd)
    if hp > cfg.n_heads:
        o = torch.nn.functional.pad(o, (0, 0, 0, hp - cfg.n_heads))
    return o


# the reference's chunk_attend (attention.py:321): decode_attend's math over
# a chunk's (B, Lq) queries
chunk_attend = decode_attend


def decode_out_proj(o, w: dict, cfg: AttnConfig, dtype, rank: int = 0):
    """(B, Hp, hd) f32 -> (B, d) via this rank's slice of the row-parallel wo."""
    b = o.shape[0]
    o_loc = o[:, rank * cfg.heads_local:(rank + 1) * cfg.heads_local].to(dtype)
    return tp_reduce(o_loc.reshape(b, cfg.heads_local * cfg.head_dim) @ w["wo"])
