"""Attention: GQA with the JAX package's tensor-parallel layout, chunked
(flash) attention for training and prefill, and ring-cache decode (dense
family; ``models/attention.py`` of the JAX package).

These are plain PyTorch tensor ops: the JAX package has no Pallas
attention kernel.  Query heads are padded to a multiple of the model-axis
size and padded heads are masked; the KV ring is sequence-sharded over the
model axis.  ``rank`` is the model-axis index (0 on the one-rank mesh).
"""
from __future__ import annotations

import dataclasses
import math

import torch

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
                   cache_slice: bool = False):
    """Training / prefill self-attention.  Returns (out (B, S, d), (k_full,
    v_full) if cache_slice else None), k/v (B, S, n_kv, hd) rope-applied."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    xi = tp_copy(x)
    q, k, v = (_proj(xi, w, n) for n in "qkv")
    q = apply_rope(q.reshape(b, s, cfg.heads_local, hd), cos, sin)
    k = apply_rope(k.reshape(b, s, cfg.kv_local, hd), cos, sin)
    v = v.reshape(b, s, cfg.kv_local, hd)
    o = flash_attention(q, _expand_kv_local(k, cfg), _expand_kv_local(v, cfg),
                        positions, positions, cfg.causal, cfg.sliding_window,
                        cfg.q_chunk, cfg.kv_chunk, cfg.mxu_bf16)
    o = o * _local_head_mask(cfg, x.device)[None, None, :, None].to(o.dtype)
    out = tp_reduce(o.reshape(b, s, cfg.heads_local * hd) @ w["wo"])
    if not cache_slice:
        return out, None
    return out, (k, v)  # one model rank: the local KV heads are all heads


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


def ring_slot(pos: torch.Tensor, window: int, s_loc: int, rank: int = 0):
    """Ring addressing of (per-slot) positions: (local index, is_mine)."""
    slot = torch.remainder(pos, window)
    owner = torch.div(slot, s_loc, rounding_mode="floor")
    return slot - owner * s_loc, owner == rank


def slot_valid_mask(pos: torch.Tensor) -> torch.Tensor:
    """THE dead-lane test: ``pos >= 0``."""
    return pos >= 0


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
                  window: int, rank: int = 0) -> torch.Tensor:
    """Decode attention over the ring cache without a GQA-expanded copy:
    q (B, Hp, hd) against k/v (B, S_loc, n_kv, hd); operands in their own
    dtype, f32 accumulation.  pos (B,) per slot.  Returns (B, Hp, hd) f32."""
    b, hp, hd = q_all.shape
    s_loc = k_cache.shape[1]
    s_glob = rank * s_loc + torch.arange(s_loc, device=q_all.device)
    qr, k_cache, v_cache = _kv_major_q(q_all, k_cache, v_cache, cfg)
    p_s = pos[:, None] - torch.remainder(pos[:, None] - s_glob[None, :], window)
    valid = (p_s >= 0) & slot_valid_mask(pos)[:, None]
    scale = 1.0 / math.sqrt(hd)
    s_ij = torch.einsum("bkgd,bskd->bkgs", qr.float(),
                        k_cache.to(qr.dtype).float()) * scale
    s_ij = s_ij.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = torch.amax(s_ij, dim=-1)
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s_ij - m_safe[..., None]).masked_fill(~valid[:, None, None, :], 0.0)
    l_ = p.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(q_all.dtype).float(),
                     v_cache.to(q_all.dtype).float())
    o = (o / torch.clamp(l_, min=1e-30)[..., None]).reshape(b, cfg.n_heads, hd)
    if hp > cfg.n_heads:
        o = torch.nn.functional.pad(o, (0, 0, 0, hp - cfg.n_heads))
    return o


def decode_out_proj(o, w: dict, cfg: AttnConfig, dtype, rank: int = 0):
    """(B, Hp, hd) f32 -> (B, d) via this rank's slice of the row-parallel wo."""
    b = o.shape[0]
    o_loc = o[:, rank * cfg.heads_local:(rank + 1) * cfg.heads_local].to(dtype)
    return tp_reduce(o_loc.reshape(b, cfg.heads_local * cfg.head_dim) @ w["wo"])
