"""Shared model building blocks (the dense-family subset of the JAX
package's ``models/layers.py``).

Conventions (see ``core/tp.py``): activations entering TP-sharded compute
pass through ``tp_copy``, row-parallel outputs through ``tp_reduce``; all
weights are gathered TP-local tensors.  ``rank`` is this process's index on
the model axis and ``group`` its model group (None: the sums are the
identity, so a caller can compute one rank's share alone).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import prng
from ..core.tp import model_max, model_sum, tp_copy, tp_reduce
from ..kernels import ops
from ..kernels.ops import RowQuantWeight, rowquant_matmul


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: tuple[int, ...]):
    """Qwen2-VL's multimodal RoPE: positions (3, ...) hold the temporal /
    height / width streams; the head_dim//2 frequencies are split into
    `sections` (summing to head_dim//2) and section s rotates with stream s.
    Returns cos/sin of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to head_dim // 2 = {half}")
    cos, sin, start = [], [], 0
    for s, sec in enumerate(sections):
        c, si = rope_cos_sin(positions[s], head_dim, theta)
        cos.append(c[..., start:start + sec])
        sin.append(si[..., start:start + sec])
        start += sec
    return torch.cat(cos, dim=-1), torch.cat(sin, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., n_heads, head_dim); cos/sin broadcastable (..., head_dim//2);
    the rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def embed_vocab_parallel(tokens: torch.Tensor, emb_local: torch.Tensor,
                         rank: int = 0, group=None) -> torch.Tensor:
    """tokens (B, S) int; emb_local (V_local, d), this rank's vocab shard.
    Out-of-shard ids contribute zero; tp_reduce combines the shards over
    the model group (reference ``layers.py:95-108``)."""
    v_local = emb_local.shape[0]
    ids = tokens.long() - rank * v_local
    in_range = (ids >= 0) & (ids < v_local)
    out = emb_local[ids.clamp(0, v_local - 1)]
    out = torch.where(in_range[..., None], out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))
    return tp_reduce(out, group)


class _VocabParallelXent(torch.autograd.Function):
    """Mean token cross-entropy over f32 logits of the (T, V_local) vocab
    shard, with the reference's own backward (``layers.py:112-176``): the
    backward recomputes the logits instead of keeping them.  Over the model
    group the row max is the ranks' max (``pmax``) and the exp-sums and the
    picked targets are the ranks' sums; h is replicated, so its cotangent
    sums every rank's ``dlogits @ w``."""

    @staticmethod
    def forward(ctx, h, w_local, labels, rank, group):
        logits = vocab_parallel_logits(h, w_local)
        m = model_max(torch.amax(logits, dim=-1), group)
        se = model_sum(torch.sum(torch.exp(logits - m[:, None]), dim=-1), group)
        ids, in_range, mask = _label_parts(w_local, labels, rank)
        n = torch.clamp(mask.sum(), min=1.0)
        tgt = model_sum(torch.where(in_range, logits.gather(1, ids[:, None])[:, 0],
                                    logits.new_zeros(())), group)
        loss = torch.sum((torch.log(se) + m - tgt) * mask) / n
        ctx.save_for_backward(h, w_local, labels, m, se, n)
        ctx.rank, ctx.group = rank, group
        return loss

    @staticmethod
    def backward(ctx, ct):
        h, w_local, labels, m, se, n = ctx.saved_tensors
        hf, wf = h.float(), w_local.float()
        p = torch.exp(hf @ wf.T - m[:, None]) / se[:, None]  # logits recomputed
        ids, in_range, mask = _label_parts(w_local, labels, ctx.rank)
        onehot = torch.zeros_like(p).scatter_(1, ids[:, None], in_range[:, None].float())
        dlogits = (p - onehot) * (mask * ct / n)[:, None]
        dh = model_sum(dlogits @ wf, ctx.group).to(h.dtype)
        dw = (dlogits.T @ hf).to(w_local.dtype)
        return dh, dw, None, None, None


def _label_parts(w_local, labels, rank: int = 0):
    """(label ids clipped into this rank's vocab shard, in-shard mask,
    f32 label mask (negative labels are masked out))."""
    v_local = w_local.shape[0]
    ids = labels.long() - rank * v_local
    in_range = (ids >= 0) & (ids < v_local)
    return ids.clamp(0, v_local - 1), in_range, (labels >= 0).float()


def vocab_parallel_xent(h: torch.Tensor, w_local: torch.Tensor, labels: torch.Tensor,
                        rank: int = 0, group=None) -> torch.Tensor:
    """Mean token cross-entropy with vocab-parallel logits.  h (T, d),
    w_local (V_local, d), model rank `rank`'s vocab shard, labels (T,)
    global ids (negative = masked).  Logits are f32 at full f32 matmul
    precision."""
    return _VocabParallelXent.apply(h, w_local, labels, rank, group)


def vocab_parallel_logits(h: torch.Tensor, w_local: torch.Tensor) -> torch.Tensor:
    """(T, d) -> (T, V_local) local logit shard, f32."""
    return h.float() @ w_local.float().T


def greedy_sample_vocab_parallel(logits_local: torch.Tensor, v_local: int,
                                 rank: int = 0) -> torch.Tensor:
    """Argmax over the model-sharded vocab (first index on ties), (T,)."""
    return torch.argmax(logits_local, dim=-1) + rank * v_local


def sample_vocab_parallel(logits_local: torch.Tensor, v_local: int, temp: torch.Tensor,
                          top_k: torch.Tensor, key: torch.Tensor, rank: int = 0) -> torch.Tensor:
    """Per-row temperature / top-k sampling (``layers.py:195-236`` of the JAX
    package, one model rank).  logits_local (T, V) f32 on any device; the
    per-row state lives on the host: temp (T,) f32 (<= 0: greedy), top_k
    (T,) int (<= 0: whole vocabulary, 1: greedy), key (T, 2) u32 keys as
    int64.  Rows with temp <= 0 or top_k == 1 take the greedy argmax bit for
    bit and draw nothing; the others draw ``jax.random.gumbel(key_row, (V,))``
    (bits by ``kernels.ops.random_bits``: one launch for all drawn rows), keep
    the logits at or above their k-th largest, and take the argmax of
    logits / max(temp, 1e-6) + noise.  A row's token depends on its own
    inputs only."""
    greedy = greedy_sample_vocab_parallel(logits_local, v_local, rank)
    rows = torch.nonzero(~((temp <= 0.0) | (top_k == 1))).flatten()
    if rows.numel() == 0:
        return greedy
    dev = logits_local.device
    rows_d = rows.to(dev)
    lg = logits_local[rows_d]  # one model rank: the local shard is the whole vocab
    v = lg.shape[1]
    k = top_k[rows].to(torch.int64)
    kth = torch.sort(lg, dim=-1).values.gather(1, (v - k.clamp(1, v)).to(dev)[:, None])
    keep = (k <= 0).to(dev)[:, None] | (lg >= kth)
    noise = prng.gumbel_from_bits(ops.random_bits(prng.as_i32(key[rows]).to(dev), v))
    z = lg / temp[rows].to(torch.float32).clamp(min=1e-6).to(dev)[:, None] + noise
    out = greedy.clone()
    out[rows_d] = torch.argmax(z.masked_fill(~keep, float("-inf")), dim=-1) + rank * v_local
    return out


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a dense w, or through the rowquant kernel (K3) for a
    :class:`RowQuantWeight` still in wire-code form."""
    if isinstance(w, RowQuantWeight):
        lead = x.shape[:-1]
        y = rowquant_matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                            w.codes, w.scale, w.zero)
        return y.reshape(*lead, w.codes.shape[1])
    return x @ w


def swiglu_mlp(x: torch.Tensor, w_gate, w_up, w_down, group=None) -> torch.Tensor:
    """Column-parallel gate/up, row-parallel down over the model group;
    weights dense or RowQuantWeights."""
    xi = tp_copy(x, group)
    g = qmatmul(xi, w_gate)
    u = qmatmul(xi, w_up)
    return tp_reduce(qmatmul(F.silu(g) * u, w_down), group)
