"""Shared model building blocks (the dense-family subset of the JAX
package's ``models/layers.py``).

Conventions (see ``core/tp.py``): activations entering TP-sharded compute
pass through ``tp_copy``, row-parallel outputs through ``tp_reduce``; all
weights are gathered TP-local tensors.  ``rank`` is this process's index on
the model axis (0 on the one-rank mesh of this slice).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.tp import tp_copy, tp_reduce
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


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., n_heads, head_dim); cos/sin broadcastable (..., head_dim//2);
    the rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def embed_vocab_parallel(tokens: torch.Tensor, emb_local: torch.Tensor,
                         rank: int = 0) -> torch.Tensor:
    """tokens (B, S) int; emb_local (V_local, d), this rank's vocab shard.
    Out-of-shard ids contribute zero; tp_reduce combines the shards."""
    v_local = emb_local.shape[0]
    ids = tokens.long() - rank * v_local
    in_range = (ids >= 0) & (ids < v_local)
    out = emb_local[ids.clamp(0, v_local - 1)]
    out = torch.where(in_range[..., None], out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))
    return tp_reduce(out)


class _VocabParallelXent(torch.autograd.Function):
    """Mean token cross-entropy over f32 logits of the (T, V_local) vocab
    shard, with the reference's own backward (``layers.py:112-176``): the
    backward recomputes the logits instead of keeping them.  On one model
    rank the reference's pmax/psum over the model axis are the identity."""

    @staticmethod
    def forward(ctx, h, w_local, labels):
        logits = vocab_parallel_logits(h, w_local)
        m = torch.amax(logits, dim=-1)
        se = torch.sum(torch.exp(logits - m[:, None]), dim=-1)
        ids, in_range, mask = _label_parts(w_local, labels)
        n = torch.clamp(mask.sum(), min=1.0)
        tgt = torch.where(in_range, logits.gather(1, ids[:, None])[:, 0],
                          logits.new_zeros(()))
        loss = torch.sum((torch.log(se) + m - tgt) * mask) / n
        ctx.save_for_backward(h, w_local, labels, m, se, n)
        return loss

    @staticmethod
    def backward(ctx, ct):
        h, w_local, labels, m, se, n = ctx.saved_tensors
        hf, wf = h.float(), w_local.float()
        p = torch.exp(hf @ wf.T - m[:, None]) / se[:, None]  # logits recomputed
        ids, in_range, mask = _label_parts(w_local, labels)
        onehot = torch.zeros_like(p).scatter_(1, ids[:, None], in_range[:, None].float())
        dlogits = (p - onehot) * (mask * ct / n)[:, None]
        dh = (dlogits @ wf).to(h.dtype)
        dw = (dlogits.T @ hf).to(w_local.dtype)
        return dh, dw, None


def _label_parts(w_local, labels, rank: int = 0):
    """(label ids clipped into this rank's vocab shard, in-shard mask,
    f32 label mask (negative labels are masked out))."""
    v_local = w_local.shape[0]
    ids = labels.long() - rank * v_local
    in_range = (ids >= 0) & (ids < v_local)
    return ids.clamp(0, v_local - 1), in_range, (labels >= 0).float()


def vocab_parallel_xent(h: torch.Tensor, w_local: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy with vocab-parallel logits.  h (T, d),
    w_local (V_local, d), labels (T,) global ids (negative = masked).
    Logits are f32 at full f32 matmul precision."""
    return _VocabParallelXent.apply(h, w_local, labels)


def vocab_parallel_logits(h: torch.Tensor, w_local: torch.Tensor) -> torch.Tensor:
    """(T, d) -> (T, V_local) local logit shard, f32."""
    return h.float() @ w_local.float().T


def greedy_sample_vocab_parallel(logits_local: torch.Tensor, v_local: int,
                                 rank: int = 0) -> torch.Tensor:
    """Argmax over the model-sharded vocab (first index on ties), (T,)."""
    return torch.argmax(logits_local, dim=-1) + rank * v_local


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a dense w, or through the rowquant kernel (K3) for a
    :class:`RowQuantWeight` still in wire-code form."""
    if isinstance(w, RowQuantWeight):
        lead = x.shape[:-1]
        y = rowquant_matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                            w.codes, w.scale, w.zero)
        return y.reshape(*lead, w.codes.shape[1])
    return x @ w


def swiglu_mlp(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """Column-parallel gate/up, row-parallel down; weights dense or
    RowQuantWeights."""
    xi = tp_copy(x)
    g = qmatmul(xi, w_gate)
    u = qmatmul(xi, w_up)
    return tp_reduce(qmatmul(F.silu(g) * u, w_down))
