"""Mixture-of-Experts layer, the JAX package's ``models/moe.py`` at one rank.

Dispatch is sort-based: each token's top-k assignments are sorted by expert
id (a stable sort over the flat (token, k) order), an assignment's slot in
its expert's buffer is its place among that expert's assignments, and
assignments past the capacity are dropped (standard capacity-factor
semantics).  The (E, C, d) buffer goes through the experts' SwiGLU as three
batched products, and each token sums its k weighted outputs.

Bit-stable on the card: no step uses atomics.  The dispatch writes only the
kept assignments (each to its own slot; dropped ones land in an overflow row
that is cut away), and the combine adds a token's k contributions one after
another into zeros, in increasing expert id -- the order of the
reference's scatter-add over the sorted assignments -- rounding in the
compute dtype at each add as the reference does.  ``lax.top_k`` breaks ties
by the lower expert id; a stable descending sort does the same.

The layer is differentiable (training, capacity drops included) and its
backward is atomics-free too: the four index moves of the dispatch and the
combine are autograd Functions whose backward is the other move of the
pair, and the sorted top-k weights are a permutation whose backward is the
inverse permutation.  Token -> assignment rows (``_Expand``) sums each token's k slot
gradients one after another in increasing expert id, the order of the
reference's scatter-add transpose; assignment -> slot (``_ToSlots``) and
slot -> assignment (``_FromSlots``) write each kept assignment to its own
slot (dropped ones to the cut-away overflow row, so no gradient flows from
it); assignment -> token (``_Reduce``) is the combine above.

Expert weights are TP-sharded on the expert axis in the reference and
exchanged with all-to-alls over the model axis; the port runs at tp = 1,
where the exchange is the identity, and refuses more ranks (ROADMAP A11h).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.collectives import require_one_rank


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int  # per-expert hidden
    tp: int
    capacity_factor: float = 1.25
    normalize_weights: bool = True  # Qwen3/OLMoE normalize top-k probs
    aux_coef: float = 0.01

    @property
    def experts_local(self) -> int:
        assert self.n_experts % self.tp == 0, (self.n_experts, self.tp)
        return self.n_experts // self.tp

    def capacity(self, n_tokens: int) -> int:
        c = int(n_tokens * self.top_k * self.capacity_factor / self.n_experts)
        return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def dispatch_capacity(cfg: MoEConfig, t: int, no_drop: bool) -> int:
    """Slots per expert for t tokens: drop-free sizes for the worst case
    (every assignment to one expert), else the capacity factor's."""
    return max(8, -(-t * cfg.top_k // 8) * 8) if no_drop else cfg.capacity(t)


class _Softmax(torch.autograd.Function):
    """Softmax over the last axis with the reference's max shift (forward
    as ``jax.nn.softmax`` computes it) and its VJP y * (g - sum(g * y))."""

    @staticmethod
    def forward(ctx, logits):
        u = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        y = u / u.sum(dim=-1, keepdim=True)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return y * (g - (g * y).sum(dim=-1, keepdim=True))


def _sum_rows(rows: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """out[t] = rows[order[t, 0]] + rows[order[t, 1]] + ..., added one after
    another into zeros in the rows' dtype."""
    out = rows.new_zeros((order.shape[0], rows.shape[1]))
    for j in range(order.shape[1]):
        out = out + rows[order[:, j]]
    return out


class _Expand(torch.autograd.Function):
    """Token rows -> assignment rows, x[st]; the backward sums each token's k
    rows in increasing expert id (``order``)."""

    @staticmethod
    def forward(ctx, x, st, order):
        ctx.save_for_backward(order)
        return x[st]

    @staticmethod
    def backward(ctx, g):
        (order,) = ctx.saved_tensors
        return _sum_rows(g, order), None, None


class _Reduce(torch.autograd.Function):
    """Assignment rows -> token rows, the transpose of ``_Expand``."""

    @staticmethod
    def forward(ctx, rows, st, order):
        ctx.save_for_backward(st)
        return _sum_rows(rows, order)

    @staticmethod
    def backward(ctx, g):
        (st,) = ctx.saved_tensors
        return g[st], None, None


class _Permute(torch.autograd.Function):
    """v[perm] for a permutation; the backward is g[inv], inv its inverse."""

    @staticmethod
    def forward(ctx, v, perm, inv):
        ctx.save_for_backward(inv)
        return v[perm]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g[inv], None, None


def _write_slots(rows, se, slot, e, c, drops):
    """(e, c, d) buffer holding row i at [se[i], slot[i]]; with `drops`,
    slot c is the overflow row the dropped rows land in, cut away."""
    buf = rows.new_zeros((e, c + drops, rows.shape[1]))
    buf[se, slot] = rows
    return buf[:, :c] if drops else buf


class _ToSlots(torch.autograd.Function):
    """Assignment rows -> the experts' (e, c, d) slots; the backward reads
    each assignment's slot (the overflow row's zeros for a dropped one)."""

    @staticmethod
    def forward(ctx, rows, se, slot, e, c, drops):
        ctx.save_for_backward(se, slot)
        ctx.drops = drops
        return _write_slots(rows, se, slot, e, c, drops)

    @staticmethod
    def backward(ctx, g):
        se, slot = ctx.saved_tensors
        if ctx.drops:
            g = torch.cat([g, g.new_zeros((g.shape[0], 1, g.shape[2]))], dim=1)
        return g[se, slot], None, None, None, None, None


class _FromSlots(torch.autograd.Function):
    """The experts' slots -> assignment rows, y[se, where(keep, pos, 0)] (a
    dropped assignment reads slot 0 and is weighted by 0); the backward
    writes each kept assignment's row back to its own slot."""

    @staticmethod
    def forward(ctx, y, se, pos0, slot, drops):
        ctx.save_for_backward(se, slot)
        ctx.shape, ctx.drops = y.shape, drops
        return y[se, pos0]

    @staticmethod
    def backward(ctx, g):
        se, slot = ctx.saved_tensors
        e, c, _ = ctx.shape
        return _write_slots(g, se, slot, e, c, ctx.drops), None, None, None, None


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """(probs (T, E) f32, top-k weights (T, k) f32, top-k expert ids (T, k)):
    f32 router logits, softmax, the k largest probabilities (ties to the
    lower id), renormalized when the config says so."""
    probs = _Softmax.apply(x.float() @ router.float())
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = srt.values[:, :cfg.top_k], srt.indices[:, :cfg.top_k]
    if cfg.normalize_weights:
        topw = topw / torch.clamp(topw.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, topw, tope


def moe_layer(x: torch.Tensor, w: dict, cfg: MoEConfig, no_drop: bool = False,
              group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) tokens; w {"router": (d, E), "w_gate"/"w_up": (E, d, ff),
    "w_down": (E, ff, d)}.  Returns (out (T, d) in x's dtype, the
    load-balance aux loss, an f32 scalar).

    no_drop=True sizes every expert's buffer for the worst case, so no
    assignment is ever dropped and a token's output does not depend on the
    other tokens of the call (the serving paths' slot isolation); the
    capacity path drops what the stable sort puts past the capacity."""
    require_one_rank(group, "A11h")
    if cfg.tp != 1:
        raise NotImplementedError(f"expert parallelism over tp = {cfg.tp} ranks is not "
                                  "ported yet (ROADMAP A11h); the port runs at tp = 1")
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = dispatch_capacity(cfg, t, no_drop)
    probs, topw, tope = route(x, w["router"], cfg)

    # Switch-style load-balance auxiliary loss
    me = probs.mean(dim=0)
    ce = F.one_hot(tope, e).to(torch.float32).sum(dim=1).mean(dim=0)
    aux = cfg.aux_coef * e * torch.sum(me * ce)

    # sort-based dispatch: the stable sort of the flat (token, k) assignments
    # by expert; each one's slot is its place among its expert's
    flat_e = tope.reshape(t * k)
    perm = torch.sort(flat_e, stable=True).indices
    se = flat_e[perm]
    st = torch.arange(t, device=x.device).repeat_interleave(k)[perm]
    pos = torch.arange(t * k, device=x.device) - torch.searchsorted(se, se, side="left")
    keep = pos < c
    # each token's sorted positions, ascending: its assignments in
    # increasing expert id, the order of the reference's scatter-add
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(t * k, device=x.device)
    order = torch.sort(inv.reshape(t, k), dim=-1).values
    # dropped assignments write an overflow row (c) that is cut away
    drops = 0 if no_drop else 1
    slot = pos if no_drop else torch.where(keep, pos, c)
    buf = _ToSlots.apply(_Expand.apply(x, st, order), se, slot, e, c, drops)

    h = F.silu(torch.bmm(buf, w["w_gate"].to(x.dtype))) * torch.bmm(buf, w["w_up"].to(x.dtype))
    y = torch.bmm(h, w["w_down"].to(x.dtype))

    sw = _Permute.apply(topw.reshape(t * k), perm, inv)
    rows = _FromSlots.apply(y, se, torch.where(keep, pos, 0), slot, drops)
    return _Reduce.apply(rows * (sw * keep.float()).to(x.dtype)[:, None], st, order), aux
