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

Expert weights are TP-sharded on the expert axis in the reference and
exchanged with all-to-alls over the model axis; the port runs at tp = 1,
where the exchange is the identity, and refuses more ranks (ROADMAP A4b).
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


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """(probs (T, E) f32, top-k weights (T, k) f32, top-k expert ids (T, k)):
    f32 router logits, softmax, the k largest probabilities (ties to the
    lower id), renormalized when the config says so."""
    logits = x.float() @ router.float()
    u = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = u / u.sum(dim=-1, keepdim=True)
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
    require_one_rank(group)
    if cfg.tp != 1:
        raise NotImplementedError(f"expert parallelism over tp = {cfg.tp} ranks is not "
                                  "ported yet (ROADMAP A4b); the port runs at tp = 1")
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
    if no_drop:
        buf = x.new_zeros((e, c, d))
        buf[se, pos] = x[st]
    else:  # dropped assignments write an overflow row (c) that is cut away
        buf = x.new_zeros((e, c + 1, d))
        buf[se, torch.where(keep, pos, c)] = x[st]
        buf = buf[:, :c]

    h = F.silu(torch.bmm(buf, w["w_gate"].to(x.dtype))) * torch.bmm(buf, w["w_up"].to(x.dtype))
    y = torch.bmm(h, w["w_down"].to(x.dtype))

    sw = topw.reshape(t * k)[perm]
    gathered = y[se, torch.where(keep, pos, 0)] * (sw * keep.float()).to(x.dtype)[:, None]
    # each token's sorted positions, ascending: its assignments in
    # increasing expert id, the order of the reference's scatter-add
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(t * k, device=x.device)
    order = torch.sort(inv.reshape(t, k), dim=-1).values
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + gathered[order[:, j]]
    return out, aux
