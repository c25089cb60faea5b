"""Mamba2 (state-space duality) mixer, the JAX package's ``models/mamba.py``
at one rank: the chunked SSD scan for prefill and the O(1)-state recurrence
for decode.

The chunked SSD algorithm follows Dao & Gu (2024), Listing 1:

    y_t = C_t^T h_t,   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T

split into an intra-chunk part (quadratic within a chunk, through the
1-semiseparable decay mask) and an inter-chunk recurrence over the chunk
summaries, a Python loop here where the reference has ``lax.scan``.  The
gated RMSNorm is per head (group-norm style), as in the reference.

Training differentiates the mixer by autograd, the chunk loop included;
softplus, the causal conv and the decay mask carry their own backward or
form (see each), with the reference's gradient.

Every dtype move is the reference's: the projections run in the compute
dtype, the x-branch conv in the compute dtype and the B/C conv in f32, the
scan and the state in f32.  The f32 products are plain PyTorch ops (the JAX
package computes them outside any Pallas kernel).  The inner dimension is
TP-sharded in the reference; the port runs at tp = 1, where ``tp_copy`` and
``tp_reduce`` are the identity, and refuses more ranks (ROADMAP A11h).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.tp import tp_copy, tp_reduce


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int  # N
    head_dim: int  # P
    expand: int
    conv_k: int
    chunk: int
    tp: int

    def __post_init__(self):
        if self.tp != 1:
            raise NotImplementedError(f"the Mamba2 mixer over tp = {self.tp} ranks is not "
                                      "ported yet (ROADMAP A11h); the port runs at tp = 1")

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim

    @property
    def heads_local(self) -> int:
        return self.n_heads // self.tp

    @property
    def d_inner_local(self) -> int:
        return self.heads_local * self.head_dim


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` = logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    with the reference's gradient: logaddexp's JVP, exp(x - softplus(x)) (=
    sigmoid(x); 0.5 at x = 0, where the composite's autograd gives 1)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        inf = float("inf")
        return g * torch.exp(torch.where(x == inf, 0.0, x) - torch.where(out == inf, 0.0, out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


class _CausalConv(torch.autograd.Function):
    """Depthwise causal conv, forward by ``F.conv1d``; the backward as K
    shifted products summed in f32 (plain reductions: cuDNN's depthwise
    weight gradient may sum with atomics, and a train step must repeat bit
    for bit)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        k = w.shape[1]
        xt = F.pad(x.transpose(1, 2), (k - 1, 0))
        return F.conv1d(xt, w[:, None, :], groups=x.shape[-1]).transpose(1, 2)

    @staticmethod
    def backward(ctx, dy):
        # y[t] = sum_j xp[t + j] w[j], xp = x behind K - 1 zeros
        x, w = ctx.saved_tensors
        s, k = x.shape[1], w.shape[1]
        dy, wf = dy.float(), w.float()
        dyp = F.pad(dy, (0, 0, 0, k - 1))
        dx = sum(dyp[:, k - 1 - j:k - 1 - j + s] * wf[:, j] for j in range(k))
        xp = F.pad(x.float(), (0, 0, k - 1, 0))
        dw = torch.stack([(dy * xp[:, j:j + s]).sum(dim=(0, 1)) for j in range(k)], dim=1)
        return dx.to(x.dtype), dw.to(w.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (C, K); in x's dtype."""
    return _CausalConv.apply(x, w.to(x.dtype))


def segsum_decay(da_cs: torch.Tensor) -> torch.Tensor:
    """L[..., i, j, h] = exp(cumsum_i - cumsum_j) masked to j <= i.

    The mask goes inside the exponent (exp(-inf) = 0).  The reference masks
    after it: above the diagonal diff = sum |dt a| > 0, so once a chunk's
    sum passes ~88.7 exp overflows to inf there, and the masked entries'
    gradient 0 * inf is NaN in every parameter (zamba2-7b's train cell
    reaches ~135 at its third step).  The values are the reference's bit
    for bit, and so is the gradient wherever the reference's is finite."""
    q = da_cs.shape[2]
    diff = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=da_cs.device))
    return torch.exp(torch.where(mask[None, None, :, :, None], diff, -torch.inf))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P) f32, dt (B, S, H) f32 post-softplus, a (H,) f32
    negative, bmat/cmat (B, S, N), h0 (B, H, P, N) an initial state.
    Returns (y (B, S, H, P), final state (B, H, P, N))."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        # dt = 0 steps: decay exp(0 a) = 1 and contribution dt B x = 0, so the
        # final state is exactly preserved
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    l = (s + pad) // q
    xc = x.reshape(b, l, q, h, p)
    dtc = dt.reshape(b, l, q, h)
    bc = bmat.reshape(b, l, q, n)
    cc = cmat.reshape(b, l, q, n)

    da_cs = torch.cumsum(dtc * a, dim=2)  # (b,l,q,h)

    # intra-chunk (quadratic, chunk-local)
    decay = segsum_decay(da_cs)  # (b,l,q,q,h)
    scores = torch.einsum("blin,bljn->blij", cc, bc)
    att = scores[..., None] * decay * dtc[:, :, None, :, :]
    y = torch.einsum("blijh,bljhp->blihp", att, xc)

    # chunk summary states
    decay_to_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)  # (b,l,q,h)
    s_chunk = torch.einsum("bljn,bljhp->blhpn", bc, (dtc * decay_to_end)[..., None] * xc)

    # inter-chunk recurrence
    chunk_decay = torch.exp(da_cs[:, :, -1, :])  # (b,l,h)
    hprev = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device) if h0 is None else h0
    hprevs = []
    for c in range(l):
        hprevs.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    y = y + torch.einsum("blin,blhpn->blihp", cc, torch.stack(hprevs, 1)) \
        * torch.exp(da_cs)[..., None]
    return y.reshape(b, l * q, h, p)[:, :s], hprev


def _gated_headnorm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMSNorm of y * silu(z).  y/z: (B, S, H, P); w: (H*P,)."""
    b, s, h, p = y.shape
    g = y * F.silu(z)
    var = torch.mean(g.float() ** 2, dim=-1, keepdim=True)
    g = (g.float() * torch.rsqrt(var + eps)).to(y.dtype)
    return g.reshape(b, s, h * p) * w.to(y.dtype)


def mamba2_block(x: torch.Tensor, w: dict, cfg: MambaConfig, return_state: bool = False):
    """Prefill forward of x (B, S, d).  Weights (gathered): w_z, w_x (d,
    d_inner); w_bc (d, 2N); w_dt (d, H); conv_x (d_inner, K); conv_bc (2N,
    K); a_log, dt_bias, d_skip (H,); norm (d_inner,); w_out (d_inner, d).
    With `return_state`, also (conv_x state (B, K-1, d_inner) in the compute
    dtype, conv_bc state (B, K-1, 2N) rounded to it, final SSM state (B, H,
    P, N) f32).  A prompt shorter than K-1 tokens has no whole conv state
    and raises ValueError (the reference returns fewer rows)."""
    b, s, _ = x.shape
    hl, p, n, k = cfg.heads_local, cfg.head_dim, cfg.d_state, cfg.conv_k
    if return_state and s < k - 1:
        raise ValueError(f"a prompt of {s} tokens is shorter than the conv state's "
                         f"{k - 1} rows (conv_k {k}); prefill needs at least {k - 1}")
    xi = tp_copy(x)
    z = xi @ w["w_z"]
    xin = xi @ w["w_x"]
    bc = (xi @ w["w_bc"]).float()
    dt_raw = xi @ w["w_dt"]

    xin_raw, bc_raw = xin, bc  # pre-conv inputs (the decode conv state)
    xin = F.silu(_causal_conv(xin, w["conv_x"]))
    bc = F.silu(_causal_conv(bc, w["conv_bc"]))
    bmat, cmat = bc[..., :n], bc[..., n:]

    dt = softplus(dt_raw.float() + w["dt_bias"].float())
    a = -torch.exp(w["a_log"].float())

    xh = xin.reshape(b, s, hl, p).float()
    y, h_final = ssd_chunked(xh, dt, a, bmat, cmat, cfg.chunk)
    y = y + xh * w["d_skip"].float()[None, None, :, None]
    y = y.to(x.dtype)

    g = _gated_headnorm(y, z.reshape(b, s, hl, p), w["norm"])
    out = tp_reduce(g @ w["w_out"])
    if not return_state:
        return out
    return out, (xin_raw[:, s - (k - 1):], bc_raw[:, s - (k - 1):].to(x.dtype), h_final)


def mamba2_decode(x: torch.Tensor, w: dict, cfg: MambaConfig, conv_state: torch.Tensor,
                  ssm_state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One recurrent step of x (B, d); conv_state (B, K-1, d_inner + 2N) f32,
    ssm_state (B, H, P, N) f32.  Returns (out, conv_state, ssm_state)."""
    b, _ = x.shape
    hl, p, n = cfg.heads_local, cfg.head_dim, cfg.d_state
    xi = tp_copy(x)
    z = xi @ w["w_z"]
    xin = xi @ w["w_x"]
    bc = xi @ w["w_bc"]
    dt_raw = xi @ w["w_dt"]

    # conv over the ring of the last K-1 inputs and the current one
    cat = torch.cat([xin, bc.to(xin.dtype)], dim=-1)  # (B, C)
    hist = torch.cat([conv_state, cat[:, None].to(conv_state.dtype)], dim=1)  # (B, K, C) f32
    conv_w = torch.cat([w["conv_x"], w["conv_bc"].to(w["conv_x"].dtype)], dim=0).float()
    conv_out = F.silu((hist.float() * conv_w.T[None]).sum(dim=1))  # "bkc,ck->bc"
    new_conv_state = hist[:, 1:]

    d_il = cfg.d_inner_local
    xin_c = conv_out[:, :d_il]
    bmat = conv_out[:, d_il:d_il + n]
    cmat = conv_out[:, d_il + n:]

    dt = softplus(dt_raw.float() + w["dt_bias"].float())  # (B, H)
    a = -torch.exp(w["a_log"].float())
    da = torch.exp(dt * a)
    xh = xin_c.reshape(b, hl, p)
    new_state = (ssm_state * da[:, :, None, None]
                 + (dt[:, :, None] * xh)[..., None] * bmat[:, None, None, :])  # "bh,bn,bhp->bhpn"
    y = (new_state * cmat[:, None, None, :]).sum(dim=-1)  # "bn,bhpn->bhp"
    y = y + xh * w["d_skip"].float()[None, :, None]

    g = _gated_headnorm(y[:, None].to(x.dtype), z.reshape(b, 1, hl, p), w["norm"])[:, 0]
    return tp_reduce(g @ w["w_out"]), new_conv_state, new_state
