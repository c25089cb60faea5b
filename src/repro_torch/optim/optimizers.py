"""Optimizers over QSDP rest-layout parameters (the JAX package's
``repro.optim``).

Every optimizer state tensor is shaped like its parameter's rest-layout
shard, and the updates are elementwise.  The paper trains GPT with AdamW
(Table 4: betas (0.9, 0.95), eps 1e-8) and analyses plain SGD (Theorem 2).

The updates run in place on the f32 parameter and moment tensors they are
given (the JAX step donates them), so a step holds one copy of the state.
They walk every leaf in chunks (:func:`chunk_ranges`): a stacked leaf by
layer slice, a large unstacked one in bucket-aligned ranges, each chunk
through the same op sequence the whole leaf would take, so the result is
byte-equal to a whole-leaf update and no temporary is larger than a chunk.
Moments kept as wire codes (``AdamWConfig.moment_bits``) are decoded chunk
by chunk (K2, both moments in one launch), updated in f32 and re-encoded
into their own wire in place (K1): a chunk owns whole buckets, so the codes
are those of encoding the whole updated leaf.  ``update`` consumes its
`grads`: each chunk's gradient is dropped once used, and a stacked leaf's
gradient may come as a list of its layer slices (the train step's).
Scalars (learning rate, bias corrections) are f32 0-dim tensors, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, NamedTuple, Optional

import torch

from ..core.quant import (QuantConfig, QuantizedParam, qparam_decode, qparam_encode,
                          qparam_encode_range, qparam_range)
from ..kernels import ops

Params = dict[str, torch.Tensor]


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


class OptState(NamedTuple):
    step: int
    mu: Any  # first moment / momentum (dict like params) or ()
    nu: Any  # second moment or ()


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """(init, update) pair; update(params, grads, state, grad_scale) returns
    (new params, new state), updating in place and consuming `grads`."""

    init: Callable[[Params], OptState]
    update: Callable[..., tuple[Params, OptState]]
    quantized_moments: bool = False


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable[[int], torch.Tensor]:
    """Linear warmup, then cosine decay to min_ratio * base_lr (the MosaicML
    LLM recipe the paper trains with); f32 arithmetic as in the reference."""

    def lr(step: int) -> torch.Tensor:
        s = _f32(step)
        warm = base_lr * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)

    return lr


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 6e-4
    b1: float = 0.9
    b2: float = 0.95  # paper Table 4
    eps: float = 1e-8
    weight_decay: float = 0.0
    schedule: Optional[Callable[[int], torch.Tensor]] = None
    # store mu/nu as wire codes of this width (nearest rounding); None = f32
    moment_bits: Optional[int] = None


MOMENT_BUCKET_SIZE = 1024  # the JAX AdamWConfig's default moment bucket
# an unstacked leaf is updated in ranges of at most this many values (128 MiB
# of f32): the embeddings (olmoe-1b-7b's 103 M values, qwen2-vl-72b's 1.25 G)
CHUNK_VALUES = 1 << 25


def chunk_ranges(shape: tuple) -> list[tuple[int, int]]:
    """The flat ranges [a, b) a rest-layout leaf of `shape` is updated in: a
    stacked leaf (rank 4) by layer slice where a slice holds whole moment
    buckets (MOMENT_BUCKET_SIZE values), else whole; an unstacked leaf in
    ranges of at most CHUNK_VALUES that start on a bucket boundary.  On the
    one-rank layout a leaf's flat order is its moment codes' cell order, so
    every range owns whole buckets of them."""
    bucket = MOMENT_BUCKET_SIZE
    n = math.prod(shape)
    if len(shape) == 4:
        s = n // shape[0]
        return [(i * s, (i + 1) * s) for i in range(shape[0])] if s % bucket == 0 else [(0, n)]
    step = max(CHUNK_VALUES // bucket, 1) * bucket
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def _grad_chunks(grads: dict, name: str, ranges) -> Iterator[torch.Tensor]:
    """Leaf `name`'s gradient over `ranges` (flat views), taken out of
    `grads`: a list of layer slices yields slice i for range i, each dropped
    once handed out (joined first where the ranges are not the slices); a
    tensor yields its ranges."""
    g = grads.pop(name)
    if isinstance(g, (list, tuple)):
        if len(g) == len(ranges):
            g = list(g)[::-1]
            while g:  # the generator keeps no reference to a slice it handed out
                yield g.pop().reshape(-1)
            return
        g = torch.cat([s.reshape(-1) for s in g])
    flat = g.reshape(-1)
    del g
    for a, b in ranges:
        yield flat[a:b]


class _Moment:
    """One moment leaf as the update walks it: an f32 tensor updated in
    place by flat ranges, or codes in the optimizer's own format (a
    QuantizedParam) decoded by range and re-encoded in place.  Codes of
    another format are decoded whole to f32 first; an f32 moment of an
    optimizer that keeps codes (a dequantized state's) is encoded whole at
    the end (:meth:`result`)."""

    def __init__(self, m, mq: Optional[QuantConfig]):
        self.mq = mq
        self.codes = isinstance(m, QuantizedParam) and m.cfg == mq
        self.m = m if self.codes or not isinstance(m, QuantizedParam) else qparam_decode(m)
        self.flat = None if self.codes else self.m.view(-1)

    def result(self):
        if self.codes or self.mq is None:
            return self.m
        return qparam_encode(self.m, self.mq)


def _decode_ranges(moments: list, a: int, b: int) -> list:
    """Per moment, its f32 values [a, b) and the (nb, bucket) buffer a
    code-form moment's buckets were decoded into (one K2 launch for all of
    them; None for an f32 moment, whose values are a view of it)."""
    coded = [mo for mo in moments if mo.codes]
    bufs = iter(ops.unpack_dequantize_wire(
        [mo.m.wire.view(-1) for mo in coded], [qparam_range(mo.m, a, b) for mo in coded],
        [torch.float32] * len(coded)) if coded else ())
    out = []
    for mo in moments:
        buf = next(bufs) if mo.codes else None
        out.append((mo.flat[a:b], None) if buf is None else (buf.view(-1)[:b - a], buf))
    return out


def _encode_ranges(moments: list, decoded: list, a: int, b: int) -> None:
    """Write the updated buckets of the code-form moments back in place,
    the padding past `b` zeroed as the whole-leaf encode pads it."""
    for mo, (_, buf) in zip(moments, decoded):
        if buf is not None:
            if buf.numel() > b - a:
                buf.view(-1)[b - a:].zero_()
            qparam_encode_range(mo.m, a, buf)


def make_adamw(cfg: AdamWConfig) -> Optimizer:
    mq = (QuantConfig(bits=cfg.moment_bits, bucket_size=MOMENT_BUCKET_SIZE,
                      mode="nearest") if cfg.moment_bits else None)

    def init(params: Params) -> OptState:
        def zeros(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return qparam_encode(z, mq) if mq is not None else z
        return OptState(step=0, mu={k: zeros(v) for k, v in params.items()},
                        nu={k: zeros(v) for k, v in params.items()})

    def update(params: Params, grads: dict, st: OptState, grad_scale=1.0):
        step = st.step + 1
        lr = cfg.schedule(step) if cfg.schedule is not None else _f32(cfg.lr)
        c1 = 1.0 - _f32(cfg.b1) ** _f32(step)
        c2 = 1.0 - _f32(cfg.b2) ** _f32(step)
        mu, nu = {}, {}
        for k, p in params.items():
            pf = p.view(-1)
            moments = [_Moment(st.mu[k], mq), _Moment(st.nu[k], mq)]
            ranges = chunk_ranges(tuple(p.shape))
            for (a, b), g in zip(ranges, _grad_chunks(grads, k, ranges)):
                g = g.float() * grad_scale
                dec = _decode_ranges(moments, a, b)
                (m, _), (v, _) = dec
                m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
                v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
                step_dir = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
                if cfg.weight_decay:
                    step_dir = step_dir + cfg.weight_decay * pf[a:b]
                pf[a:b].sub_(lr * step_dir)
                del g, m, v, step_dir
                _encode_ranges(moments, dec, a, b)
                del dec
            mu[k], nu[k] = (mo.result() for mo in moments)
        return params, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update, quantized_moments=mq is not None)


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.1
    momentum: float = 0.0
    weight_decay: float = 0.0
    schedule: Optional[Callable[[int], torch.Tensor]] = None


def make_sgd(cfg: SGDConfig) -> Optimizer:
    def init(params: Params) -> OptState:
        mu = ({k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
               for k, v in params.items()} if cfg.momentum else ())
        return OptState(step=0, mu=mu, nu=())

    def update(params: Params, grads: dict, st: OptState, grad_scale=1.0):
        step = st.step + 1
        lr = cfg.schedule(step) if cfg.schedule is not None else _f32(cfg.lr)
        for k, p in params.items():
            pf = p.view(-1)
            ranges = chunk_ranges(tuple(p.shape))
            for (a, b), g in zip(ranges, _grad_chunks(grads, k, ranges)):
                d = g.float() * grad_scale
                del g
                if cfg.weight_decay:
                    d = d + cfg.weight_decay * pf[a:b]
                if cfg.momentum:
                    d = st.mu[k].view(-1)[a:b].mul_(cfg.momentum).add_(d)
                pf[a:b].sub_(lr * d)
        return params, OptState(step=step, mu=st.mu, nu=())

    return Optimizer(init=init, update=update)
