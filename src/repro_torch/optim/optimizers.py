"""Optimizers over QSDP rest-layout parameters (the JAX package's
``repro.optim``).

Every optimizer state tensor is shaped like its parameter's rest-layout
shard, and the updates are elementwise.  The paper trains GPT with AdamW
(Table 4: betas (0.9, 0.95), eps 1e-8) and analyses plain SGD (Theorem 2).

The updates run in place on the f32 parameter and moment tensors they are
given (the JAX step donates them), so a step holds one copy of the state;
moments kept as wire codes (``AdamWConfig.moment_bits``) are decoded,
updated in f32 and re-encoded.  Scalars (learning rate, bias corrections)
are f32 0-dim tensors, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core.quant import QuantConfig, QuantizedParam, qparam_decode, qparam_encode

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
    (new params, new state)."""

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


def make_adamw(cfg: AdamWConfig) -> Optimizer:
    mq = (QuantConfig(bits=cfg.moment_bits, bucket_size=MOMENT_BUCKET_SIZE,
                      mode="nearest") if cfg.moment_bits else None)

    def init(params: Params) -> OptState:
        def zeros(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return qparam_encode(z, mq) if mq is not None else z
        return OptState(step=0, mu={k: zeros(v) for k, v in params.items()},
                        nu={k: zeros(v) for k, v in params.items()})

    def update(params: Params, grads: Params, st: OptState, grad_scale=1.0):
        step = st.step + 1
        lr = cfg.schedule(step) if cfg.schedule is not None else _f32(cfg.lr)
        c1 = 1.0 - _f32(cfg.b1) ** _f32(step)
        c2 = 1.0 - _f32(cfg.b2) ** _f32(step)
        mu, nu = {}, {}
        for k, p in params.items():
            g = grads[k].float() * grad_scale
            m, v = st.mu[k], st.nu[k]
            m = qparam_decode(m) if isinstance(m, QuantizedParam) else m
            v = qparam_decode(v) if isinstance(v, QuantizedParam) else v
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
            step_dir = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            if cfg.weight_decay:
                step_dir = step_dir + cfg.weight_decay * p
            p.sub_(lr * step_dir)
            mu[k] = qparam_encode(m, mq) if mq is not None else m
            nu[k] = qparam_encode(v, mq) if mq is not None else v
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

    def update(params: Params, grads: Params, st: OptState, grad_scale=1.0):
        step = st.step + 1
        lr = cfg.schedule(step) if cfg.schedule is not None else _f32(cfg.lr)
        for k, p in params.items():
            d = grads[k].float() * grad_scale
            if cfg.weight_decay:
                d = d + cfg.weight_decay * p
            if cfg.momentum:
                d = st.mu[k].mul_(cfg.momentum).add_(d)
            p.sub_(lr * d)
        return params, OptState(step=step, mu=st.mu, nu=())

    return Optimizer(init=init, update=update)
