"""The train step: gradient accumulation over microbatches, the
QSDP-wired backward, global-norm clipping and the optimizer update (the
JAX package's ``train/step.py`` on one rank).

Schedule per optimizer step (paper Figure 5 + Appendix A):

  for each of n_micro microbatches:
      for each layer:  quantized AllGather(w)   -> forward
      for each layer:  quantized AllGather(w)   -> backward (recompute)
                       quantized ReduceScatter(g)
  grads averaged over microbatches
  AdamW update of the f32 master shards
  [optional] Q^w re-quantization of the master (Theorem 2)

``quantize_master=True`` round-trips the f32 master through Q^w each step;
``quantized_state=True`` keeps every master-eligible parameter AS its wire
codes (:class:`~repro_torch.core.quant.QuantizedParam`), decoded at step
entry and re-encoded at exit under the same keys (``fold_in(key,
0x3A57E9)``, then ``_h(name)``), so the two are bit-exact.

The reference wraps the step in ``shard_map`` + ``jit``
(``make_jitted_train_step``); at one rank the per-device step is the step.
The update runs in place on the state's f32 tensors (the reference donates
them).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..core import prng
from ..core.quant import (QuantConfig, QuantizedParam, qparam_decode, qparam_encode,
                          quantize_dequantize)
from ..device import resolve_device
from ..models.transformer import Model
from ..optim import Optimizer, OptState


class TrainState(NamedTuple):
    params: dict[str, Any]  # f32 rest-layout leaves and/or QuantizedParam
    opt: OptState


def init_train_state(model: Model, optimizer: Optimizer, seed: int, device) -> TrainState:
    params = model.init_params(seed, device)
    return TrainState(params=params, opt=optimizer.init(params))


_MASTER_SALT = 0x3A57E9
_h = prng.stable_hash  # the per-name key salt of the reference's train step


def master_quant_config(model: Model, master_bits: int = 8) -> QuantConfig:
    """The Q^w the master weights are re-quantized with (Theorem 2: random
    shift rounding at the engine's bucket granularity)."""
    return QuantConfig(bits=master_bits, bucket_size=model.qcfg.bucket_size, mode="shift")


def master_eligible(model: Model, name: str) -> bool:
    """The params the master quantization applies to: the wire filter (norms,
    biases and tiny tensors stay full precision)."""
    spec = model.specs[name]
    return bool(spec.quantize
                and spec.n_logical_local(model.ms.model_size) >= model.qcfg.min_quant_size)


def quantize_train_state(state: TrainState, model: Model, key: prng.Key,
                         master_bits: int = 8) -> TrainState:
    """Every master-eligible f32 param leaf -> QuantizedParam, under the key
    schedule a train step with `key` uses; moments stay as they are."""
    qc = master_quant_config(model, master_bits)
    mkey = prng.fold_in(key, _MASTER_SALT)
    params = {name: (qparam_encode(p, qc, prng.fold_in(mkey, _h(name)))
                     if master_eligible(model, name) and not isinstance(p, QuantizedParam)
                     else p)
              for name, p in state.params.items()}
    return TrainState(params=params, opt=state.opt)


def _decode_leaves(tree, copy: bool = False):
    if tree == ():
        return tree
    return {k: qparam_decode(v) if isinstance(v, QuantizedParam) else (v.clone() if copy else v)
            for k, v in tree.items()}


def dequantize_train_state(state: TrainState) -> TrainState:
    """Decode every QuantizedParam leaf (params and moments) to f32: exactly
    the values a ``quantize_master=True`` step would have stored.  The
    result shares no tensor with `state` (steps update in place)."""
    return TrainState(params=_decode_leaves(state.params, copy=True),
                      opt=OptState(step=state.opt.step,
                                   mu=_decode_leaves(state.opt.mu, copy=True),
                                   nu=_decode_leaves(state.opt.nu, copy=True)))


def build_train_step(model: Model, optimizer: Optimizer, n_micro: int = 1,
                     grad_clip: float = 1.0, quantize_master: bool = False,
                     master_bits: int = 8, quantized_state: bool = False, device=None):
    """Returns ``step(state, batch, key) -> (state, metrics)``.  Runs on the
    card unless `device` says otherwise (raises when there is no card and
    none was asked for); `batch` ({"tokens", "labels"} (B, S)) is moved
    there.  metrics: loss (microbatch mean), grad_norm (before clipping),
    step."""
    device = resolve_device(device)
    if quantize_master and quantized_state:
        raise ValueError("quantize_master and quantized_state are mutually exclusive")

    def step(state: TrainState, batch: dict, key: prng.Key):
        params = _decode_leaves(state.params) if quantized_state else state.params
        names = sorted(params)
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        micro = {}
        for k, x in batch.items():
            if x.shape[0] % n_micro:
                raise ValueError(f"batch {k} of {x.shape[0]} rows does not split into "
                                 f"{n_micro} microbatches")
            micro[k] = x.to(device).reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
        acc, losses = None, []
        for i in range(n_micro):
            loss = model.loss_fn(leaves, {k: v[i] for k, v in micro.items()},
                                 prng.fold_in(key, i))
            gs = torch.autograd.grad(loss, [leaves[k] for k in names])
            acc = list(gs) if acc is None else [a + g for a, g in zip(acc, gs)]
            losses.append(loss.detach())
            del loss, gs
        grads = {k: g / n_micro for k, g in zip(names, acc)}
        del acc, leaves

        # global-norm clip (every element lives on exactly one rank)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(grads[k])) for k in names))
        scale = (torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
                 if grad_clip else torch.ones((), device=device))
        with torch.no_grad():
            new_params, new_opt = optimizer.update(params, grads, state.opt, grad_scale=scale)
            del grads
            new_params = dict(new_params)
            if quantize_master or quantized_state:
                qc = master_quant_config(model, master_bits)
                mkey = prng.fold_in(key, _MASTER_SALT)
                for name in names:
                    if not master_eligible(model, name):
                        continue
                    pkey = prng.fold_in(mkey, _h(name))
                    p = new_params[name]
                    new_params[name] = (qparam_encode(p, qc, pkey) if quantized_state
                                        else quantize_dequantize(p, qc, pkey))
        metrics = {"loss": torch.stack(losses).mean(), "grad_norm": gnorm,
                   "step": new_opt.step}
        return TrainState(params=new_params, opt=new_opt), metrics

    return step
