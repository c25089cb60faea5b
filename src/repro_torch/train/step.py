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

Under ``QSDPConfig(prefetch=True)`` each stack's forward gathers layer i+1
while layer i computes (``Model._scan_layers``), and the backward
recomputes each layer from the wire buffer its forward gathered: the
replay's AllGather(w) above becomes a decode of that buffer, with no
encode.  On the card the starts run on the engine's side CUDA stream; each
start waits for everything queued on the compute stream before it, so the
first gather of a step reads the master after the previous step's
in-place update.  The step itself is unchanged.

``quantize_master=True`` round-trips the f32 master through Q^w each step;
``quantized_state=True`` keeps every master-eligible parameter AS its wire
codes (:class:`~repro_torch.core.quant.QuantizedParam`), decoded at step
entry and re-encoded at exit under the same keys (``fold_in(key,
0x3A57E9)``, then ``_h(name)``), so the two are bit-exact.

The reference wraps the step in ``shard_map`` + ``jit``
(``make_jitted_train_step``); the port's step is the per-device step.  Over
a (P, M) mesh (the model's engine holds the rank's data and model groups)
each rank steps its own block of the state on its data rank's rows of the
batch (:func:`local_batch`; the rows are replicated over the model axis,
the reference's ``batch_pspec P("data")``); the gathers and
reduce-scatters exchange over the data group, tensor parallelism sums over
the model group, the gradient norm's sum of squares is summed over all P·M
ranks (the reference's ``psum`` over every axis) and the loss averaged over
them (``pmean``).  As in the reference, a model-replicated leaf (a norm,
replicated KV) holds its whole gradient on each of the M model ranks, so
the norm counts it M times (ROADMAP C10: the clip threshold's meaning
depends on M).  On a (Q, D, M) ("pod", "data", "model") mesh the data
rank is the data-major FSDP index ``d·Q + q`` (the reference's
``batch_pspec P(("data", "pod"))``), the loss and norm sum over the flat
FSDP group, and the engine's exchanges take two levels under
``hierarchical``.  The update runs in place on the state's f32 tensors (the
reference donates them).

The memory schedule holds one copy of the state and one set of gradients,
and no second copy of any leaf: every layer slice of a stacked leaf is its
own autograd leaf, a view of the master's storage, whose ``.grad`` the
backward of each microbatch sums into in place (microbatch 0, then 1, the
order of the reference's sum) as soon as that layer's reduce-scatter
returns; the global norm and the optimizer walk the gradients chunk by
chunk (``optim.chunk_ranges``) and release each chunk once consumed.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..core import collectives as coll
from ..core import prng
from ..core.tp import model_sum
from ..core.quant import (QuantConfig, QuantizedParam, qparam_decode, qparam_encode,
                          quantize_dequantize)
from ..device import resolve_device
from ..models.transformer import Model
from ..optim import Optimizer, OptState
from ..optim.optimizers import chunk_ranges


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


def _split(name: str, x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """Batch leaf `name` as (n_micro, microbatch...): split on its batch
    axis, axis 0 but for M-RoPE's "positions" (3, B, S), whose batch axis is
    1 (reference ``train/step.py:182-193``); microbatch i holds rows i *
    B / n_micro onwards."""
    ax = 1 if name == "positions" else 0
    b = x.shape[ax]
    if b % n_micro:
        raise ValueError(f"batch {name} of {b} rows does not split into {n_micro} "
                         "microbatches")
    x = x.movedim(ax, 0)
    return x.reshape(n_micro, b // n_micro, *x.shape[1:]).movedim(1, ax + 1)


def local_batch(batch: dict, rank: int, p: int) -> dict:
    """Data rank `rank`'s rows of a global batch over `p` data ranks: each
    leaf's batch axis (axis 0, but 1 for M-RoPE's "positions") cut into `p`
    blocks, the rank's kept, as the reference's ``batch_pspec P(fsdp_axes)``
    shards it (every model rank of a data rank takes the same rows).  On a
    pod mesh `rank` is the FSDP index ``d·Q + q`` and `p` is Q·D."""
    out = {}
    for name, x in batch.items():
        ax = 1 if name == "positions" else 0
        b = x.shape[ax]
        if b % p:
            raise ValueError(f"batch {name} of {b} rows does not split over {p} ranks")
        out[name] = x.narrow(ax, rank * (b // p), b // p)
    return out


def _leaf(model: Model, name: str, p: torch.Tensor):
    """The autograd leaf (or, for a stacked leaf, the tuple of per-layer
    leaves, views of its slices) the loss reads `p` through."""
    if model.specs[name].stack is None:
        return p.detach().requires_grad_()
    return tuple(p[i].detach().requires_grad_() for i in range(p.shape[0]))


def _take_grad(name: str, leaf, n_micro: int):
    """The microbatch mean of a leaf's summed gradient (a list of layer
    slices for a stacked leaf), divided in place."""
    def g(t):
        if t.grad is None:
            raise RuntimeError(f"no gradient reached {name}")
        return t.grad.div_(n_micro)
    return [g(t) for t in leaf] if isinstance(leaf, tuple) else g(leaf)


def global_norm(grads: dict, group=None, model_group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient value: a stacked leaf's
    sum by layer slice, an unstacked one's by ``chunk_ranges``, so no
    temporary is larger than a chunk (the summation order is not the
    reference's; the value agrees within f32 rounding).  Over the groups
    each rank's sum is summed over the data group and then the model group
    before the root: the reference's psum over every axis, which counts a
    model-replicated leaf once per model rank."""
    parts = []
    for k in sorted(grads):
        g = grads[k]
        chunks = (g if isinstance(g, list)
                  else [g.reshape(-1)[a:b] for a, b in chunk_ranges(tuple(g.shape))])
        parts += [torch.dot(c.reshape(-1), c.reshape(-1)) for c in chunks]
    sq = torch.stack(parts).sum()
    if group is not None:
        sq = coll.all_reduce_sum(sq, group)
    return torch.sqrt(model_sum(sq, model_group))


def build_train_step(model: Model, optimizer: Optimizer, n_micro: int = 1,
                     grad_clip: float = 1.0, quantize_master: bool = False,
                     master_bits: int = 8, quantized_state: bool = False, device=None):
    """Returns ``step(state, batch, key) -> (state, metrics)``.  Runs on the
    card unless `device` says otherwise (raises when there is no card and
    none was asked for); `batch` ({"tokens", "labels"} (B, S), and the
    family's modality inputs, see ``Model.loss_fn``) is moved there and
    split into `n_micro` microbatches on each leaf's batch axis.  Over the
    model's groups `batch` is this rank's data rank's rows
    (:func:`local_batch`).  metrics: loss (microbatch mean, averaged over
    all ranks), grad_norm (before clipping, over the whole mesh), step."""
    device = resolve_device(device)
    group, model_group = model.engine.group, model.engine.model_group
    n_ranks = coll.group_size(group) * coll.group_size(model_group)
    if quantize_master and quantized_state:
        raise ValueError("quantize_master and quantized_state are mutually exclusive")

    def step(state: TrainState, batch: dict, key: prng.Key):
        params = _decode_leaves(state.params) if quantized_state else state.params
        names = sorted(params)
        leaves = {k: _leaf(model, k, v) for k, v in params.items()}
        micro = {k: _split(k, x.to(device), n_micro) for k, x in batch.items()}
        losses = []
        for i in range(n_micro):
            loss = model.loss_fn(leaves, {k: v[i] for k, v in micro.items()},
                                 prng.fold_in(key, i))
            # each leaf's .grad sums in place: one set of gradients, no more
            loss.backward()
            losses.append(loss.detach())
            del loss
        grads = {k: _take_grad(k, leaves[k], n_micro) for k in names}
        del leaves

        # global-norm clip over every rank of the mesh
        gnorm = global_norm(grads, group, model_group)
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
        loss = torch.stack(losses).mean()
        if group is not None:
            loss = coll.all_reduce_sum(loss, group)
        if n_ranks > 1:
            loss = model_sum(loss, model_group) / n_ranks
        metrics = {"loss": loss, "grad_norm": gnorm, "step": new_opt.step}
        return TrainState(params=new_params, opt=new_opt), metrics

    return step
