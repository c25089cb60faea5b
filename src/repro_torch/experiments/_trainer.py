"""Shared trainer of the accuracy-recovery experiments (Tables 1-3), the
JAX package's ``benchmarks/_trainer.py`` on the port.

Trains a small GPT on the deterministic synthetic Markov corpus with a
given QSDP policy and returns the loss curve.  Runs on the (1, 1) mesh:
with FSDP size 1 the gathers are local, but the quantize -> dequantize of
every transmitted tensor still applies (K1 and K2 on the card), so the
accuracy effect of wire quantization is exactly reproduced.

The initial weights are drawn as the reference draws them (``jax.random``
normals under ``fold_in(PRNGKey(seed), i)`` for the i-th parameter by
name, here through the threefry twin, within a few ulps), the batches are
the reference's ``SyntheticLM`` batches, and step i quantizes under
``fold_in(PRNGKey(seed + 1), i)``: a run starts where the reference's run
starts.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import torch

from ..core import prng
from ..core.qsdp import MeshSpec, QSDPConfig, to_rest
from ..data import SyntheticLM, make_batch
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import Model
from ..optim import AdamWConfig, cosine_schedule, make_adamw
from ..train.step import TrainState, build_train_step

BENCH_MODEL = ModelConfig(
    name="gpt-bench", arch_type="dense", n_layers=2, d_model=192,
    vocab_size=512, n_heads=6, n_kv_heads=6, head_dim=32, d_ff=384,
    rope_theta=10_000.0,
)
MESH11 = MeshSpec(axes=("data", "model"), shape=(1, 1))


@dataclasses.dataclass
class RunResult:
    tag: str
    losses: list  # [(step, loss)]
    final_loss: float
    ppl: float
    seconds: float = 0.0  # wall time of the steps (host clock, synchronized)
    steps: int = 0

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.seconds if self.seconds else 0.0


def init_params_like_reference(model: Model, seed: int, device) -> dict[str, torch.Tensor]:
    """The reference's ``Model.init_params(PRNGKey(seed))`` drawn with the
    threefry twin: parameter i (by sorted name) is a normal under
    ``fold_in(PRNGKey(seed), i)`` times its scale, in the rest layout."""
    key = prng.PRNGKey(seed)
    out = {}
    for i, (name, spec) in enumerate(sorted(model.specs.items())):
        shape = ((spec.stack,) if spec.stack is not None else ()) + spec.shape
        if spec.init == "zeros":
            full = torch.zeros(shape, device=device)
        elif spec.init == "ones":
            full = torch.ones(shape, device=device)
        elif spec.init == "constant":
            full = torch.full(shape, spec.init_scale, device=device)
        elif spec.init in ("normal", "scaled_normal"):
            scale = spec.init_scale
            if spec.init == "scaled_normal":
                scale /= math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
            full = prng.normal(prng.fold_in(key, i), shape, device) * scale
        else:
            raise ValueError(spec.init)
        out[name] = to_rest(full, spec, model.ms)
    return out


def train_run(qsdp: QSDPConfig, steps: int = 200, batch: int = 8, seq: int = 128,
              lr: float = 2e-3, seed: int = 0, tag: str = "", model_cfg=None,
              eval_last: int = 5, device=None,
              state: Optional[TrainState] = None) -> RunResult:
    """`steps` AdamW steps (cosine schedule, 20 warm-up steps) of
    `model_cfg` (BENCH_MODEL by default) under `qsdp` on `device` (the card
    unless given).  Logs the loss every 10 steps and at each of the last
    `eval_last`, whose mean is the final loss.  `state` replaces the
    initial train state (the tests start from the reference's)."""
    cfg = model_cfg or BENCH_MODEL
    device = resolve_device(device)
    model = Model(cfg, MESH11, qsdp)
    opt = make_adamw(AdamWConfig(lr=lr, schedule=cosine_schedule(lr, 20, steps)))
    if state is None:
        params = init_params_like_reference(model, seed, device)
        state = TrainState(params=params, opt=opt.init(params))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                       seed=seed, branching=4)
    step = build_train_step(model, opt, n_micro=1, device=device)
    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(steps):
        b = make_batch(data, i, device)
        state, m = step(state, b, prng.fold_in(prng.PRNGKey(seed + 1), i))
        if i % 10 == 0 or i >= steps - eval_last:
            losses.append((i, float(m["loss"])))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    tail = [l for _, l in losses[-eval_last:]]
    final = sum(tail) / len(tail)
    return RunResult(tag=tag, losses=losses, final_loss=final,
                     ppl=float(torch.exp(torch.tensor(final, dtype=torch.float32))),
                     seconds=seconds, steps=steps)


def qsdp_wg(w: int | None, g: int | None, **kw) -> QSDPConfig:
    """w/g = bits or None for full precision; min_quant_size small so the
    bench model's tensors are actually quantized."""
    return QSDPConfig(
        quantize_weights=w is not None, quantize_grads=g is not None,
        weight_bits=w or 8, grad_bits=g or 8, min_quant_size=256, **kw,
    )


def run_line(r: RunResult) -> str:
    """Wall time and rate of a run, as the experiments print them."""
    return f"({r.seconds:.1f} s, {r.steps_per_s:.2f} steps/s)"
