"""Shortlist measurement (the JAX package's ``tune/measure.py``): run the
port's real train step for a handful of timed steps per candidate, so the
plan's final ranking rests on measured medians, not only on the analytic
model."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core import prng
from ..core.qsdp import MeshSpec, QSDPConfig, layer_gather_launches
from ..device import resolve_device
from ..models.transformer import Model
from ..optim import AdamWConfig, make_adamw
from ..train.step import build_train_step, init_train_state


def measure_train_step(mcfg, ms: MeshSpec, qcfg: QSDPConfig, batch: dict,
                       *, n_micro: int = 1, steps: int = 3, seed: int = 0,
                       device=None) -> dict:
    """Median per-step wall ms of `qcfg` on the given model and batch (the
    first step and one more untimed step excluded), by the host clock
    between two synchronizations of the card, plus the analytic launch
    count so the plan records what the measurement exercised.  Runs on the
    card unless `device` says otherwise.  ``compile_s`` is the first step's
    time (the reference's jit compile; here the kernels' first launches)."""
    device = resolve_device(device)
    model = Model(mcfg, ms, qcfg)
    opt = make_adamw(AdamWConfig(lr=1e-3))
    state = init_train_state(model, opt, seed, device)
    step = build_train_step(model, opt, n_micro=n_micro, device=device)
    key = prng.PRNGKey(seed + 7)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    times = []
    sync()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, key)
    float(metrics["loss"])
    sync()
    compile_s = time.perf_counter() - t0
    # one more untimed step so the timed loop sees the steady state
    state, metrics = step(state, batch, prng.fold_in(key, -1))
    float(metrics["loss"])
    for i in range(steps):
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, prng.fold_in(key, i))
        float(metrics["loss"])
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    layer_names = [n for n in model.specs if n.startswith("layers/")]
    return {
        "step_ms_median": float(np.median(times)),
        "step_ms_all": [float(t) for t in times],
        "compile_s": float(compile_s),
        "loss_final": float(metrics["loss"]),
        "layer_gather_launches": layer_gather_launches(model.engine, layer_names),
    }
