"""Shared set-up of the training-slice tests (``test_torch_train*.py``):
the port against the JAX package, on the CPU.

gpt-1.3b smoke config on the (1, 1) mesh.  The JAX train state goes through
``weights.train_state_from_jax`` (the checkpoint's flat form) into the
port, so both packages start every step from the same state; batches are
made with numpy and handed to both.  The JAX step is
``make_jitted_train_step(..., mesh11, donate=False)`` on its jnp backend.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import gpt_1_3b as jcfg_mod
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.transformer import Model as JModel
from repro.optim import (AdamWConfig as JAdamWConfig, cosine_schedule as jcosine,
                         make_adamw as jmake_adamw)
from repro.train.checkpoint import _flatten as jflatten
from repro.train.step import init_train_state as jinit, make_jitted_train_step
from repro_torch.configs import gpt_1_3b as tcfg_mod
from repro_torch.core import prng
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
from repro_torch.train.step import build_train_step
from repro_torch.weights import train_state_from_jax

# The port's CPU steps are thousands of small tensor ops: one intra-op
# thread runs them as fast as eight on an idle machine, and keeps them fast
# when the test workers share the cores (with 8 threads per worker a step
# slowed from ~1 s to ~50 s under a loaded 6-worker run).
torch.set_num_threads(1)

B, S, N_MICRO, LR, STEPS = 4, 32, 2, 1e-3, 10
# one f32 step: both sides compute the same function; matmul and reduction
# orders differ by a few ulps (loss ~7: 1e-5 relative is ~100 ulps; the
# grad norm sums ~1.6 M squares in a different order: 1e-4 relative)
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
# updated params: where the two frameworks' cotangents straddle a stochastic
# rounding threshold a gradient code flips by one level, so Adam's first
# step g / (|g| + eps) can change sign there: at most 2*lr apart (|step| <=
# lr, plus f32 rounding of the param), and such flips are rare (<= 0.1 %)
PARAM_ATOL, PARAM_EXACT_SHARE = 1e-6, 0.999
# 10 steps: the flipped codes feed back through the updates; the loss
# trajectories stay within 1e-3 relative (measured ~5e-5 by step 3)
TRAJ_RTOL = 1e-3

JMS = JMeshSpec(("data", "model"), (1, 1))
MS = MeshSpec(("data", "model"), (1, 1))


def digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    return hashlib.sha256(a.tobytes() + str(a.dtype).encode() + str(a.shape).encode()).hexdigest()


def models(baseline=False, **qkw):
    """(JAX Model, port Model) of the smoke config under the same policy."""
    jq = dataclasses.replace(JQSDPConfig.baseline(), **qkw) if baseline else JQSDPConfig(**qkw)
    tq = dataclasses.replace(QSDPConfig.baseline(), **qkw) if baseline else QSDPConfig(**qkw)
    return JModel(jcfg_mod.smoke(), JMS, jq), Model(tcfg_mod.smoke(), MS, tq)


def batches(n):
    rng = np.random.default_rng(0)
    return [{k: rng.integers(0, 1024, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
            for _ in range(n)]


def run_both(jm, tm, n_steps, seed=0):
    """n_steps of the JAX and the port step from the same state.  Returns
    per step (jax loss, port loss, jax gnorm, port gnorm), and (JAX params,
    port params, lr) after step 1, params as numpy."""
    sched = jcosine(LR, 2, STEPS)
    jopt = jmake_adamw(JAdamWConfig(lr=LR, schedule=sched))
    topt = make_adamw(AdamWConfig(lr=LR, schedule=cosine_schedule(LR, 2, STEPS)))
    js = jinit(jm, jopt, jax.random.PRNGKey(seed))
    ts = train_state_from_jax(*jflatten(js), device="cpu", model=tm)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jstep = make_jitted_train_step(jm, jopt, mesh, n_micro=N_MICRO, donate=False)
    tstep = build_train_step(tm, topt, n_micro=N_MICRO, device="cpu")
    rows, first = [], None
    for i, batch in enumerate(batches(n_steps)):
        with mesh:
            js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.fold_in(jax.random.PRNGKey(1), i))
        ts, tmet = tstep(ts, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                         prng.fold_in(prng.PRNGKey(1), i))
        rows.append((float(jmet["loss"]), float(tmet["loss"]),
                     float(jmet["grad_norm"]), float(tmet["grad_norm"])))
        if i == 0:
            first = ({k: np.array(v) for k, v in js.params.items()},
                     {k: v.numpy().copy() for k, v in ts.params.items()},
                     float(sched(jnp.asarray(1))))
    return rows, first


def assert_step_close(rows, first):
    jl, tl, jg, tg = rows[0]
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    assert abs(tg - jg) <= GNORM_RTOL * abs(jg)
    jp, tp, lr = first
    assert sorted(jp) == sorted(tp)
    diffs = np.concatenate([np.abs(jp[k] - tp[k]).ravel() for k in jp])
    assert np.mean(diffs <= PARAM_ATOL) >= PARAM_EXACT_SHARE
    assert diffs.max() <= 2 * lr + PARAM_ATOL
