"""Shared set-up of the training-slice tests (``test_torch_train*.py``):
the port against the JAX package, on the CPU.

gpt-1.3b smoke config (or another arch's, ``models(arch=...)``) on the
(1, 1) mesh; a VLM or audio arch's batches carry its modality inputs.  The
JAX train state goes through ``weights.train_state_from_jax`` (the
checkpoint's flat form) into the port, so both packages start every step
from the same state; batches are made with numpy and handed to both.  The
JAX step is ``make_jitted_train_step(..., mesh11, donate=False)`` on its
jnp backend.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro import configs as jconfigs
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.transformer import Model as JModel
from repro.optim import (AdamWConfig as JAdamWConfig, cosine_schedule as jcosine,
                         make_adamw as jmake_adamw)
from repro.train.checkpoint import _flatten as jflatten
from repro.train.step import (init_train_state as jinit, make_jitted_train_step,
                              state_pspecs)
from repro_torch import configs as tconfigs
from repro_torch.core import prng
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
from repro_torch.train.step import build_train_step
from repro_torch.weights import train_state_from_jax
import _torch_jax_cache  # noqa: F401  (each JAX program compiles once a run)

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


def models(baseline=False, arch="gpt-1.3b", **qkw):
    """(JAX Model, port Model) of `arch`'s smoke config under the same
    policy."""
    jq = dataclasses.replace(JQSDPConfig.baseline(), **qkw) if baseline else JQSDPConfig(**qkw)
    tq = dataclasses.replace(QSDPConfig.baseline(), **qkw) if baseline else QSDPConfig(**qkw)
    return (JModel(jconfigs.get_smoke(arch), JMS, jq),
            Model(tconfigs.get_smoke(arch), MS, tq))


# the VLM train batch's image block: a 2 x 4 patch grid at positions 4-11 of
# every row, its labels masked (-1), as a caption's image tokens are
IMAGE = dict(start=4, rows=2, cols=4)


def batches(n, cfg=None):
    """n batches of B x S tokens and labels, with `cfg`'s modality inputs
    (the reference's train inputs, ``configs/inputs.py:26-43``): VLM, an
    image block (bf16-exact patch embeddings, its mask, Qwen2-VL's (t, h, w)
    positions, ``_torch_mm_common.image_block``); audio, the frame stub
    0.1 * normal of (B, S // enc_frames_ratio, d), bf16-exact.  Numpy
    arrays; floats go to both packages as bf16 (:func:`to_jax`,
    :func:`to_torch`)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        b = {k: rng.integers(0, 1024, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
        family = cfg.arch_type if cfg is not None else None
        if family == "vlm":
            from _torch_mm_common import image_block
            emb, mask, pos = image_block(cfg.d_model, b=B, s=S, seed=11 + i, **IMAGE)
            b["labels"][mask] = -1
            b.update(vision_embeds=emb, vision_mask=mask, positions=pos.astype(np.int32))
        elif family == "audio":
            frames = max(S // cfg.enc_frames_ratio, 1)
            b["audio_embeds"] = (0.1 * rng.standard_normal((B, frames, cfg.d_model))).astype(
                ml_dtypes.bfloat16).astype(np.float32)
        out.append(b)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else None)
            for k, v in batch.items()}


def to_torch(batch):
    def conv(v):
        t = torch.from_numpy(v)
        return (t.to(torch.bfloat16) if t.is_floating_point()
                else t if t.dtype == torch.bool else t.long())
    return {k: conv(v) for k, v in batch.items()}


def run_both(jm, tm, n_steps, seed=0, moment_bits=None, synced=False):
    """n_steps of the JAX and the port step from the same state (AdamW, its
    moments kept as `moment_bits` codes where given).  Returns per step
    (jax loss, port loss, jax gnorm, port gnorm), and (JAX params, port
    params, lr) after step 1, params as numpy.  `synced`: the port starts
    every step from the JAX state (each step a one-step comparison), and
    the second result holds that tuple for every step."""
    sched = jcosine(LR, 2, STEPS)
    jopt = jmake_adamw(JAdamWConfig(lr=LR, schedule=sched, moment_bits=moment_bits))
    topt = make_adamw(AdamWConfig(lr=LR, schedule=cosine_schedule(LR, 2, STEPS),
                                  moment_bits=moment_bits))
    js = jinit(jm, jopt, jax.random.PRNGKey(seed))
    ts = train_state_from_jax(*jflatten(js), device="cpu", model=tm)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    # placed as the step places its output, so that step 2 reuses step 1's
    # compilation
    js = jax.device_put(js, jax.tree.map(
        lambda p: NamedSharding(mesh, p),
        state_pspecs(jm, quantized_moments=moment_bits is not None),
        is_leaf=lambda x: isinstance(x, P)))
    data = batches(n_steps, jm.cfg)
    jstep = make_jitted_train_step(jm, jopt, mesh, n_micro=N_MICRO, donate=False,
                                   batch_pspec={k: P() for k in data[0]})
    tstep = build_train_step(tm, topt, n_micro=N_MICRO, device="cpu")
    rows, after = [], []
    for i, batch in enumerate(data):
        if synced and i:
            ts = train_state_from_jax(*jflatten(js), device="cpu", model=tm)
        with mesh:
            js, jmet = jstep(js, to_jax(batch), jax.random.fold_in(jax.random.PRNGKey(1), i))
        ts, tmet = tstep(ts, to_torch(batch), prng.fold_in(prng.PRNGKey(1), i))
        rows.append((float(jmet["loss"]), float(tmet["loss"]),
                     float(jmet["grad_norm"]), float(tmet["grad_norm"])))
        if i == 0 or synced:
            after.append(({k: np.array(v) for k, v in js.params.items()},
                          {k: v.numpy().copy() for k, v in ts.params.items()},
                          float(sched(jnp.asarray(i + 1)))))
    return rows, after if synced else after[0]


def assert_step_close(rows, first):
    jl, tl, jg, tg = rows[0]
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    assert abs(tg - jg) <= GNORM_RTOL * abs(jg)
    jp, tp, lr = first
    assert sorted(jp) == sorted(tp)
    diffs = np.concatenate([np.abs(jp[k] - tp[k]).ravel() for k in jp])
    assert np.mean(diffs <= PARAM_ATOL) >= PARAM_EXACT_SHARE
    assert diffs.max() <= 2 * lr + PARAM_ATOL
