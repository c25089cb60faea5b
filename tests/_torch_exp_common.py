"""Shared set-up of the experiments tests (``test_torch_experiments*.py``):
``train_run`` of the port against the JAX package's
``benchmarks/_trainer.train_run`` for a few steps from the same state."""
import dataclasses

import jax

from benchmarks import _trainer as jtrainer
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.transformer import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig, make_adamw as jmake_adamw
from repro.train.checkpoint import _flatten as jflatten
from repro.train.step import init_train_state as jinit
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.experiments import _trainer as ttrainer
from repro_torch.models.transformer import Model
from repro_torch.weights import train_state_from_jax
from _torch_train_common import TRAJ_RTOL

JMS = JMeshSpec(("data", "model"), (1, 1))
STEPS = 5

POLICIES = {
    "baseline": (lambda: dataclasses.replace(JQSDPConfig.baseline(), compute_dtype="float32"),
                 lambda: dataclasses.replace(QSDPConfig.baseline(), compute_dtype="float32")),
    "w8g8": (lambda: jtrainer.qsdp_wg(8, 8, compute_dtype="float32"),
             lambda: ttrainer.qsdp_wg(8, 8, compute_dtype="float32")),
    "w4g8-b256": (lambda: jtrainer.qsdp_wg(4, 8, bucket_size=256, compute_dtype="float32"),
                  lambda: ttrainer.qsdp_wg(4, 8, bucket_size=256, compute_dtype="float32")),
    "rtn-nobucket": (lambda: jtrainer.qsdp_wg(8, 8, weight_mode="nearest", grad_mode="nearest",
                                              bucket_size=65536, compute_dtype="float32"),
                     lambda: ttrainer.qsdp_wg(8, 8, weight_mode="nearest", grad_mode="nearest",
                                              bucket_size=65536, compute_dtype="float32")),
}


def check_train_run(policy):
    """5 steps from the same state, same batches and keys: every logged
    loss within TRAJ_RTOL (1e-3 relative: f32 matmul and reduction orders
    differ, and where they straddle a stochastic-rounding threshold a
    gradient code flips by one level)."""
    jq, tq = (f() for f in POLICIES[policy])
    jr = jtrainer.train_run(jq, steps=STEPS, tag=policy)
    jm = JModel(jtrainer.BENCH_MODEL, JMS, jq)
    js = jinit(jm, jmake_adamw(JAdamWConfig(lr=2e-3)), jax.random.PRNGKey(0))
    tm = Model(ttrainer.BENCH_MODEL, ttrainer.MESH11, tq)
    ts = train_state_from_jax(*jflatten(js), device="cpu", model=tm)
    tr = ttrainer.train_run(tq, steps=STEPS, tag=policy, device="cpu", state=ts)
    assert [i for i, _ in tr.losses] == [i for i, _ in jr.losses] == list(range(STEPS))
    for (_, jl), (_, tl) in zip(jr.losses, tr.losses):
        assert abs(tl - jl) <= TRAJ_RTOL * abs(jl), (policy, jr.losses, tr.losses)
    assert abs(tr.final_loss - jr.final_loss) <= TRAJ_RTOL * jr.final_loss
    assert tr.steps == STEPS and tr.seconds > 0
