"""A v2 checkpoint of a zamba2 smoke train state (the un-stacked
``shared/*`` leaves beside the layer stacks, 8-bit master codes and
moments) cross-loads between the port and the JAX package, every leaf
byte-equal, both ways; and the port's own round trip."""
import json

import jax
import numpy as np
import torch

from repro.core.quant import QuantConfig as JQuantConfig, qparam_encode as jqparam_encode
from repro.optim import AdamWConfig as JAdamWConfig, OptState as JOptState
from repro.optim import make_adamw as jmake_adamw
from repro.train import load_checkpoint as jload, save_checkpoint as jsave
from repro.train.step import (TrainState as JTrainState, init_train_state as jinit,
                              quantize_train_state as jquantize_state, state_pspecs)
from repro_torch.core import prng
from repro_torch.core.quant import QuantizedParam
from repro_torch.optim import AdamWConfig, make_adamw
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.step import build_train_step, init_train_state, quantize_train_state
from _torch_train_common import N_MICRO, batches, models
from test_torch_checkpoint import _assert_states_equal

torch.set_num_threads(1)
HYBRID = "zamba2-7b"


def test_hybrid_jax_checkpoint_loads_in_port(tmp_path):
    jm, _ = models(arch=HYBRID)
    opt = jmake_adamw(JAdamWConfig(moment_bits=8))
    s0 = jinit(jm, opt, jax.random.PRNGKey(0))
    base = s0.params
    s = jquantize_state(s0, jm, jax.random.PRNGKey(1))
    rng, mq = np.random.default_rng(0), JQuantConfig(bits=8, mode="nearest")

    def moment(p):
        return jqparam_encode(rng.standard_normal(np.shape(p)).astype(np.float32) * 1e-3, mq)

    js = JTrainState(params=s.params, opt=JOptState(
        step=np.int32(3), mu={k: moment(v) for k, v in base.items()},
        nu={k: moment(v) for k, v in base.items()}))
    jsave(str(tmp_path), js)
    ts = load_checkpoint(str(tmp_path), device="cpu")
    assert isinstance(ts.params["shared/w_gate"], QuantizedParam)
    assert not ts.params["shared/w_gate"].stacked
    assert ts.params["layers/w_z"].stacked
    assert ts.params["shared/attn_norm"].shape == (1, 1, 256)
    _assert_states_equal(js, ts)


def test_hybrid_port_checkpoint_loads_in_jax_and_port(tmp_path, mesh11):
    jm, tm = models(arch=HYBRID)
    opt = make_adamw(AdamWConfig(moment_bits=8))
    ts = quantize_train_state(init_train_state(tm, opt, 0, "cpu"), tm, prng.PRNGKey(1))
    step = build_train_step(tm, opt, n_micro=N_MICRO, quantized_state=True, device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in batches(1)[0].items()}
    ts, _ = step(ts, batch, prng.PRNGKey(2))
    save_checkpoint(str(tmp_path), ts, meta={"arch": tm.cfg.name})
    with open(tmp_path / "manifest.json") as f:
        assert json.load(f)["format"] == "qsdp-ckpt-v2"
    assert any(k.startswith("shared/") for k in ts.params)
    _assert_states_equal(ts, load_checkpoint(str(tmp_path), device="cpu"))
    js = jload(str(tmp_path), mesh11,
               state_pspecs(jm, quantized_state=True, quantized_moments=True))
    _assert_states_equal(ts, js)
