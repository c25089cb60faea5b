"""MoE training's other modes on the CPU, olmoe-1b-7b's smoke config (set-up
in ``_torch_train_common.py``):

  (e) the quantized_state step bit-exact with the quantize_master step
      (losses, grad norms, params and 8-bit moments);
  (f) a v2 checkpoint of a MoE train state (3-D expert stacks, the fp
      router, 8-bit master codes and moments) cross-loads between the port
      and the JAX package, every leaf byte-equal, both ways;
  (g) ``launch.train --arch olmoe-1b-7b --smoke --device cpu`` trains.
"""
import json

import jax
import numpy as np
import pytest
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
from repro_torch.train.step import (build_train_step, dequantize_train_state,
                                    init_train_state, quantize_train_state)
from _torch_train_common import LR, N_MICRO, batches, models
from test_torch_checkpoint import _assert_states_equal

ARCH = "olmoe-1b-7b"


def _torch_batches(n):
    return [{k: torch.from_numpy(v).long() for k, v in b.items()} for b in batches(n)]


def test_moe_quantized_state_bitexact_with_quantize_master():
    _, tm = models(arch=ARCH)
    opt = make_adamw(AdamWConfig(lr=LR, moment_bits=8))
    qs = quantize_train_state(init_train_state(tm, opt, 0, "cpu"), tm, prng.PRNGKey(9))
    assert isinstance(qs.params["layers/w_gate"], QuantizedParam)
    assert not isinstance(qs.params["layers/router"], QuantizedParam)  # an fp segment
    fs = dequantize_train_state(qs)
    step_q = build_train_step(tm, opt, n_micro=N_MICRO, quantized_state=True, device="cpu")
    step_f = build_train_step(tm, opt, n_micro=N_MICRO, quantize_master=True, device="cpu")
    for i, b in enumerate(_torch_batches(3)):
        qs, mq = step_q(qs, b, prng.fold_in(prng.PRNGKey(7), i))
        fs, mf = step_f(fs, b, prng.fold_in(prng.PRNGKey(7), i))
        assert float(mq["loss"]) == float(mf["loss"])
        assert float(mq["grad_norm"]) == float(mf["grad_norm"])
    dq, df = dequantize_train_state(qs), dequantize_train_state(fs)
    for tree_q, tree_f in ((dq.params, df.params), (dq.opt.mu, df.opt.mu), (dq.opt.nu, df.opt.nu)):
        for k in tree_f:
            assert torch.equal(tree_q[k], tree_f[k]), k


def test_moe_jax_checkpoint_loads_in_port(tmp_path):
    jm, _ = models(arch=ARCH)
    opt = jmake_adamw(JAdamWConfig(moment_bits=8))
    base = jinit(jm, opt, jax.random.PRNGKey(0)).params
    s = jquantize_state(jinit(jm, opt, jax.random.PRNGKey(0)), jm, jax.random.PRNGKey(1))
    rng, mq = np.random.default_rng(0), JQuantConfig(bits=8, mode="nearest")

    def moment(p):
        return jqparam_encode(rng.standard_normal(np.shape(p)).astype(np.float32) * 1e-3, mq)

    js = JTrainState(params=s.params, opt=JOptState(
        step=np.int32(3), mu={k: moment(v) for k, v in base.items()},
        nu={k: moment(v) for k, v in base.items()}))
    jsave(str(tmp_path), js)
    ts = load_checkpoint(str(tmp_path), device="cpu")
    assert ts.params["layers/w_down"].stacked and ts.params["layers/w_down"].wire.shape[0] == 1
    assert ts.params["layers/router"].shape == (2, 1, 1, 256 * 4)
    _assert_states_equal(js, ts)


def test_moe_port_checkpoint_loads_in_jax(tmp_path, mesh11):
    jm, tm = models(arch=ARCH)
    opt = make_adamw(AdamWConfig(moment_bits=8))
    ts = quantize_train_state(init_train_state(tm, opt, 0, "cpu"), tm, prng.PRNGKey(1))
    step = build_train_step(tm, opt, n_micro=N_MICRO, quantized_state=True, device="cpu")
    ts, _ = step(ts, _torch_batches(1)[0], prng.PRNGKey(2))
    save_checkpoint(str(tmp_path), ts, meta={"arch": tm.cfg.name})
    with open(tmp_path / "manifest.json") as f:
        assert json.load(f)["format"] == "qsdp-ckpt-v2"
    js = jload(str(tmp_path), mesh11,
               state_pspecs(jm, quantized_state=True, quantized_moments=True))
    _assert_states_equal(ts, js)


@pytest.mark.parametrize("flags", [[], ["--quantized-state", "--moment-bits", "8",
                                        "--n-micro", "2"]])
def test_train_launcher_moe(flags, tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    out_json = tmp_path / "log.json"
    rc = launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                            "--batch", "4", "--seq", "32", "--log-every", "1",
                            "--out-json", str(out_json), *flags])
    out = capsys.readouterr().out
    assert rc == 0 and "olmoe-smoke" in out
    log = json.loads(out_json.read_text())["log"]
    assert len(log) == 2 and all(np.isfinite(r["loss"]) and np.isfinite(r["gnorm"]) for r in log)
