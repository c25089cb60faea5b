"""Checkpoints cross-load between the port and the JAX package (format
``qsdp-ckpt-v2``, (1, 1) mesh, gpt-1.3b smoke config), on the CPU.

QuantizedParam leaves (8-bit shift-rounded master weights, 8-bit nearest
Adam moments) travel as their wire bytes, so every leaf is held byte-equal
both ways; the port's own save -> load resumes bit-exact.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.quant import QuantConfig as JQuantConfig, qparam_encode as jqparam_encode
from repro.optim import AdamWConfig as JAdamWConfig, make_adamw as jmake_adamw
from repro.optim import OptState as JOptState
from repro.train import load_checkpoint as jload, save_checkpoint as jsave
from repro.train.step import (TrainState as JTrainState, init_train_state as jinit,
                              quantize_train_state as jquantize_state, state_pspecs)
from repro_torch.core import prng
from repro_torch.core.quant import QuantizedParam
from repro_torch.optim import AdamWConfig, make_adamw
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.step import build_train_step, init_train_state, quantize_train_state
from _torch_train_common import batches, models


def _leaf_bytes(leaf):
    """(kind, bytes, shape) of a leaf of either package."""
    if hasattr(leaf, "wire"):
        w = leaf.wire
        return "q", np.asarray(w.numpy() if isinstance(w, torch.Tensor) else w).tobytes(), \
            tuple(leaf.cell_shape)
    a = leaf.detach().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    return "d", a.tobytes(), a.shape


def _assert_states_equal(a, b):
    assert int(a.opt.step) == int(b.opt.step)
    for ta, tb in ((a.params, b.params), (a.opt.mu, b.opt.mu), (a.opt.nu, b.opt.nu)):
        assert sorted(ta) == sorted(tb)
        for k in ta:
            assert _leaf_bytes(ta[k]) == _leaf_bytes(tb[k]), k


def _jax_quantized_state():
    """A JAX quantized-domain state with non-zero 8-bit moments, step 5."""
    jm, tm = models()
    opt = jmake_adamw(JAdamWConfig(moment_bits=8))
    s = jquantize_state(jinit(jm, opt, jax.random.PRNGKey(0)), jm, jax.random.PRNGKey(1))
    mq = JQuantConfig(bits=8, mode="nearest")
    rng = np.random.default_rng(0)

    def moment(p):
        return jqparam_encode(rng.standard_normal(np.shape(p)).astype(np.float32) * 1e-3, mq)

    base = jinit(jm, opt, jax.random.PRNGKey(0)).params
    opt_state = JOptState(step=np.int32(5), mu={k: moment(v) for k, v in base.items()},
                          nu={k: moment(v) for k, v in base.items()})
    return jm, tm, JTrainState(params=s.params, opt=opt_state)


def test_jax_checkpoint_loads_in_port(tmp_path):
    _, _, js = _jax_quantized_state()
    jsave(str(tmp_path), js)
    ts = load_checkpoint(str(tmp_path), device="cpu")
    assert any(isinstance(v, QuantizedParam) for v in ts.params.values())
    assert all(isinstance(v, QuantizedParam) for v in ts.opt.mu.values())
    _assert_states_equal(js, ts)


def test_port_checkpoint_loads_in_jax(tmp_path, mesh11):
    jm, tm, _ = _jax_quantized_state()
    opt = make_adamw(AdamWConfig(moment_bits=8))
    ts = quantize_train_state(init_train_state(tm, opt, 0, "cpu"), tm, prng.PRNGKey(1))
    step = build_train_step(tm, opt, n_micro=2, quantized_state=True, device="cpu")
    ts, _ = step(ts, {k: torch.from_numpy(v).long() for k, v in batches(1)[0].items()},
                 prng.PRNGKey(2))
    save_checkpoint(str(tmp_path), ts, meta={"arch": tm.cfg.name})
    with open(os.path.join(tmp_path, "manifest.json")) as f:
        man = json.load(f)
    assert man["format"] == "qsdp-ckpt-v2"
    assert man["mesh"] == {"model_size": 1, "fsdp_size": 1}
    js = jload(str(tmp_path), mesh11,
               state_pspecs(jm, quantized_state=True, quantized_moments=True))
    _assert_states_equal(ts, js)


def test_dense_checkpoint_roundtrip_and_resume(tmp_path):
    _, tm = models()
    opt = make_adamw(AdamWConfig())
    step = build_train_step(tm, opt, n_micro=2, device="cpu")
    b = [{k: torch.from_numpy(v).long() for k, v in x.items()} for x in batches(2)]
    s, _ = step(init_train_state(tm, opt, 0, "cpu"), b[0], prng.PRNGKey(3))
    save_checkpoint(str(tmp_path), s)
    loaded = load_checkpoint(str(tmp_path), device="cpu")
    _assert_states_equal(s, loaded)
    s, m1 = step(s, b[1], prng.PRNGKey(4))
    loaded, m2 = step(loaded, b[1], prng.PRNGKey(4))
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_states_equal(s, loaded)


def test_bad_checkpoints_raise(tmp_path):
    _, tm = models()
    save_checkpoint(str(tmp_path), init_train_state(tm, make_adamw(AdamWConfig()), 0, "cpu"))
    mpath = os.path.join(tmp_path, "manifest.json")
    with open(mpath) as f:
        man = json.load(f)
    with pytest.raises(NotImplementedError, match="ROADMAP A3b"):
        load_checkpoint(str(tmp_path), device="cpu", mesh_sizes=(1, 2))
    for edit, err in ((lambda m: m.update(format="qsdp-ckpt-v9"), "unknown checkpoint format"),
                      (lambda m: m["leaves"].pop("opt/step"), "leaf set mismatch"),
                      (lambda m: m["leaves"]["params/embed"].update(shape=[1]), "corrupted")):
        bad = json.loads(json.dumps(man))
        edit(bad)
        with open(mpath, "w") as f:
            json.dump(bad, f)
        with pytest.raises(ValueError, match=err):
            load_checkpoint(str(tmp_path), device="cpu")


@pytest.mark.parametrize("shape,bits", [((1, 1, 3000), 8), ((3, 1, 1, 2048), 4), ((1, 1, 700), 2)])
def test_qparam_encode_decode_byte_equal(shape, bits):
    """``qparam_encode``/``qparam_decode`` against the JAX package's on the
    same rest-layout leaf and key (shift rounding): wire bytes and decoded
    values byte-equal, wire length as ``qparam_wire_nbytes`` says."""
    from repro.core.quant import qparam_decode as jdecode
    from repro_torch.core.quant import (QuantConfig, qparam_decode, qparam_encode,
                                        qparam_wire_nbytes)
    x = np.random.default_rng(bits).standard_normal(shape).astype(np.float32)
    jq = jqparam_encode(x, JQuantConfig(bits=bits, mode="shift"), jax.random.PRNGKey(4))
    cfg = QuantConfig(bits=bits, mode="shift")
    tq = qparam_encode(torch.from_numpy(x), cfg, prng.PRNGKey(4))
    assert tq.cell_shape == jq.cell_shape and tq.wire.shape[-1] == qparam_wire_nbytes(
        tq.cell_shape, cfg)
    assert tq.wire.numpy().tobytes() == np.asarray(jq.wire).tobytes()
    assert qparam_decode(tq).numpy().tobytes() == np.asarray(jdecode(jq)).tobytes()
    assert qparam_decode(tq).shape == shape


def test_v1_checkpoint_loads_in_port(tmp_path):
    jm, _ = models()
    js = jinit(jm, jmake_adamw(JAdamWConfig()), jax.random.PRNGKey(0))
    jsave(str(tmp_path), js, format_version=1)
    _assert_states_equal(js, load_checkpoint(str(tmp_path), device="cpu"))
