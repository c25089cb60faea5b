"""The examples' one-rank twins (``repro_torch.examples``) on the CPU:
``learned_levels`` on the JAX package's own yi-6b smoke weights against the
reference's level functions, ``step_comm_bytes`` (``train_gpt_qsdp``'s comm
log) reading 0 at one rank as the reference's (1, 1) mesh does, and the
examples' refusal to fall back to the CPU.  ``quickstart`` and
``train_gpt_qsdp`` run in ``test_torch_examples_train.py``."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import levels as jl
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.core.qsdp import step_comm_bytes as jstep_comm_bytes
from repro.models.transformer import Model as JModel
from repro_torch import configs
from repro_torch.core.qsdp import MeshSpec, QSDPConfig, step_comm_bytes
from repro_torch.examples import learned_levels, quickstart, train_gpt_qsdp
from repro_torch.models.transformer import Model
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)

# two epochs of minibatch level learning over up to 262,144 values, f32
# sums in another order: the errors agree to a few ulps of 0.1
ERR_RTOL = 1e-5


def test_learned_levels_on_reference_weights():
    ms = JMeshSpec(axes=("data", "model"), shape=(1, 1))
    jmodel = JModel(jconfigs.get_smoke("yi-6b"), ms, JQSDPConfig())
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = Model(configs.get_smoke("yi-6b"), MeshSpec(("data", "model"), (1, 1)),
                  QSDPConfig())
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, device="cpu",
                             model=model)
    rows = learned_levels.level_errors(params)
    cfg = jl.LevelsConfig(bits=4, bucket_size=1024, epochs=2, min_params=10_000)
    want = {}
    for name, w in jparams.items():
        if w.size < cfg.min_params:
            continue
        levels = jl.learn_levels_for_tensor(w, cfg)
        uni = jl.uniform_levels(cfg.bits)
        qu, ql = jl.quantize_levels(w, uni), jl.quantize_levels(w, levels)
        want[name] = (float(jl.compression_error(w, jl.dequantize_levels(qu, uni))),
                      float(jl.compression_error(w, jl.dequantize_levels(ql, levels))),
                      tuple(ql.codes.shape), ql.wire_bytes)
    assert sorted(r["name"] for r in rows) == sorted(want) and len(rows) == 8
    for r in rows:
        eu, el, codes, wire = want[r["name"]]
        assert r["uniform"] == pytest.approx(eu, rel=ERR_RTOL), r["name"]
        assert r["learned"] == pytest.approx(el, rel=ERR_RTOL), r["name"]
        assert (r["codes_shape"], r["wire_bytes"]) == (codes, wire)
        assert r["learned"] < r["uniform"]


def test_learned_levels_main_runs():
    rows = learned_levels.main(["--device", "cpu"])
    assert len(rows) == 8 and all(r["learned"] < r["uniform"] for r in rows)


@pytest.mark.parametrize("baseline", [False, True])
def test_step_comm_bytes_at_one_rank_equals_reference(baseline):
    q = dict(quantize_weights=False, quantize_grads=False, coalesce=False) if baseline \
        else dict(min_quant_size=1024)
    cfg, jcfg = configs.get_config("gpt-125m"), jconfigs.get_config("gpt-125m")
    eng = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig(**q)).engine
    jeng = JModel(jcfg, JMeshSpec(("data", "model"), (1, 1)), JQSDPConfig(**q)).engine
    for n_micro in (1, 4):
        assert step_comm_bytes(eng, 2 * n_micro, n_micro) == \
            jstep_comm_bytes(jeng, 2 * n_micro, n_micro) == \
            dict(weight_gather=0, grad_reduce=0, total=0)


def test_examples_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (learned_levels.main, quickstart.main, train_gpt_qsdp.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])
