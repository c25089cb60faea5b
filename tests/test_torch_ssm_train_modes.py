"""SSM/hybrid training's other modes on the CPU (set-up in
``_torch_train_common.py``):

  (e) remat "dots" (``QSDPConfig(remat_policy="dots")``: the checkpoints
      keep the outputs of the 2-D matmuls, the Mamba2 projections and the
      shared block's, and recompute the rest, SSD scan and conv included)
      bit-equal to "full" over two steps, for mamba2-370m's and zamba2-7b's
      smoke configs: losses, grad norms, every updated parameter and 8-bit
      moment;
  (f) zamba2's quantized_state step bit-exact with its quantize_master step
      (the checkpoints of such a state: ``test_torch_ssm_train_ckpt.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.core.quant import QuantizedParam
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, make_adamw
from repro_torch.train.step import (build_train_step, dequantize_train_state,
                                    init_train_state, quantize_train_state)
from _torch_train_common import LR, MS, N_MICRO, batches, models

torch.set_num_threads(1)

HYBRID = "zamba2-7b"


def _torch_batches(n):
    return [{k: torch.from_numpy(v).long() for k, v in b.items()} for b in batches(n)]


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_ssm_remat_dots_step_bitequal_to_full(arch):
    opt = make_adamw(AdamWConfig(lr=LR, moment_bits=8))
    runs = {}
    for policy in ("full", "dots"):
        tm = Model(configs.get_smoke(arch), MS, QSDPConfig(remat_policy=policy))
        state = init_train_state(tm, opt, 0, "cpu")
        step = build_train_step(tm, opt, n_micro=N_MICRO, device="cpu")
        ms = []
        for i, batch in enumerate(_torch_batches(2)):
            state, m = step(state, batch, prng.fold_in(prng.PRNGKey(1), i))
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        runs[policy] = ms, state
    (mf, sf), (md, sd) = runs["full"], runs["dots"]
    assert mf == md and all(np.isfinite(mf).ravel())
    for k in sf.params:
        assert torch.equal(sf.params[k], sd.params[k]), k
        for tree_f, tree_d in ((sf.opt.mu, sd.opt.mu), (sf.opt.nu, sd.opt.nu)):
            assert torch.equal(tree_f[k].wire, tree_d[k].wire), k


def test_hybrid_quantized_state_bitexact_with_quantize_master():
    _, tm = models(arch=HYBRID)
    opt = make_adamw(AdamWConfig(lr=LR, moment_bits=8))
    qs = quantize_train_state(init_train_state(tm, opt, 0, "cpu"), tm, prng.PRNGKey(9))
    assert isinstance(qs.params["shared/wq"], QuantizedParam)
    assert not isinstance(qs.params["layers/conv_x"], QuantizedParam)  # an fp segment
    fs = dequantize_train_state(qs)
    step_q = build_train_step(tm, opt, n_micro=N_MICRO, quantized_state=True, device="cpu")
    step_f = build_train_step(tm, opt, n_micro=N_MICRO, quantize_master=True, device="cpu")
    for i, b in enumerate(_torch_batches(2)):
        qs, mq = step_q(qs, b, prng.fold_in(prng.PRNGKey(7), i))
        fs, mf = step_f(fs, b, prng.fold_in(prng.PRNGKey(7), i))
        assert float(mq["loss"]) == float(mf["loss"])
        assert float(mq["grad_norm"]) == float(mf["grad_norm"])
    dq, df = dequantize_train_state(qs), dequantize_train_state(fs)
    for tree_q, tree_f in ((dq.params, df.params), (dq.opt.mu, df.opt.mu), (dq.opt.nu, df.opt.nu)):
        for k in tree_f:
            assert torch.equal(tree_q[k], tree_f[k]), k
