"""Audio training's other modes on the CPU, seamless-m4t-large-v2's smoke
config (2 encoder and 2 decoder layers; set-up in ``_torch_train_common.py``,
batches with the frame stub):

  (e) remat "dots" (``QSDPConfig(remat_policy="dots")``: the checkpoints
      keep the outputs of the 2-D matmuls, the decoder's cross-attention
      projections of the encoder output among them, and recompute the rest)
      bit-equal to "full" over two steps with 8-bit Adam moments: losses,
      grad norms, every updated parameter and moment code;
  (f) the quantized_state step bit-exact with the quantize_master step, the
      encoder's and the cross-attention's weights kept as wire codes.
"""
import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.core.quant import QuantizedParam
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, make_adamw
from repro_torch.train.step import (build_train_step, dequantize_train_state,
                                    init_train_state, quantize_train_state)
from _torch_train_common import LR, MS, N_MICRO, batches, models, to_torch

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"


def _batches(n):
    return [to_torch(b) for b in batches(n, configs.get_smoke(ARCH))]


def test_audio_remat_dots_step_bitequal_to_full():
    opt = make_adamw(AdamWConfig(lr=LR, moment_bits=8))
    runs = {}
    for policy in ("full", "dots"):
        tm = Model(configs.get_smoke(ARCH), MS, QSDPConfig(remat_policy=policy))
        state = init_train_state(tm, opt, 0, "cpu")
        step = build_train_step(tm, opt, n_micro=N_MICRO, device="cpu")
        ms = []
        for i, batch in enumerate(_batches(2)):
            state, m = step(state, batch, prng.fold_in(prng.PRNGKey(1), i))
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        runs[policy] = ms, state
    (mf, sf), (md, sd) = runs["full"], runs["dots"]
    assert mf == md and all(np.isfinite(mf).ravel())
    assert {"enc/wq", "dec/xwk", "enc_final_norm", "lm_head"} <= set(sf.params)
    for k in sf.params:
        assert torch.equal(sf.params[k], sd.params[k]), k
        for tree_f, tree_d in ((sf.opt.mu, sd.opt.mu), (sf.opt.nu, sd.opt.nu)):
            assert torch.equal(tree_f[k].wire, tree_d[k].wire), k


def test_audio_quantized_state_bitexact_with_quantize_master():
    _, tm = models(arch=ARCH)
    opt = make_adamw(AdamWConfig(lr=LR, moment_bits=8))
    qs = quantize_train_state(init_train_state(tm, opt, 0, "cpu"), tm, prng.PRNGKey(9))
    for name in ("enc/wq", "dec/xwv", "lm_head"):
        assert isinstance(qs.params[name], QuantizedParam), name
    assert not isinstance(qs.params["enc_final_norm"], QuantizedParam)  # an fp segment
    fs = dequantize_train_state(qs)
    step_q = build_train_step(tm, opt, n_micro=N_MICRO, quantized_state=True, device="cpu")
    step_f = build_train_step(tm, opt, n_micro=N_MICRO, quantize_master=True, device="cpu")
    for i, b in enumerate(_batches(2)):
        qs, mq = step_q(qs, b, prng.fold_in(prng.PRNGKey(7), i))
        fs, mf = step_f(fs, b, prng.fold_in(prng.PRNGKey(7), i))
        assert float(mq["loss"]) == float(mf["loss"])
        assert float(mq["grad_norm"]) == float(mf["grad_norm"])
    dq, df = dequantize_train_state(qs), dequantize_train_state(fs)
    for tree_q, tree_f in ((dq.params, df.params), (dq.opt.mu, df.opt.mu), (dq.opt.nu, df.opt.nu)):
        for k in tree_f:
            assert torch.equal(tree_q[k], tree_f[k]), k
