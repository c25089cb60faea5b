"""Remat "dots" (``QSDPConfig(remat_policy="dots")``) on the CPU, for the
dense and the MoE family's smoke configs (set-up and tolerances in
``_torch_train_common.py``):

  - the port's step under "dots" bit-equal to its step under "full"
    (losses, grad norms, every updated parameter and moment), and its f32
    step within the step tolerances of the JAX package's "dots" step
    (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``);
  - a dispatch-mode count of ``aten.mm``/``aten.addmm``: the backward under
    "dots" runs exactly the layers' forward 2-D matmuls fewer than under
    "full" (their outputs are kept), while the gather still replays: every
    layer's weights are re-gathered in the backward, byte-equal to the
    forward's, as ``test_backward_regathers_forward_weights`` counts them.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, make_adamw
from repro_torch.train.step import build_train_step, init_train_state
from _torch_train_common import LR, MS, N_MICRO, assert_step_close, batches, digest, models, run_both

ARCHS = ["gpt-1.3b", "olmoe-1b-7b"]
# forward 2-D matmuls of one layer: dense wq/wk/wv/wo + w_gate/w_up/w_down;
# MoE wq/wk/wv/wo + the router (its experts run batched products)
LAYER_MMS = {"gpt-1.3b": 7, "olmoe-1b-7b": 5}
_MMS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in _MMS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_step_bitequal_to_full(arch):
    opt = make_adamw(AdamWConfig(lr=LR, moment_bits=8))
    runs = {}
    for policy in ("full", "dots"):
        tm = Model(configs.get_smoke(arch), MS, QSDPConfig(remat_policy=policy))
        state = init_train_state(tm, opt, 0, "cpu")
        step = build_train_step(tm, opt, n_micro=N_MICRO, device="cpu")
        ms = []
        for i, batch in enumerate(batches(2)):
            state, m = step(state, {k: torch.from_numpy(v).long() for k, v in batch.items()},
                            prng.fold_in(prng.PRNGKey(1), i))
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        runs[policy] = ms, state
    (mf, sf), (md, sd) = runs["full"], runs["dots"]
    assert mf == md
    for k in sf.params:
        assert torch.equal(sf.params[k], sd.params[k]), k
        for tree_f, tree_d in ((sf.opt.mu, sd.opt.mu), (sf.opt.nu, sd.opt.nu)):
            assert torch.equal(tree_f[k].wire, tree_d[k].wire), k


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_f32_step_matches_jax(arch):
    jm, tm = models(arch=arch, compute_dtype="float32", remat_policy="dots")
    assert jm.qcfg.remat_policy == tm.qcfg.remat_policy == "dots"
    assert_step_close(*run_both(jm, tm, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_saves_layer_matmuls_and_regathers(arch, monkeypatch):
    batch = {k: torch.from_numpy(v[:2]).long() for k, v in batches(1)[0].items()}
    counts, gathers = {}, {}
    for policy in ("full", "dots"):
        tm = Model(configs.get_smoke(arch), MS, QSDPConfig(remat_policy=policy))
        params = {k: v.requires_grad_() for k, v in tm.init_params(0, "cpu").items()}
        seen, phase = {"fwd": [], "bwd": [], "layer": []}, ["fwd"]
        orig = tm.engine._reshape_full

        def record(name, full, seen=seen, phase=phase, orig=orig):
            seen[phase[0]].append((name, digest(full.detach().view(torch.uint8).numpy())))
            return orig(name, full)

        monkeypatch.setattr(tm.engine, "_reshape_full", record)
        # the recompute runs the whole layer (by default it stops once the
        # backward has what it needs: before the dense layer's w_down
        # product, whose output feeds only the residual add)
        with set_checkpoint_early_stop(False):
            with _CountMM() as fwd:
                loss = tm.loss_fn(params, batch, prng.PRNGKey(5))
            phase[0] = "bwd"
            with _CountMM() as bwd:
                loss.backward()
        counts[policy] = fwd.n, bwd.n
        gathers[policy] = seen
        assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in params.values())

        # one layer's forward 2-D matmuls, counted on its own
        phase[0] = "layer"
        w = tm.engine.gather_layer("layers/", {k[len("layers/"):]: v[0].detach() for k, v in
                                               params.items() if k.startswith("layers/")},
                                   prng.PRNGKey(6))
        x = torch.randn(2, 32, tm.cfg.d_model).to(tm.compute_dtype)
        s = torch.arange(32)
        cos, sin = L.rope_cos_sin(s, tm.cfg.head_dim, tm.cfg.rope_theta)
        with torch.no_grad(), _CountMM() as one:
            if tm.cfg.is_moe:
                tm._moe_layer((x, torch.zeros(())), w, cos, sin, s)
            else:
                tm._dense_layer(x, w, cos, sin, s)
        assert one.n == LAYER_MMS[arch]
    n_layers = configs.get_smoke(arch).n_layers
    assert counts["full"][0] == counts["dots"][0]  # the same forward
    assert counts["full"][1] - counts["dots"][1] == n_layers * LAYER_MMS[arch]
    per_layer = sum(n.startswith("layers/") for n in tm.specs)
    for policy in ("full", "dots"):
        seen = gathers[policy]
        layer_fwd = [x for x in seen["fwd"] if x[0].startswith("layers/")]
        assert len(layer_fwd) == per_layer * n_layers
        assert sorted(seen["bwd"]) == sorted(layer_fwd)
    assert gathers["full"] == gathers["dots"]
