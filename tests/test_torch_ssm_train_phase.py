"""``chip_smoke.py``'s ssmtrain phase rehearsed on the CPU at mamba2-370m's
smoke config (2 Mamba2 layers), and the hand count of its launch formula
for both families' smoke and full configs.

The rehearsal runs the phase's control flow and every gate it can run off
the card: step 0 twice bit-equal, the K1/K2 launch counts it derives from
the code's structure (``expected_train_launches``) against the wrappers'
calls, the first loss near ln(vocab), the profiled steps' control flow.
The card-vs-CPU smoke step and the profiler's trace need the card;
``test_torch_ssm_train_phase_hybrid.py`` rehearses the hybrid.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model

torch.set_num_threads(1)
MS = MeshSpec(("data", "model"), (1, 1))


@pytest.fixture(scope="module")
def cs():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rehearse(cs, monkeypatch, arch):
    """ssmtrain_phase at `arch`'s smoke config on the CPU, launches counted
    at the ``ops.*`` wrappers.  Returns (its counts, the structure's launches
    per step, the profiled tags, the log)."""
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    monkeypatch.setitem(cs.SSM_TRAIN_LAYERS, arch, None)
    monkeypatch.setitem(cs.TRAIN, "seq", 32)
    profiled = []

    def profile(torch_, run, state, log, tag="train", breakdown=None, record_shapes=False):
        profiled.append((tag, run(state)))
        return dict(busy_ms=0.0, wall_ms=1.0, threefry_int64=0, k1_ms=0.0, k1_n=0, k2_ms=0.0,
                    k2_n=0, parts={"_matched": (0, 0, 0), "_other": []})

    monkeypatch.setattr(cs, "profile_train_step", profile)
    for name, kernel in (("quantize_pack", "quantize_pack"),
                         ("unpack_dequantize", "unpack_dequantize"),
                         ("unpack_dequantize_wire", "unpack_dequantize")):
        def counted(*a, _orig=getattr(ops, name), _kernel=kernel, **k):
            ops.LAUNCHES[_kernel] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    lines = []
    counts = cs.ssmtrain_phase(torch, lines.append, dev="cpu", archs=(arch,))
    model = Model(configs.get_smoke(arch), MS, QSDPConfig())
    want = cs.expected_train_launches(model, cs.TRAIN["n_micro"],
                                      moments=cs.SSM_TRAIN_MOMENT_BITS[arch] is not None)
    assert counts["quantize_pack"] == cs.TRAIN_TIMED * want["quantize_pack"]
    assert counts["unpack_dequantize"] == cs.TRAIN_TIMED * want["unpack_dequantize"]
    text = "\n".join(lines)
    for needle in ("step 0 run twice from the same state and key", "launches in 3 steps",
                   "ssmtrain: phase"):
        assert needle in text, needle
    assert ("profiled step by part" in text) == (cs.SSM_TRAIN_PROFILE[arch] == "by part")
    return counts, want, [t for t, _ in profiled], text


def test_chip_smoke_ssmtrain_phase_rehearsal(cs, monkeypatch):
    counts, want, tags, text = rehearse(cs, monkeypatch, "mamba2-370m")
    # smoke: embed + 2 layers x 5 quantized tensors (w_z/w_x/w_bc/w_dt/w_out);
    # the convs, A, dt bias, D and the norms ride as fp segments; f32 moments
    assert want["per_micro"] == (11, 10, 11)
    assert want["k2_per_micro"] == (3, 2, 3)
    assert want["moment_chunks"] == 0
    assert counts["quantize_pack"] == 3 * 2 * 32
    assert counts["unpack_dequantize"] == 3 * 2 * 8
    # mamba2's step profiled as it is (its by-part profile the time
    # budget's first cut)
    assert tags == ["ssmtrain mamba2-370m"]
    assert "f32 moments bit-equal" in text


@pytest.mark.parametrize("arch,layers,want", [
    # embed + 48 x 5; K2: embed + 48 layer buffers.  Update chunks: embed
    # (51.5 M values) in 2 ranges of 2^25, final_norm, 9 stacks x 48 slices,
    # a_log/dt_bias/d_skip (32 values a slice, sharing buckets) whole
    ("mamba2-370m", None, ((241, 240, 241), (49, 48, 49), 2 + 1 + 9 * 48 + 3)),
    # embed + 39 x 5 + 6 invocations x 7 shared (wq/wk/wv/wo, w_gate/w_up/
    # w_down); K2: embed + 39 layer buffers + 6 shared buffers.  Update
    # chunks: embed (114.7 M) 4 ranges, final_norm, the shared block's 9
    # leaves (w_gate/w_up/w_down, 51.4 M each, in 2 ranges), 7 stacks by
    # slice, a_log/dt_bias/d_skip/conv_bc/pre_norm (slices of 112, 112, 112,
    # 512 and 3,584 values) whole
    ("zamba2-7b", 39, ((238, 237, 238), (46, 45, 46), 4 + 1 + 12 + 7 * 39 + 5)),
    ("zamba2-7b", None, ((497, 496, 497), (95, 94, 95), 4 + 1 + 12 + 7 * 81 + 5)),
    # smoke: 3 layers, one group of 2 and a 1-layer tail; 6 stacks by slice
    ("zamba2-smoke", None, ((23, 22, 23), (5, 4, 5), 1 + 1 + 9 + 6 * 3 + 6)),
])
def test_expected_train_launches_by_hand(cs, arch, layers, want):
    import dataclasses
    cfg = (configs.get_smoke("zamba2-7b") if arch == "zamba2-smoke"
           else configs.get_config(arch))
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg, MS, QSDPConfig())
    got = cs.expected_train_launches(model, 2, moments=True)
    assert (got["per_micro"], got["k2_per_micro"], got["moment_chunks"]) == want
    assert got["quantize_pack"] == 2 * sum(want[0]) + 2 * want[2]
    assert got["unpack_dequantize"] == 2 * sum(want[1]) + want[2]
    if cfg.arch_type == "hybrid":  # the shared block's count needs its invocations
        with pytest.raises(ValueError, match="invocation"):
            cs.k2_buffers(model.engine, model.engine._is_quantized)
