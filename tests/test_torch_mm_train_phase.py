"""``chip_smoke.py``'s mmtrain phase rehearsed on the CPU at the VLM and
audio smoke configs, and the hand count of its launch formula for both
families' smoke configs and the phase's full-width cells.

The rehearsal runs the phase's control flow and every gate it can run off
the card: the train batches with their modality inputs (the VLM's image
block at the smoke size, its labels masked; the audio frame stub), step 0
twice bit-equal, the K1/K2 launch counts it derives from the code's
structure (``expected_train_launches``) against the wrappers' calls, the
first loss near ln(vocab) + d s^2 / 2, the profiled steps' control flow.
The card-vs-CPU smoke step and the profiler's trace need the card.
"""
import dataclasses
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


def test_chip_smoke_mmtrain_phase_rehearsal(cs, monkeypatch):
    """mmtrain_phase at both smoke configs on the CPU, launches counted at
    the ``ops.*`` wrappers."""
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    for arch in cs.MM_ARCHS:
        monkeypatch.setitem(cs.MM_TRAIN_LAYERS, arch, None)
    monkeypatch.setitem(cs.TRAIN, "seq", 32)
    monkeypatch.setattr(cs, "MM_TRAIN_IMAGE", cs.MM_SMALL_IMAGE)
    profiled, batches = [], []

    def profile(torch_, run, state, log, tag="train", breakdown=None, record_shapes=False):
        profiled.append((tag, run(state)))
        return dict(busy_ms=0.0, wall_ms=1.0, threefry_int64=0, k1_ms=0.0, k1_n=0, k2_ms=0.0,
                    k2_n=0, parts={"_matched": (0, 0, 0), "_other": []})

    def kept(orig):
        def f(*a, **k):
            out = orig(*a, **k)
            batches.append(out)
            return out
        return f

    monkeypatch.setattr(cs, "profile_train_step", profile)
    monkeypatch.setattr(cs, "train_batches", kept(cs.train_batches))
    for name, kernel in (("quantize_pack", "quantize_pack"),
                         ("unpack_dequantize", "unpack_dequantize"),
                         ("unpack_dequantize_wire", "unpack_dequantize")):
        def counted(*a, _orig=getattr(ops, name), _kernel=kernel, **k):
            ops.LAUNCHES[_kernel] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    lines = []
    counts = cs.mmtrain_phase(torch, lines.append, dev="cpu")
    want = {k: 0 for k in ("quantize_pack", "unpack_dequantize")}
    for arch in cs.MM_ARCHS:
        model = Model(configs.get_smoke(arch), MS, QSDPConfig())
        w = cs.expected_train_launches(model, cs.TRAIN["n_micro"],
                                       moments=cs.MM_TRAIN_MOMENT_BITS[arch] is not None)
        for k in want:
            want[k] += cs.TRAIN_TIMED * w[k]
    assert {k: counts[k] for k in want} == want
    # the hand count (test_expected_train_launches_by_hand's smoke rows):
    # qwen2-vl with 8-bit moments (21 update chunks: 2 encodes and one
    # decode each), seamless with f32 ones
    assert want == {"quantize_pack": 3 * (2 * (15 + 14 + 15) + 2 * 21 + 2 * (38 + 36 + 38)),
                    "unpack_dequantize": 3 * (2 * (3 + 2 + 3) + 21 + 2 * (6 + 4 + 6))}
    text = "\n".join(lines)
    for needle in ("step 0 run twice from the same state and key", "launches in 3 steps",
                   "mmtrain: phase", "and 2 encoder layers"):
        assert needle in text, needle
    assert text.count("profiled step by part") == 1
    # the profiled step is qwen2-vl's, by part (seamless's was a cut of the
    # time budget)
    assert [t for t, _ in profiled] == ["mmtrain qwen2-vl-72b by part"]
    assert text.count(": cell ") == 2
    # the batches: the VLM's image block with its labels masked, shared by
    # every step; the audio stub of seq // 2 frames
    vlm, audio = batches
    mask = vlm[0]["vision_mask"]
    assert int(mask.sum()) == 4 * 8 and bool((vlm[1]["labels"][mask] == -1).all())
    assert bool((vlm[1]["labels"][~mask] >= 0).all())
    assert vlm[0]["positions"].shape == (3, 4, 32) and vlm[1]["positions"] is vlm[0]["positions"]
    assert audio[0]["audio_embeds"].shape == (4, 16, 256)
    assert audio[0]["audio_embeds"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch,layers,want", [
    # embed + 2 layers x 7 (wq/wk/wv/wo, w_gate/w_up/w_down; the qkv biases
    # and norms are fp segments); K2: embed + a buffer a layer.  Update
    # chunks: the 1,245.7 M-value embedding in 38 ranges of 2^25, final_norm,
    # 12 layer stacks x 2 slices
    ("qwen2-vl-72b", 2, ((15, 14, 15), (3, 2, 3), 38 + 1 + 24)),
    # embed + lm_head + 24 encoder layers x 7 + 24 decoder layers x 11 (the
    # cross-attention's xwq/xwk/xwv/xwo); K2: embed, lm_head, 48 layers.
    # Update chunks: embed and lm_head (262.4 M values) 8 ranges each, the
    # two final norms, 9 encoder and 14 decoder stacks x 24 slices
    ("seamless-m4t-large-v2", None, ((434, 432, 434), (50, 48, 50), 16 + 2 + 23 * 24)),
    # smoke: 2 layers; 2 encoder and 2 decoder layers.  The norms' and the
    # qkv biases' slices (<= 256 values) share buckets: those stacks update
    # whole
    ("qwen2-vl-smoke", None, ((15, 14, 15), (3, 2, 3), 2 + 7 * 2 + 5)),
    ("seamless-smoke", None, ((38, 36, 38), (6, 4, 6), 4 + 18 * 2 + 5)),
])
def test_expected_train_launches_by_hand(cs, arch, layers, want):
    smoke = {"qwen2-vl-smoke": "qwen2-vl-72b", "seamless-smoke": "seamless-m4t-large-v2"}
    cfg = configs.get_smoke(smoke[arch]) if arch in smoke else configs.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg, MS, QSDPConfig())
    got = cs.expected_train_launches(model, 2, moments=True)
    assert (got["per_micro"], got["k2_per_micro"], got["moment_chunks"]) == want
    assert got["quantize_pack"] == 2 * sum(want[0]) + 2 * want[2]
    assert got["unpack_dequantize"] == 2 * sum(want[1]) + want[2]
