"""``chip_smoke.py``'s moetrain phase rehearsed on the CPU at olmoe-1b-7b's
smoke config (2 layers, d 256, 4 experts top-2), and the profiled step's
breakdown by part on a made-up trace.

The rehearsal runs the phase's control flow and every gate it can run off
the card: step 0 twice bit-equal, the K1/K2 launch counts it derives from
the code's structure (``expected_train_launches`` with the 8-bit moments'
codes) against the wrappers' calls, the first loss less the load-balance
term near ln(vocab), one quantized_state step equal to the quantize_master
step.  The card-vs-CPU step and the profiled step need the card.
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


@pytest.fixture(scope="module")
def cs():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_moetrain_phase_rehearsal(cs, monkeypatch):
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    monkeypatch.setattr(cs, "MOE_TRAIN_LAYERS", 2)
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
    counts = cs.moetrain_phase(torch, lines.append, dev="cpu")
    model = Model(configs.get_smoke("olmoe-1b-7b"), MeshSpec(("data", "model"), (1, 1)),
                  QSDPConfig())
    want = cs.expected_train_launches(model, 2, moments=True)
    # smoke: embed + 2 layers x 7 quantized tensors (wq/wk/wv/wo, 3 expert
    # stacks); the router and the norms ride as fp segments
    assert want["per_micro"] == (15, 14, 15)
    assert want["k2_per_micro"] == (3, 2, 3)
    # update chunks: embed, final_norm, 8 layer stacks x 2 slices and the 2
    # norm stacks (256 values a slice, within one bucket) whole; two 8-bit
    # moment encodes and one decode a chunk
    assert want["moment_chunks"] == 1 + 1 + 8 * 2 + 2 == 20
    assert counts["quantize_pack"] == cs.TRAIN_TIMED * want["quantize_pack"] == 3 * (88 + 40)
    assert counts["unpack_dequantize"] == cs.TRAIN_TIMED * want["unpack_dequantize"] \
        == 3 * (16 + 20)
    # one profiled step as it is (its breakdown by part was cut for the
    # card run's time)
    assert [t for t, _ in profiled] == ["moetrain"]
    text = "\n".join(lines)
    for needle in ("step 0 run twice from the same state and key",
                   "load-balance term per layer", "dropped by capacity per layer",
                   "quantized_state == quantize_master"):
        assert needle in text, needle


def test_moe_step_breakdown_parts(cs):
    """Kernels go to the part of the innermost ops open on their launching
    thread: names for K1/K2, the bmm's input type for expert products, the
    named ranges, and for a backward node the range of the forward op with
    its sequence number."""
    ev = []
    rng = {v: k for k, v in cs.RANGES.items()}

    def span(name, ts, dur, tid=1, cat="cpu_op", **args):
        ev.append(dict(cat=cat, name=name, ts=ts, dur=dur, tid=tid, args=args))

    def kernel(name, launch_ts, corr, dur, tid=1, cat="cuda_runtime"):
        ev.append(dict(cat=cat, name="cudaLaunchKernel", ts=launch_ts, dur=1, tid=tid,
                       args=dict(correlation=corr)))
        ev.append(dict(cat="kernel", name=name, ts=1000 + corr, dur=dur, tid=7,
                       args=dict(correlation=corr)))

    node = {"Fwd thread id": 9}  # the profiler's id of thread 1
    span(rng["dispatch/combine"], 0, 100, cat="user_annotation")
    span("aten::bmm", 10, 5, **{"Input type": ["c10::BFloat16", "c10::BFloat16"]})
    kernel("nvjet_bf16", 12, 1, 4000.0, cat="cuda_driver")
    span("aten::index", 20, 5, **{"Sequence number": 41})
    kernel("index_elementwise_kernel", 22, 2, 1000.0)
    span(rng["attention"], 200, 100, cat="user_annotation")
    span("aten::bmm", 210, 5, **{"Input type": ["float", "float"], "Sequence number": 42})
    kernel("sm80_xmma_gemm_f32f32", 212, 3, 2000.0)
    # the backward thread: the attention product's and the index's nodes
    span(cs._EVAL + " BmmBackward0", 400, 50, tid=2, **node, **{"Sequence number": 42})
    # an op inside a backward node carries the node's sequence number
    span("aten::bmm", 410, 5, tid=2, **node, **{"Input type": ["float", "float"],
                                                "Sequence number": 42})
    kernel("sm80_xmma_gemm_f32f32", 412, 4, 3000.0, tid=2)
    span(cs._EVAL + " IndexBackward0", 500, 50, tid=2, **node, **{"Sequence number": 41})
    span("aten::index_put_", 510, 5, tid=2)
    kernel("index_put_kernel", 512, 5, 500.0, tid=2)
    kernel("void quantize_pack_vec_kernel<8>", 600, 6, 700.0, tid=2)
    kernel("unpack_dequantize_kernel", 700, 7, 300.0, tid=2)
    span(rng["optimizer"], 790, 50, tid=1, cat="user_annotation")
    span("aten::mul", 800, 5)
    kernel("vectorized_elementwise_kernel", 802, 8, 100.0)
    span("aten::add", 900, 5)
    kernel("vectorized_elementwise_kernel", 902, 9, 50.0)
    span("aten::index_put_", 515, 1, tid=2, **node, **{"Sequence number": 41})
    # the backward thread's events first: its ops inside backward nodes share
    # every node's sequence number, yet are not the nodes' forward ops
    ev.sort(key=lambda e: -e["tid"])
    parts = cs.step_breakdown(ev, n_experts=64)
    assert parts.pop("_matched") == (2, 2, 2)
    assert parts.pop("_other") == [("vectorized_elementwise_kernel", 0.05)]
    assert parts == {"expert products": [4.0, 1], "dispatch/combine": [1.5, 2],
                     "attention": [5.0, 2], "K1": [0.7, 1], "K2": [0.3, 1],
                     "optimizer": [0.1, 1], "other": [0.05, 1]}
