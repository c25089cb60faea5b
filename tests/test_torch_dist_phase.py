"""``chip_smoke.py``'s dist phase rehearsed on the CPU at the smoke configs
(gpt-1.3b's, and qwen2.5-3b's for the replicated-KV block): (a) one step
through the gloo groups of the one-rank (data, model) grid bit-equal to
``group=None``, its K1/K2 launches and its calls into torch.distributed
by op equal to the structure's formulas (``expected_train_launches``,
``expected_train_comm``); (b) the train launcher under torchrun at
``--data-par 1 --model-par 1`` against the launcher without it; (c) the
wire work of P = 2, 4 and 8 emulated ranks and (e) the tp-local wire work
at (P, M) = (1, 2), (1, 4), (1, 8) and (2, 2), byte-equal with K1 and K2
swapped for their plain versions (on the CPU both sides take them: the
rehearsal runs the phase's control flow and gates); (d) the attention
and MLP blocks' M model-rank shares summed within TP_BLOCK_TOL of the
one-rank block, bf16 and f32.  The wrappers count only kernel launches,
so the rehearsal counts their calls.  ``expected_train_comm`` is held to
the counter of steps over two and four gloo ranks in
``test_torch_dist_train.py``."""
import pytest
import torch

from repro_torch import configs
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model
from test_torch_continuous import _chip_smoke

torch.set_num_threads(1)


@pytest.fixture()
def cs(monkeypatch):
    cs = _chip_smoke()
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    monkeypatch.setitem(cs.TRAIN, "seq", 32)
    for fn in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    for name, kernel in (("quantize_pack", "quantize_pack"),
                         ("unpack_dequantize", "unpack_dequantize"),
                         ("unpack_dequantize_wire", "unpack_dequantize")):
        def counted(*a, _orig=getattr(ops, name), _kernel=kernel, **k):
            ops.LAUNCHES[_kernel] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    return cs


def test_chip_smoke_dist_phase_rehearsal(cs, capsys):
    lines = []
    launches, rows, blocks = cs.dist_phase(torch, lines.append, dev="cpu", profile=False,
                                   launch_extra=("--smoke", "--batch", "4", "--seq", "32",
                                                 "--device", "cpu"))
    model = Model(configs.get_smoke("gpt-1.3b"), MeshSpec(("data", "model"), (1, 1)),
                  QSDPConfig())
    want = cs.expected_train_launches(model, 2)
    assert launches["quantize_pack"] == want["quantize_pack"] == 2 * 44
    assert launches["unpack_dequantize"] == want["unpack_dequantize"]
    # per microbatch: embed and final norm gathered once, 2 layers twice;
    # their 4 reduce-scatters; then the loss and the norm
    assert cs.expected_train_comm(model, 2) == {"all_gather": 2 * (2 + 4), "all_to_all": 2 * 4,
                                                "reduce_scatter": 0, "all_reduce": 2}
    text = "\n".join(lines)
    assert "one-rank (data, model) grid of gloo groups bit-equal to group=None" in text
    assert "bit-equal to the launcher's without torchrun" in text
    # a smoke layer: 7 quantized tensors a row, one K2 launch up to P = 9
    assert [(r["p"], r["table"], r["launches"]) for r in rows] == [(2, 14, 1), (4, 28, 1),
                                                                  (8, 56, 1)]
    assert all(not r["main_path"] for r in rows)
    assert sum(line.startswith("tp: (P, M) = ") for line in lines) == len(cs.TP_MESHES) == 4
    assert [(b["arch"], b["m"], b["block"]) for b in blocks if b["dtype"] == "float32"] == [
        ("gpt-1.3b", 2, "attention"), ("gpt-1.3b", 2, "mlp"), ("gpt-1.3b", 4, "attention"),
        ("gpt-1.3b", 4, "mlp"), ("qwen2.5-3b", 4, "attention")]
    assert len(blocks) == 10 and all(b["err"] <= b["tol"] for b in blocks)
    assert "KV replicated" in text and "KV tp" in text
    # (f): gpt-125m's smoke state resharded to (2, 2), (1, 2), (2, 1): 8 blocks
    assert "dist reshard: gpt-125m" in text and ": 8 blocks byte-equal card vs CPU" in text
    assert cs.DIST_NOTE in capsys.readouterr().out
