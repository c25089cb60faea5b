"""``chip_smoke.py``'s moe phase, rehearsed on the CPU at olmoe-1b-7b's
smoke config (2 layers, d_model 256, 4 experts top-2) on the card's
fixed-shape route (4 lanes per launch): batch serving run twice with equal
tokens and the launch structure K1 = 7 x layers + 1, K2 = layers + 1 per
step; the continuous cell (CONT, CONT_PLAN) with every request on no
rehydrated block equal to its batch-of-1 solo run, the pool, and the
launches ``expected_continuous_launches`` derives; then the route's row
gate at the MoE launch shapes (decode block M = 4, chunk block M = 4 x 64;
verify runs at the decode block's shape).  The speculative part runs in
``test_torch_moe_phase_spec.py``.  The wrappers count only kernel launches,
so the rehearsal counts calls (``test_torch_continuous.count_calls``)."""
import torch

from test_torch_continuous import _chip_smoke, count_calls

torch.set_num_threads(1)


def test_chip_smoke_moe_phase_rehearsal(monkeypatch):
    cs = _chip_smoke()
    count_calls(monkeypatch)
    monkeypatch.setattr(cs, "speculative_phase", lambda *a, **k: {})
    lines = []
    counts = cs.moe_phase(torch, lines.append, dev="cpu")
    text = "\n".join(lines)
    assert "moe batch: olmoe-smoke" in text and "per decode step K1/K2/K3 (15, 3, 0)" in text
    assert ("9 requests bit-equal to their batch-of-1 solo runs (['c0', 'c1', 'c2', 'c3', "
            "'c4', 'c5', 'c6', 'c7', 'c8']") in text
    assert "continuous: olmoe-smoke, 12 requests" in text
    assert "olmoe-smoke: fixed-shape route" in text
    for gate in ("MoE layer (4 experts, top-2, drop-free) bf16 at M = 4",
                 "MoE layer (4 experts, top-2, drop-free) bf16 at M = 256", "x @ wq/wk/wv/wo",
                 "chunk attention"):
        assert gate in text, gate
    # batch: prefill + 15 decode steps; continuous: the plan's 25 chunk
    # launches and 84 decode steps, 144 demotions and 8 rehydrations
    assert counts["quantize_pack"] == 15 * 16 + 15 * (25 + 84) + 2 * 144
    assert counts["unpack_dequantize"] == 3 * 16 + 3 * (25 + 84) + 2 * 8
    assert counts["random_bits"] == 100 and counts.get("rowquant_matmul", 0) == 0
