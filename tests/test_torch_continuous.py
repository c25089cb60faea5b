"""``chip_smoke.py``'s continuous phase, rehearsed on the CPU at the
gpt-1.3b smoke config (2 layers, d_model 256), with the card's request
plan, ring, block, chunk, pool and cold tier: every greedy request equals
its solo run bit for bit, the sampled streams repeat across two runs, the
pool demotes and rehydrates and ends empty, and the K1/K2/random_bits
counts that ``expected_continuous_launches`` derives from the code's
structure equal the wrappers' calls (which count only kernel launches, so
the rehearsal counts calls)."""
import importlib.util
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_continuous_phase_rehearsal(monkeypatch):
    cs = _chip_smoke()
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    for name, kernel in (("quantize_pack", "quantize_pack"),
                         ("unpack_dequantize", "unpack_dequantize"),
                         ("unpack_dequantize_wire", "unpack_dequantize"),
                         ("random_bits", "random_bits")):
        def counted(*a, _orig=getattr(ops, name), _kernel=kernel, **k):
            ops.LAUNCHES[_kernel] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    lines = []
    counts = cs.continuous_phase(torch, lines.append, dev="cpu", profile=False)
    text = "\n".join(lines)
    assert "6 greedy requests bit-equal to their solo runs" in text
    assert "rehydrating requests ['c9']" in text
    # the plan's schedule: 25 chunk launches and 84 decode steps whatever the
    # widths; smoke: 1 embed + 2 layers x 7 quantized weights, 3 K2 buffers
    assert counts["quantize_pack"] == 15 * (25 + 84) + 2 * 144
    assert counts["unpack_dequantize"] == 3 * (25 + 84) + 2 * 8
    assert counts["random_bits"] == 100 and counts["rowquant_matmul"] == 0


def test_request_plan_is_within_the_stated_ranges():
    cs = _chip_smoke()
    reqs = cs.continuous_requests(50304)
    assert len(reqs) == 12
    assert all(32 <= len(r.prompt) <= 384 and 16 <= r.max_new_tokens <= 32 for r in reqs)
    shared = [r for r in reqs if r.prompt[:128] == reqs[0].prompt[:128]]
    assert len(shared) == 6 and sum(r.needs_sampling for r in reqs) == 6
