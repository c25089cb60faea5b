"""``chip_smoke.py``'s continuous phase, rehearsed on the CPU at the
gpt-1.3b smoke config (2 layers, d_model 256), with the card's request
plan, ring, block, chunk, pool and cold tier, on the card's fixed-shape
route (4 lanes per launch): every request that attaches no rehydrated block
equals its batch-of-1 solo run bit for bit, the sampled streams repeat
across two runs, the pool demotes and rehydrates and ends empty, and the
K1/K2/random_bits counts that ``expected_continuous_launches`` derives from
the code's structure equal the wrappers' calls (which count only kernel
launches, so the rehearsal counts calls).  Then the speculative phase
(a 4-bit draft of depth 4 over the same plan) commits those solo runs'
tokens, with its own gates.  The two phases share one chip_smoke module,
so the solo runs are computed once."""
import functools
import importlib.util
from pathlib import Path

import torch

import repro_torch.models.layers as layers
from repro_torch import configs
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
# one intra-op thread: fast alone and under a loaded multi-worker run (see
# tests/_torch_train_common.py)
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def count_calls(monkeypatch):
    """Count the wrappers' calls as launches (on the CPU they launch
    nothing), with gpt-1.3b served at its smoke config."""
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    for name, kernel in (("quantize_pack", "quantize_pack"),
                         ("unpack_dequantize", "unpack_dequantize"),
                         ("unpack_dequantize_wire", "unpack_dequantize"),
                         ("random_bits", "random_bits"),
                         ("rowquant_matmul", "rowquant_matmul")):
        def counted(*a, _orig=getattr(ops, name), _kernel=kernel, **k):
            ops.LAUNCHES[_kernel] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    monkeypatch.setattr(layers, "rowquant_matmul", ops.rowquant_matmul)


def test_chip_smoke_continuous_phase_rehearsal(monkeypatch):
    cs = _chip_smoke()
    count_calls(monkeypatch)
    lines = []
    counts = cs.continuous_phase(torch, lines.append, dev="cpu", profile=False)
    text = "\n".join(lines)
    # the 6 greedy requests and the sampled c1/c5/c7; c9 rehydrates the
    # demoted prefix and c10/c11 share its rehydrated blocks
    assert ("9 requests bit-equal to their batch-of-1 solo runs (['c0', 'c1', 'c2', 'c3', "
            "'c4', 'c5', 'c6', 'c7', 'c8']") in text
    assert "requests on rehydrated blocks ['c10', 'c11', 'c9']" in text
    # the plan's schedule: 25 chunk launches and 84 decode steps whatever the
    # widths; smoke: 1 embed + 2 layers x 7 quantized weights, 3 K2 buffers
    assert counts["quantize_pack"] == 15 * (25 + 84) + 2 * 144
    assert counts["unpack_dequantize"] == 3 * (25 + 84) + 2 * 8
    assert counts["random_bits"] == 100 and counts["rowquant_matmul"] == 0


def test_chip_smoke_speculative_phase_rehearsal(monkeypatch):
    """The speculative phase (4-bit draft, depth 4) over the same plan: the
    phase's own gates (solo tokens, accepted drafts, launch structure, pool)
    pass, and the draft ran K3 and its layer decode through K2."""
    cs = _chip_smoke()
    count_calls(monkeypatch)
    lines = []
    counts = cs.speculative_phase(torch, lines.append, dev="cpu")
    text = "\n".join(lines)
    assert "commit the tokens of their non-speculative batch-of-1 solo runs" in text
    assert "accepted per verify lane step" in text and "= structure" in text
    assert counts["rowquant_matmul"] > 0 and counts["unpack_dequantize"] > 0
    assert counts["random_bits"] > 0


def test_request_plan_is_within_the_stated_ranges():
    cs = _chip_smoke()
    reqs = cs.continuous_requests(50304)
    assert len(reqs) == 12
    assert all(32 <= len(r.prompt) <= 384 and 16 <= r.max_new_tokens <= 32 for r in reqs)
    shared = [r for r in reqs if r.prompt[:128] == reqs[0].prompt[:128]]
    assert len(shared) == 6 and sum(r.needs_sampling for r in reqs) == 6
