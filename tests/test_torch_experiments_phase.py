"""``chip_smoke.py``'s experiments phase rehearsed on the CPU: every twin of
the paper suite at 3 steps per run and 1 theory seed, Table 1's full-width
runs at gpt-125m's smoke config, the K1/K2 launch counts the phase derives
from the code's structure (against the wrappers' calls: they count only
kernel launches, so the rehearsal counts calls), and each twin's JSON with
the reference's keys.  At 3 steps the training gates are only reported."""
import importlib.util
import json
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.experiments._trainer import BENCH_MODEL, qsdp_wg
from repro_torch.kernels import ops

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the keys of each reference benchmark's JSON (benchmarks/*.py)
THEORY_KEYS = {"kappa", "T", "eta", "delta", "lattice_opt", "shift", "unquantized",
               "rtn_coarse", "shift_coarse", "shift_gradquant", "theorem_holds", "gq_holds"}
TABLE1_RUNS = {"baseline-fsdp", "qsdp-w8g8", "qsdp-w8g8-rtn-nobucket"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_experiments_phase_rehearsal(monkeypatch, tmp_path):
    cs = _chip_smoke()
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    for k, v in dict(table1=3, table2=3, table3=3, fig78=3, theory_seeds=1, full_steps=3,
                     full_batch=2, full_seq=32).items():
        monkeypatch.setitem(cs.EXP, k, v)
    monkeypatch.setattr(cs, "EXP_RESULTS", str(tmp_path))
    for name, kernel in (("quantize_pack", "quantize_pack"),
                         ("unpack_dequantize", "unpack_dequantize"),
                         ("unpack_dequantize_wire", "unpack_dequantize")):
        def counted(*a, _orig=getattr(ops, name), _kernel=kernel, **k):
            ops.LAUNCHES[_kernel] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    # the profiled steps read kernel events, which only the card records
    profiled = []
    monkeypatch.setattr(cs, "profile_train_step",
                        lambda torch_, run, state, log, tag: profiled.append(run(state)) or dict(
                            kernels=0, busy_ms=0.0, wall_ms=0.0, k1_ms=0.0, k1_n=0, k2_ms=0.0,
                            k2_n=0))
    lines = []
    counts, gates = cs.experiments_phase(torch, lines.append, dev="cpu", enforce=False)
    assert len(profiled) == 2

    # bench GPT, W8G8: embed + 2 layers x 7 weights gathered, replayed and
    # reduce-scattered (15 + 14 + 15 K1); K2 per buffer (3 + 2 + 3)
    per = cs.expected_run_launches(qsdp_wg(8, 8), BENCH_MODEL, 1)
    assert per == {"quantize_pack": 44, "unpack_dequantize": 8}
    # 3 steps each: Table 1 (baseline, W8G8, rtn), Table 2 (4), Table 3 (2),
    # Figures 7/8 (1), then gpt-125m smoke W8G8 (its baseline launches none)
    runs = 2 + 4 + 2 + 1
    assert counts["quantize_pack"] == 3 * 44 * runs + 3 * 44
    assert counts["unpack_dequantize"] == 3 * 8 * runs + 3 * 8
    assert gates["theory_convergence"] and gates["table3_learned_levels"]
    assert any("Table 1 at gpt-125m-smoke" in x for x in lines)

    theory = json.loads((tmp_path / "theory_convergence.json").read_text())
    assert [r["kappa"] for r in theory] == [2.0, 4.0, 8.0]
    assert all(set(r) == THEORY_KEYS for r in theory)
    t1 = json.loads((tmp_path / "table1_recovery.json").read_text())
    assert set(t1) == TABLE1_RUNS
    assert all(set(v) == {"final_loss", "ppl", "losses"} for v in t1.values())
    t2 = json.loads((tmp_path / "table2_bits_grid.json").read_text())
    assert set(t2) == {f"w{w}g{g}" for w in (8, 4) for g in (8, 4)}
    t3 = json.loads((tmp_path / "table3_learned_levels.json").read_text())
    assert set(t3) == {"compression", "wins", "total", "train"}
    assert set(t3["train"]) == {"w4_uniform", "w4_adaptive"} and t3["total"] == 12
    assert all(set(v) == {"uniform", "learned"} for v in t3["compression"].values())
    f78 = json.loads((tmp_path / "fig78_compression_error.json").read_text())
    assert set(f78) == {"layers/wq", "embed"}
    assert all(set(c) == {"step", "uniform", "learned"} for v in f78.values() for c in v)
