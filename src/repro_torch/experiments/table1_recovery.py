"""Table 1 -- accuracy recovery of QSDP W8G8 against the FSDP baseline, the
JAX package's ``benchmarks/table1_recovery.py`` on the port.

The paper trains GPT-{125M,350M,1.3B} on C4 and shows QSDP's final
perplexity matches the baseline (35.81 vs 35.58 etc.).  Here the bench GPT
trains on the synthetic Markov corpus, and the W8G8 final loss must be
within 8 % of the baseline's and far below the no-learning floor (ln V).
Also reproduces the paper's remark that naive unbucketed round-to-nearest
quantization is clearly worse.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..core.qsdp import QSDPConfig
from ..device import resolve_device
from ._trainer import BENCH_MODEL, qsdp_wg, run_line, train_run

OUT_DIR = "results/torch_bench"
RECOVERY_BAND = 0.08   # |W8G8 - baseline| <= 8 % of the baseline
LEARNED_FRACTION = 0.75  # W8G8 final loss < 0.75 ln V


def recovery_gates(base: float, q: float, vocab: int) -> tuple[bool, bool]:
    """(recovered, learned): the reference's two gates."""
    return abs(q - base) <= RECOVERY_BAND * base, q < LEARNED_FRACTION * np.log(vocab)


def main(argv=None, out_dir=OUT_DIR):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(out_dir, exist_ok=True)

    runs = {
        "baseline-fsdp": QSDPConfig.baseline(),
        "qsdp-w8g8": qsdp_wg(8, 8),
        "qsdp-w8g8-rtn-nobucket": qsdp_wg(8, 8, weight_mode="nearest",
                                          grad_mode="nearest", bucket_size=65536),
    }
    results = {}
    for tag, cfg in runs.items():
        r = train_run(cfg, steps=args.steps, tag=tag, device=device)
        results[tag] = r
        print(f"{tag:26s} final_loss={r.final_loss:.4f} ppl={r.ppl:.2f} {run_line(r)}")

    base = results["baseline-fsdp"].final_loss
    q = results["qsdp-w8g8"].final_loss
    floor = np.log(BENCH_MODEL.vocab_size)
    recovered, learned = recovery_gates(base, q, BENCH_MODEL.vocab_size)
    print(f"\nrecovery: |{q:.4f} - {base:.4f}| <= 8% of baseline: "
          f"{'PASS' if recovered else 'FAIL'}; learned (vs ln V = {floor:.2f}): "
          f"{'PASS' if learned else 'FAIL'}")

    with open(os.path.join(out_dir, "table1_recovery.json"), "w") as f:
        json.dump({t: dict(final_loss=r.final_loss, ppl=r.ppl, losses=r.losses)
                   for t, r in results.items()}, f, indent=1)
    return 0 if (recovered and learned) else 1


if __name__ == "__main__":
    raise SystemExit(main())
