"""Runs the port's experiments, one per paper table or figure.

  PYTHONPATH=src python -m repro_torch.experiments.run [--full] [--only X] [--device cpu]

| experiment                   | paper artifact               |
|------------------------------|------------------------------|
| theory_convergence           | Theorem 2 / Corollary 3      |
| table1_recovery              | Table 1 (W8G8 recovery)      |
| table2_bits_grid             | Table 2 (W x G bit grid)     |
| table3_learned_levels        | Tables 3/6 (learned levels)  |
| fig78_compression_error      | Figures 7/8                  |

The reference's suite also runs ``fig4_bandwidth_model`` and
``roofline_report``; they are not ported yet (ROADMAP A4b, A12).
Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

from ..device import resolve_device


def suite(full: bool = False, device: str | None = None) -> list:
    """(name, main, argv) of each experiment at the reference suite's
    steps (400 with `full`)."""
    from . import (fig78_compression_error, table1_recovery, table2_bits_grid,
                   table3_learned_levels, theory_convergence)
    steps = "400" if full else None
    dev = ["--device", device] if device else []
    return [
        ("theory_convergence", theory_convergence.main, dev),
        ("table1_recovery", table1_recovery.main, ["--steps", steps or "240"] + dev),
        ("table2_bits_grid", table2_bits_grid.main,
         ["--steps", steps or "160"] + (["--full"] if full else []) + dev),
        ("table3_learned_levels", table3_learned_levels.main, ["--steps", steps or "160"] + dev),
        ("fig78_compression_error", fig78_compression_error.main,
         ["--steps", steps or "160"] + dev),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="longer training runs")
    ap.add_argument("--only", type=str, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: stop here

    failures = []
    for name, fn, argv_i in suite(args.full, args.device):
        if args.only and args.only != name:
            continue
        print("\n" + "=" * 72)
        print(f"== benchmark: {name}")
        print("=" * 72, flush=True)
        t0 = time.time()
        try:
            rc = fn(argv_i)
        except SystemExit as e:  # argparse in sub-benchmarks
            rc = int(e.code or 0)
        print(f"== {name}: {'OK' if rc == 0 else 'FAIL'} ({time.time() - t0:.0f}s)")
        if rc != 0:
            failures.append(name)

    print("\n" + "=" * 72)
    if failures:
        print("FAILED:", ", ".join(failures))
    else:
        print("ALL BENCHMARKS OK")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
