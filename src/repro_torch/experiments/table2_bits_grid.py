"""Table 2 -- final loss across the (weight bits x grad bits) grid, the JAX
package's ``benchmarks/table2_bits_grid.py`` on the port.  The paper's
shape: quality degrades as bits shrink, weight bits matter more than
gradient bits (W4 rows are worst)."""
from __future__ import annotations

import argparse
import json
import os

from ..device import resolve_device
from ._trainer import qsdp_wg, run_line, train_run

OUT_DIR = "results/torch_bench"


def main(argv=None, out_dir=OUT_DIR):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--full", action="store_true", help="3x3 grid (else 2x2)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(out_dir, exist_ok=True)

    bits = (8, 6, 4) if args.full else (8, 4)
    grid = {}
    for w in bits:
        for g in bits:
            r = train_run(qsdp_wg(w, g), steps=args.steps, tag=f"w{w}g{g}", device=device)
            grid[f"w{w}g{g}"] = r.final_loss
            print(f"W{w}G{g}: final_loss={r.final_loss:.4f} {run_line(r)}")

    print("\n# Table 2 shape (rows = weight bits, cols = grad bits)")
    print("      " + "  ".join(f"G{g:>6}" for g in bits))
    for w in bits:
        print(f"W{w}: " + "  ".join(f"{grid[f'w{w}g{g}']:7.4f}" for g in bits))

    # the paper's ordering: lowest weight bits is the worst row
    worst_w = bits[-1]
    best_w = bits[0]
    ordering = all(grid[f"w{worst_w}g{g}"] >= grid[f"w{best_w}g{g}"] - 0.02
                   for g in bits)
    print("weight-bits-dominate ordering:", "PASS" if ordering else "FAIL")
    with open(os.path.join(out_dir, "table2_bits_grid.json"), "w") as f:
        json.dump(grid, f, indent=1)
    return 0 if ordering else 1


if __name__ == "__main__":
    raise SystemExit(main())
