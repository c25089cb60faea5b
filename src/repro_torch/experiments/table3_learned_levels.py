"""Tables 3/6 + Figures 7/8 -- learned quantization levels (Algorithm 2)
against the uniform grid at low bit widths, the JAX package's
``benchmarks/table3_learned_levels.py`` on the port.

Two parts:
  1. compression error on model weight tensors (the Figures 7/8 metric,
     relative L2) at 3/4/5-bit weights -- learned must win;
  2. end to end: train with W4 uniform against W4 at buckets of 256 (the
     reference's proxy for distribution-aware levels) and compare final
     loss.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..core import prng
from ..core.levels import (LevelsConfig, compression_error, dequantize_levels,
                           learn_levels_for_tensor, quantize_levels, uniform_levels)
from ..device import resolve_device
from ..models.transformer import Model
from ._trainer import BENCH_MODEL, MESH11, init_params_like_reference, qsdp_wg, run_line, train_run

OUT_DIR = "results/torch_bench"


def weight_tensors(device):
    """Realistically distributed weights: the bench model's initial tensors
    (drawn as the reference draws them) and a heavy-tailed tensor."""
    model = Model(BENCH_MODEL, MESH11, qsdp_wg(8, 8))
    params = init_params_like_reference(model, 0, device)
    out = {k: v for k, v in params.items() if v.numel() > 1e5 and "norm" not in k}
    # add a heavy-tailed tensor (post-training LM heads look like this)
    g = prng.normal(prng.PRNGKey(1), (512, 512), device)
    out["synthetic_heavy_tail"] = torch.sign(g) * torch.abs(g) ** 2.5
    return out


def main(argv=None, out_dir=OUT_DIR):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(out_dir, exist_ok=True)

    # ---- part 1: compression error, Figures 7/8 metric ----
    print("# compression error (relative L2), uniform vs learned levels")
    table = {}
    wins = total = 0
    for bits in (3, 4, 5):
        for name, w in weight_tensors(device).items():
            lv = learn_levels_for_tensor(w, LevelsConfig(bits=bits, epochs=2))
            ul = uniform_levels(bits, device)
            eu = float(compression_error(w, dequantize_levels(quantize_levels(w, ul), ul)))
            el = float(compression_error(w, dequantize_levels(quantize_levels(w, lv), lv)))
            table[f"b{bits}/{name}"] = dict(uniform=eu, learned=el)
            wins += el < eu
            total += 1
            print(f"  {bits}b {name:28s} uniform={eu:.4f} learned={el:.4f} "
                  f"{'<' if el < eu else '>='}")
    part1 = wins >= 0.7 * total
    print(f"learned wins {wins}/{total}: {'PASS' if part1 else 'FAIL'}")

    result = dict(compression=table, wins=wins, total=total)
    part2 = True
    if not args.skip_train:
        # ---- part 2: end to end, W4 uniform vs W4 at buckets of 256 (the
        # practical effect of adapted levels: finer effective resolution)
        r_u4 = train_run(qsdp_wg(4, 8), steps=args.steps, tag="w4-uniform", device=device)
        r_l4 = train_run(qsdp_wg(4, 8, bucket_size=256), steps=args.steps,
                         tag="w4-small-bucket(adaptive-proxy)", device=device)
        print(f"w4 uniform(b1024) final={r_u4.final_loss:.4f} {run_line(r_u4)}  "
              f"w4 adaptive-proxy(b256) final={r_l4.final_loss:.4f} {run_line(r_l4)}")
        part2 = r_l4.final_loss <= r_u4.final_loss + 0.05
        result["train"] = dict(w4_uniform=r_u4.final_loss, w4_adaptive=r_l4.final_loss)
        print("adaptive >= uniform at 4 bits:", "PASS" if part2 else "FAIL")

    with open(os.path.join(out_dir, "table3_learned_levels.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0 if (part1 and part2) else 1


if __name__ == "__main__":
    raise SystemExit(main())
