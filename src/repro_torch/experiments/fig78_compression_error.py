"""Figures 7/8 -- compression error (relative L2) of uniform against
learned quantization levels tracked over training, the JAX package's
``benchmarks/fig78_compression_error.py`` on the port.

The paper learns levels once after warm-up and shows that (i) the learned
error stays below the uniform one for the whole run and (ii) both curves
drift together, so one learning pass suffices.  Tracked: an attention
projection and the embedding (the LM head) of the bench GPT at 4-bit
weights.
"""
from __future__ import annotations

import argparse
import json
import os

from ..core import prng
from ..core.levels import (LevelsConfig, compression_error, dequantize_levels,
                           learn_levels_for_tensor, quantize_levels, uniform_levels)
from ..data import SyntheticLM, make_batch
from ..device import resolve_device
from ..models.transformer import Model
from ..optim import AdamWConfig, cosine_schedule, make_adamw
from ..train.step import TrainState, build_train_step
from ._trainer import BENCH_MODEL, MESH11, init_params_like_reference, qsdp_wg

OUT_DIR = "results/torch_bench"
BITS = 4
TRACK = ["layers/wq", "embed"]


def main(argv=None, out_dir=OUT_DIR):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=160)
    ap.add_argument("--every", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=40)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(out_dir, exist_ok=True)

    model = Model(BENCH_MODEL, MESH11, qsdp_wg(8, 8))
    opt = make_adamw(AdamWConfig(lr=1e-3, schedule=cosine_schedule(1e-3, 20, args.steps)))
    params = init_params_like_reference(model, 0, device)
    state = TrainState(params=params, opt=opt.init(params))
    data = SyntheticLM(vocab_size=BENCH_MODEL.vocab_size, seq_len=128, global_batch=16, seed=0)
    step = build_train_step(model, opt, n_micro=1, device=device)

    levels = {k: None for k in TRACK}  # learned at warm-up, then frozen
    curves = {k: [] for k in TRACK}
    uniform = uniform_levels(BITS, device)

    def measure(i, params):
        for k in TRACK:
            w = params[k].reshape(-1)
            if levels[k] is None and i >= args.warmup:
                levels[k] = learn_levels_for_tensor(w, LevelsConfig(bits=BITS, epochs=2))
            eu = float(compression_error(w, dequantize_levels(quantize_levels(w, uniform),
                                                              uniform)))
            el = None
            if levels[k] is not None:
                el = float(compression_error(
                    w, dequantize_levels(quantize_levels(w, levels[k]), levels[k])))
            curves[k].append(dict(step=i, uniform=eu, learned=el))

    for i in range(args.steps):
        if i % args.every == 0:
            measure(i, state.params)
        state, _ = step(state, make_batch(data, i, device), prng.fold_in(prng.PRNGKey(1), i))
    measure(args.steps, state.params)

    print(f"# Figures 7/8: relative L2 compression error at {BITS}-bit weights")
    ok = True
    for k in TRACK:
        print(f"\n{k}:")
        for c in curves[k]:
            l = "     -" if c["learned"] is None else f"{c['learned']:.4f}"
            print(f"  step {c['step']:4d}  uniform={c['uniform']:.4f}  learned={l}")
        post = [c for c in curves[k] if c["learned"] is not None]
        wins = sum(c["learned"] < c["uniform"] for c in post)
        print(f"  learned < uniform at {wins}/{len(post)} checkpoints after warmup")
        ok &= wins >= 0.7 * len(post)

    with open(os.path.join(out_dir, "fig78_compression_error.json"), "w") as f:
        json.dump(curves, f, indent=1)
    print("fig78:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
