"""Serving launcher of the port: one-shot batched greedy generation with
quantized FSDP weight gathers, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-1.3b \\
      --batch 4 --prompt-len 128 --gen 16

``--smoke`` serves the 2-layer smoke config; ``--device cpu`` runs the
plain versions of the kernels on the CPU.  The continuous-batching
scheduler of the JAX launcher (``--continuous`` and its flags) comes with
ROADMAP A10.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core.qsdp import QSDPConfig
from ..data import SyntheticLM
from ..serve import build_serve_setup, make_prompt_batch


def _build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-125m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--baseline", action="store_true",
                    help="the paper's FSDP baseline: fp32 weight gathers")
    ap.add_argument("--wbits", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default when a card is present) or cpu")
    return ap


def parse_args(argv=None):
    ap = _build_parser()
    args = ap.parse_args(argv)
    if not 2 <= args.wbits <= 8:
        ap.error(f"--wbits must be in 2..8 (got {args.wbits})")
    if min(args.batch, args.prompt_len, args.gen) < 1:
        ap.error("--batch, --prompt-len and --gen must be >= 1")
    return args


def run_batch(setup, args) -> int:
    data = SyntheticLM(vocab_size=setup.cfg.vocab_size, seq_len=args.prompt_len,
                       global_batch=args.batch, seed=args.seed)
    tokens, _ = data.sample(0)
    prompt = make_prompt_batch(setup.cfg, setup.spec, setup.ms, tokens, setup.device)
    t0 = time.perf_counter()
    out = setup.engine.generate(setup.params, prompt, n_tokens=args.gen)
    if setup.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"# {setup.cfg.name} on {setup.device}: generated {args.batch}x{args.gen} "
          f"tokens in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s incl. "
          f"kernel build)")
    print("sample:", out[0].tolist())
    return 0


def main(argv=None):
    args = parse_args(argv)
    qsdp = QSDPConfig.baseline() if args.baseline else QSDPConfig(weight_bits=args.wbits)
    setup = build_serve_setup(args.arch, smoke=args.smoke, qsdp=qsdp, batch=args.batch,
                              prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                              device=args.device)
    return run_batch(setup, args)


if __name__ == "__main__":
    raise SystemExit(main())
