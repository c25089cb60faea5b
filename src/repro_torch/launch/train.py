"""Training launcher of the port: QSDP training of the dense GPT family on
one card, with flag parity to the JAX package's ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-1.3b \\
      --steps 10 --batch 4 --seq 2048 --n-micro 2

``--smoke`` trains the 2-layer smoke config; ``--device cpu`` runs the
plain versions of the kernels on the CPU.  Uses the deterministic synthetic
Markov corpus, so loss curves are reproducible.  Flags of the JAX launcher
that need more than one rank, and the comm-policy knobs that come with
them, exit with an error naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import argparse
import json
import math
import time

from .. import configs
from ..core import prng
from ..core.qsdp import MeshSpec, QSDPConfig
from ..data import SyntheticLM, make_batch
from ..device import resolve_device
from ..models.transformer import Model
from ..optim import AdamWConfig, cosine_schedule, make_adamw
from ..train.checkpoint import save_checkpoint
from ..train.step import build_train_step, init_train_state, quantize_train_state

# flags of the JAX launcher this port does not run yet: (flag, ROADMAP item)
_NOT_PORTED = (("--hierarchical", "A3b"), ("--prefetch", "A4b"),
               ("--coalesce-max-bytes", "A12"), ("--plan", "A12"))


def build_qsdp(args) -> QSDPConfig:
    if args.baseline:
        return QSDPConfig.baseline()
    return QSDPConfig(weight_bits=args.wbits, grad_bits=args.gbits,
                      bucket_size=args.bucket, min_quant_size=args.min_quant_size,
                      coalesce=args.coalesce)


def validate_args(ap: argparse.ArgumentParser, args) -> None:
    for flag, item in _NOT_PORTED:
        if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
            ap.error(f"{flag} is not ported yet (ROADMAP {item})")
    if args.data_par != 1 or args.model_par != 1:
        ap.error("--data-par/--model-par > 1: multi-rank training is not ported yet "
                 "(ROADMAP A3b/A4b)")
    for flag, v in (("--wbits", args.wbits), ("--gbits", args.gbits),
                    ("--master-bits", args.master_bits)):
        if not 2 <= v <= 8:
            ap.error(f"{flag} must be in 2..8 (got {v}) — the wire format packs "
                     "2-8 bit codes")
    if args.moment_bits is not None and not 2 <= args.moment_bits <= 8:
        ap.error(f"--moment-bits must be in 2..8 (got {args.moment_bits})")
    if args.bucket <= 0:
        ap.error(f"--bucket must be positive (got {args.bucket})")
    if min(args.steps, args.batch, args.seq, args.n_micro) < 1:
        ap.error("--steps, --batch, --seq and --n-micro must be >= 1")
    if args.batch % args.n_micro:
        ap.error(f"--batch {args.batch} does not split into --n-micro {args.n_micro}")
    if args.quantize_master and args.quantized_state:
        ap.error("--quantize-master (QDQ f32 state) and --quantized-state "
                 "(wire-code state) are mutually exclusive")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-125m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--baseline", action="store_true", help="FSDP fp baseline")
    ap.add_argument("--wbits", type=int, default=8)
    ap.add_argument("--gbits", type=int, default=8)
    ap.add_argument("--bucket", type=int, default=1024)
    ap.add_argument("--min-quant-size", type=int, default=2048)
    ap.add_argument("--hierarchical", action="store_true")
    ap.add_argument("--coalesce", action=argparse.BooleanOptionalAction, default=True,
                    help="coalesced wire format (one u8 collective per layer gather)")
    ap.add_argument("--prefetch", action="store_true")
    ap.add_argument("--coalesce-max-bytes", type=int, default=None)
    ap.add_argument("--plan", type=str, default=None)
    ap.add_argument("--quantize-master", action="store_true",
                    help="f32 state, QDQ-round-tripped through Q^w each step")
    ap.add_argument("--quantized-state", action="store_true",
                    help="master weights rest as packed wire codes (QuantizedParam)")
    ap.add_argument("--master-bits", type=int, default=8)
    ap.add_argument("--moment-bits", type=int, default=None,
                    help="store Adam mu/nu as packed codes of this width")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--out-json", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default when a card is present) or cpu")
    args = ap.parse_args(argv)
    validate_args(ap, args)
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    qsdp = build_qsdp(args)
    model = Model(cfg, MeshSpec(axes=("data", "model"), shape=(1, 1)), qsdp)
    opt = make_adamw(AdamWConfig(lr=args.lr,
                                 schedule=cosine_schedule(args.lr, args.warmup, args.steps),
                                 moment_bits=args.moment_bits))
    state = init_train_state(model, opt, args.seed, device)
    if args.quantized_state:
        state = quantize_train_state(state, model, prng.PRNGKey(args.seed + 2),
                                     master_bits=args.master_bits)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)
    step = build_train_step(model, opt, n_micro=args.n_micro,
                            quantize_master=args.quantize_master,
                            master_bits=args.master_bits,
                            quantized_state=args.quantized_state, device=device)
    tag = "baseline-FSDP" if args.baseline else f"QSDP W{args.wbits}G{args.gbits}"
    if args.quantized_state:
        tag += f" qstate{args.master_bits}" + (f"m{args.moment_bits}" if args.moment_bits else "")
    n_params = sum(math.prod(s.shape) * (s.stack or 1) for s in model.specs.values())
    print(f"# {cfg.name} [{tag}] on {device}: batch={args.batch} seq={args.seq} "
          f"params~{n_params / 1e6:.1f}M bigram-floor={data.bigram_entropy():.3f} nats")
    log = []
    t0 = time.time()
    for i in range(args.steps):
        batch = make_batch(data, i, device)
        state, m = step(state, batch, prng.fold_in(prng.PRNGKey(args.seed + 1), i))
        if i % args.log_every == 0 or i == args.steps - 1:
            log.append(dict(step=i, loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
                            t=time.time() - t0))
            print(f"step {i:5d} loss {log[-1]['loss']:7.4f} gnorm {log[-1]['gnorm']:8.3f} "
                  f"({log[-1]['t']:6.1f}s)")
    if args.ckpt:
        save_checkpoint(args.ckpt, state, meta=dict(arch=cfg.name, steps=args.steps))
        print(f"checkpoint -> {args.ckpt}")
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(dict(arch=cfg.name, tag=tag, device=str(device), log=log), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
