"""Training launcher of the port: QSDP training of the dense, MoE, SSM and
hybrid families on one card, and of the dense family over a (P, M) mesh of
P data-parallel by M tensor-parallel ranks, with flag parity to the JAX
package's ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-1.3b \\
      --steps 10 --batch 4 --seq 2048 --n-micro 2

Over the (P, M) mesh, one process a rank:

  torchrun --nproc_per_node P·M -m repro_torch.launch.train \\
      --data-par P --model-par M ...

Under torchrun (``WORLD_SIZE`` set) the launcher forms the groups
(``launch.mesh.init_distributed``: NCCL on the card, gloo with ``--device
cpu``), at one rank too; P·M must equal the world size.  Each data rank
steps its own rows of every global batch (``--batch`` splits over P only;
the M ranks of a data rank take the same rows); global rank 0 alone prints
and writes the checkpoint and the JSON log.

``--smoke`` trains the 2-layer smoke config; ``--device cpu`` runs the
plain versions of the kernels on the CPU.  ``--plan PLAN.json`` (from
``repro_torch.tune.autotune``) pins the comm policy instead of the
individual flags.  Uses the deterministic synthetic
Markov corpus, so loss curves are reproducible.  What the port does not
run yet exits with an error naming the ROADMAP item that brings it: the
other families over ranks, either axis (A11h).  ``--hierarchical`` sets
``QSDPConfig.hierarchical``, as the JAX launcher's does: this launcher
builds ("data", "model") meshes, as that one does, so no exchange changes
(the two-level exchanges need a "pod" axis: ``launch.mesh.
init_distributed`` and ``train.step.build_train_step``).  ``--prefetch`` pipelines each stack's layer gathers (the next
layer's encode and all-gather run while this layer computes, on a side
CUDA stream on the card); it requires coalescing, as the JAX launcher's
does.  The
VLM and audio families exit with an error too: their batches carry
modality inputs that the corpus does not give (the JAX launcher feeds the
same corpus and fails in ``loss_fn``); they train through
``train.step.build_train_step`` on a batch that carries them.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

from .. import configs
from ..core import prng
from ..core.qsdp import MeshSpec, QSDPConfig
from ..data import SyntheticLM, make_batch
from ..device import resolve_device
from ..models.transformer import Model
from ..optim import AdamWConfig, cosine_schedule, make_adamw
from ..train.checkpoint import save_checkpoint
from ..train.step import (build_train_step, init_train_state, local_batch,
                          quantize_train_state)
from .mesh import init_distributed

# families whose train batch carries inputs beside the tokens and labels
_MODALITY_INPUTS = {"vlm": "vision_embeds, vision_mask and M-RoPE positions",
                    "audio": "audio_embeds"}


def build_qsdp(args) -> QSDPConfig:
    if args.plan:
        return args.plan_qsdp
    if args.baseline:
        return QSDPConfig.baseline()
    return QSDPConfig(weight_bits=args.wbits, grad_bits=args.gbits,
                      bucket_size=args.bucket, min_quant_size=args.min_quant_size,
                      hierarchical=args.hierarchical,
                      coalesce=args.coalesce, prefetch=args.prefetch,
                      coalesce_max_bytes=args.coalesce_max_bytes)


def validate_args(ap: argparse.ArgumentParser, args) -> None:
    family = configs.get_config(args.arch).arch_type
    if family in _MODALITY_INPUTS:
        ap.error(f"--arch {args.arch}: a {family} model trains on batches that carry "
                 f"{_MODALITY_INPUTS[family]}, which the synthetic corpus does not give "
                 "(nor does the JAX package's launcher); train it through "
                 "train.step.build_train_step with such a batch")
    if args.prefetch and not args.coalesce:
        ap.error("--prefetch requires coalescing (the prefetch pipeline "
                 "carries the coalesced u8 wire buffer through the scan); "
                 "drop --no-coalesce")
    if args.data_par < 1 or args.model_par < 1:
        ap.error("--data-par/--model-par must be >= 1")
    n_ranks = args.data_par * args.model_par
    if n_ranks > 1 and family != "dense":
        ap.error(f"--arch {args.arch}: the {family} family over ranks is not ported yet "
                 "(ROADMAP A11h)")
    world = int(os.environ.get("WORLD_SIZE", 1))
    if n_ranks != world:
        ap.error(f"--data-par {args.data_par} x --model-par {args.model_par} trains over "
                 f"{n_ranks} ranks, one process each: launch it with torchrun "
                 f"--nproc_per_node {n_ranks} (the world has {world})")
    if args.batch % (args.data_par * args.n_micro):
        ap.error(f"--batch {args.batch} does not split into --data-par {args.data_par} x "
                 f"--n-micro {args.n_micro}")
    for flag, v in (("--wbits", args.wbits), ("--gbits", args.gbits),
                    ("--master-bits", args.master_bits)):
        if not 2 <= v <= 8:
            ap.error(f"{flag} must be in 2..8 (got {v}) — the wire format packs "
                     "2-8 bit codes")
    if args.moment_bits is not None and not 2 <= args.moment_bits <= 8:
        ap.error(f"--moment-bits must be in 2..8 (got {args.moment_bits})")
    if args.coalesce_max_bytes is not None and args.coalesce_max_bytes < 0:
        ap.error("--coalesce-max-bytes must be >= 0 (0 = never coalesce)")
    if args.bucket <= 0:
        ap.error(f"--bucket must be positive (got {args.bucket})")
    if min(args.steps, args.batch, args.seq, args.n_micro) < 1:
        ap.error("--steps, --batch, --seq and --n-micro must be >= 1")
    if args.quantize_master and args.quantized_state:
        ap.error("--quantize-master (QDQ f32 state) and --quantized-state "
                 "(wire-code state) are mutually exclusive")
    args.plan_qsdp = None
    if args.plan:
        if any([args.baseline, args.hierarchical, args.coalesce_max_bytes is not None,
                args.prefetch, not args.coalesce]):
            ap.error("--plan pins the comm policy; don't combine it with "
                     "--baseline/--hierarchical/--coalesce-max-bytes/--prefetch/"
                     "--no-coalesce")
        from ..tune.plan import DeploymentPlan
        try:
            plan = DeploymentPlan.load(args.plan)
            plan.validate_mesh(("data", "model"), (args.data_par, args.model_par))
            args.plan_qsdp = plan.to_qsdp_config(QSDPConfig())
        except (OSError, ValueError) as e:
            ap.error(f"--plan {args.plan}: {e}")


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
    ap.add_argument("--prefetch", action="store_true",
                    help="double-buffered layer prefetch (requires coalescing)")
    ap.add_argument("--coalesce-max-bytes", type=int, default=None,
                    help="per-layer byte threshold: gathers whose coalesced wire buffer "
                         "exceeds this fall back to per-tensor launches (None = always "
                         "coalesce)")
    ap.add_argument("--plan", type=str, default=None,
                    help="DeploymentPlan JSON from repro_torch.tune.autotune: pins the "
                         "whole comm policy instead of the individual flags above")
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
    ms = MeshSpec(axes=("data", "model"), shape=(args.data_par, args.model_par))
    group = model_group = None
    d = m = 0
    if "WORLD_SIZE" in os.environ:
        group, model_group, (d, m), device = init_distributed(args.device, ms)
    else:
        device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    qsdp = build_qsdp(args)
    model = Model(cfg, ms, qsdp, group, model_group)
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
    if args.plan:
        tag = f"QSDP plan W{qsdp.weight_bits}G{qsdp.grad_bits}"
    else:
        tag = "baseline-FSDP" if args.baseline else f"QSDP W{args.wbits}G{args.gbits}"
    if qsdp.coalesce_max_bytes is not None:
        tag += f" coalesce<={qsdp.coalesce_max_bytes}B"
    if args.quantized_state:
        tag += f" qstate{args.master_bits}" + (f"m{args.moment_bits}" if args.moment_bits else "")
    n_params = sum(math.prod(s.shape) * (s.stack or 1) for s in model.specs.values())
    rank0 = d == m == 0
    say = print if rank0 else (lambda *a, **k: None)
    say(f"# {cfg.name} [{tag}] mesh=({args.data_par},{args.model_par}) on {device}: "
        f"batch={args.batch} "
        f"seq={args.seq} params~{n_params / 1e6:.1f}M "
        f"bigram-floor={data.bigram_entropy():.3f} nats")
    log = []
    t0 = time.time()
    for i in range(args.steps):
        batch = local_batch(make_batch(data, i, device), d, args.data_par)
        state, m = step(state, batch, prng.fold_in(prng.PRNGKey(args.seed + 1), i))
        if i % args.log_every == 0 or i == args.steps - 1:
            log.append(dict(step=i, loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
                            t=time.time() - t0))
            say(f"step {i:5d} loss {log[-1]['loss']:7.4f} gnorm {log[-1]['gnorm']:8.3f} "
                f"({log[-1]['t']:6.1f}s)")
    if args.ckpt:
        save_checkpoint(args.ckpt, state, meta=dict(arch=cfg.name, steps=args.steps),
                        group=group, model_group=model_group)
        say(f"checkpoint -> {args.ckpt}")
    if args.out_json and rank0:
        with open(args.out_json, "w") as f:
            json.dump(dict(arch=cfg.name, tag=tag, device=str(device), log=log), f, indent=1)
    if group is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
