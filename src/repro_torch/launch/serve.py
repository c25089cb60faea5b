"""Serving launcher of the port, on the card: one-shot batched generation
with quantized FSDP weight gathers, or a request queue drained by the
continuous-batching scheduler.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-1.3b \\
      --batch 4 --prompt-len 128 --gen 16

Continuous batching (--continuous): a fixed pool of --batch decode slots,
requests admitted into freed slots mid-decode, per-request sampling;
chunked admission with --prefill-chunk, the paged KV pool with
--kv-block-size and its quantized cold tier with --kv-quant-bits:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-1.3b \\
      --continuous --batch 4 --requests 12 --prompt-len 384 --gen 32 \\
      --temperature 0.8 --top-k 40 --prefill-chunk 64 --prefill-buckets 3 \\
      --kv-block-size 16 --kv-quant-bits 4 --kv-quant-horizon 8

Self-speculative decoding (--continuous): a --draft-bits draft of the same
weights drafts up to --draft-depth tokens per slot per step, verified at
serving precision (add ``--draft-bits 4 --draft-depth 4`` above).

``--arch`` takes any config of ``repro_torch.configs`` (the MoE family
too: ``--arch olmoe-1b-7b``; the SSM, hybrid, VLM and audio families,
``--arch mamba2-370m`` / ``zamba2-7b`` / ``qwen2-vl-72b`` /
``seamless-m4t-large-v2``, serve with whole-prompt prefill: no chunked
prefill, paged pool or speculation, as in the reference; the VLM and audio
prompts carry the reference's modality stubs, and qwen2-vl-72b's 286 GB of
f32 weights do not fit one card at full depth); ``--smoke`` serves its
2-layer smoke config; ``--device cpu`` runs the plain versions of the
kernels on the CPU.  Serving runs on one rank: ``--data-par`` or
``--model-par`` above 1 waits for ROADMAP A10e.  ``--plan PLAN.json`` (from
``repro_torch.tune.autotune``) pins the QSDP comm policy and gives the
serve knobs' defaults; flags typed on the command line still win.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import prng
from ..core.qsdp import QSDPConfig
from ..data import SyntheticLM
from ..serve import Request, build_serve_setup, make_prompt_batch, make_scheduler


def _build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", type=str, default=None,
                    help="DeploymentPlan JSON from repro_torch.tune.autotune: supplies "
                         "the QSDP comm policy and the serve knobs' defaults (flags "
                         "typed still win)")
    ap.add_argument("--arch", default="gpt-125m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8,
                    help="batch size (one-shot) / decode-slot pool size (--continuous)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--baseline", action="store_true",
                    help="the paper's FSDP baseline: fp32 weight gathers")
    ap.add_argument("--data-par", type=int, default=1,
                    help="FSDP ranks; serving runs on one (ROADMAP A10e)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="tensor-parallel ranks; serving runs on one (ROADMAP A10e)")
    ap.add_argument("--wbits", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default when a card is present) or cpu")
    # continuous batching
    ap.add_argument("--continuous", action="store_true",
                    help="serve a request queue through the continuous-batching scheduler")
    ap.add_argument("--requests", type=int, default=16,
                    help="--continuous: number of queued requests")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="--continuous: per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="--continuous: per-request top-k (0 = full vocab)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="--continuous: prefill at most this many prompt tokens per "
                         "scheduler step (0 = blocking whole-prompt admission)")
    ap.add_argument("--prefill-buckets", type=int, default=4,
                    help="--continuous: chunk length buckets")
    ap.add_argument("--prefill-interleave", type=int, default=1,
                    help="--continuous: chunk launches per scheduler step")
    ap.add_argument("--kv-block-size", type=int, default=0,
                    help="paged KV pool block size in tokens (0 = per-slot ring; > 0 "
                         "requires --prefill-chunk and enables prefix sharing)")
    ap.add_argument("--kv-pool-blocks", type=int, default=0,
                    help="physical KV blocks in the pool (0 = one full window per slot)")
    ap.add_argument("--kv-quant-bits", type=int, default=0,
                    help="--continuous paged: re-encode idle cached prefix blocks into "
                         "the wire format at this bit width (0 = cold tier off)")
    ap.add_argument("--kv-quant-horizon", type=int, default=64,
                    help="--continuous paged: idle scheduler steps before a cached "
                         "block demotes to the cold tier")
    ap.add_argument("--draft-bits", type=int, default=0,
                    help="--continuous: bit width of the self-speculative draft (0 = off; "
                         "2-4 typical); the draft re-quantizes the same weights")
    ap.add_argument("--draft-depth", type=int, default=0,
                    help="--continuous: draft up to this many tokens per slot per step, "
                         "verified at serving precision (<= 1 = off)")
    return ap


# plan serve-section field -> launcher flag dest
_PLAN_SERVE_DESTS = {
    "slots": "batch", "prefill_chunk": "prefill_chunk",
    "prefill_buckets": "prefill_buckets",
    "prefill_interleave": "prefill_interleave",
    "kv_block_size": "kv_block_size", "kv_pool_blocks": "kv_pool_blocks",
    "kv_quant_bits": "kv_quant_bits", "kv_quant_horizon": "kv_quant_horizon",
    "draft_bits": "draft_bits", "draft_depth": "draft_depth",
}


def validate_args(ap, args) -> None:
    """Reject inconsistent flags at parse time, with a one-line reason."""
    if args.data_par != 1:
        ap.error(f"--data-par {args.data_par}: serving over more than one rank is not "
                 "ported yet (ROADMAP A10e)")
    if args.model_par != 1:
        ap.error(f"--model-par {args.model_par}: serving over more than one rank is not "
                 "ported yet (ROADMAP A10e)")
    if not 2 <= args.wbits <= 8:
        ap.error(f"--wbits must be in 2..8 (got {args.wbits})")
    if min(args.batch, args.prompt_len, args.gen) < 1:
        ap.error("--batch, --prompt-len and --gen must be >= 1")
    if args.draft_bits and not 2 <= args.draft_bits <= 8:
        ap.error(f"--draft-bits must be 0 (off) or in 2..8 (got {args.draft_bits}): the "
                 "draft re-quantizes the serving weights through the 2-8 bit wire kernels")
    if args.kv_quant_bits and not 2 <= args.kv_quant_bits <= 8:
        ap.error(f"--kv-quant-bits must be 0 (off) or in 2..8 (got {args.kv_quant_bits})")
    if args.prefill_buckets < 1:
        ap.error(f"--prefill-buckets must be >= 1 (got {args.prefill_buckets})")
    if min(args.prefill_chunk, args.kv_block_size, args.kv_pool_blocks,
           args.prefill_interleave - 1) < 0:
        ap.error("--prefill-chunk/--kv-block-size/--kv-pool-blocks must be >= 0 and "
                 "--prefill-interleave >= 1")
    if args.kv_block_size and not args.prefill_chunk:
        ap.error("--kv-block-size requires --prefill-chunk (paged serving admits "
                 "through chunked prefill)")
    if args.kv_quant_bits and not args.kv_block_size:
        ap.error("--kv-quant-bits requires --kv-block-size (the cold tier demotes "
                 "paged pool blocks)")
    if (args.draft_bits > 0) != (args.draft_depth > 1):
        ap.error("speculative decode needs BOTH --draft-bits >= 2 and --draft-depth >= 2")
    if args.draft_depth > 1 and not args.continuous:
        ap.error("--draft-depth requires --continuous (speculation lives in the "
                 "scheduler's draft/verify phases)")
    if args.requests < 1:
        ap.error(f"--requests must be >= 1 (got {args.requests})")
    if args.plan and args.baseline:
        ap.error("--plan pins the QSDP comm policy; don't combine it with --baseline")


def parse_args(argv=None):
    ap = _build_parser()
    args = ap.parse_args(argv)
    plan_qsdp = None
    if args.plan:
        from ..tune.plan import DeploymentPlan
        try:
            plan = DeploymentPlan.load(args.plan)
            # the port serves on the (1, 1) mesh
            plan.validate_mesh(("data", "model"), (1, 1))
            plan_qsdp = plan.to_qsdp_config(QSDPConfig())
            knobs = plan.serve_knobs()
        except (OSError, ValueError) as e:
            ap.error(f"--plan {args.plan}: {e}")
        # the plan's serve section provides the DEFAULTS; flags the user
        # typed still win (argparse re-parse with updated defaults)
        ap.set_defaults(**{_PLAN_SERVE_DESTS[k]: v for k, v in knobs.items()
                           if k in _PLAN_SERVE_DESTS})
        args = ap.parse_args(argv)
    args.plan_qsdp = plan_qsdp
    validate_args(ap, args)
    return args


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_continuous(setup, args) -> int:
    rng = np.random.default_rng(args.seed)
    sched = make_scheduler(
        setup, gather_key=prng.PRNGKey(args.seed), prefill_chunk=args.prefill_chunk,
        prefill_buckets=args.prefill_buckets, prefill_interleave=args.prefill_interleave,
        kv_quant_bits=args.kv_quant_bits if args.kv_block_size else 0,
        kv_quant_horizon=args.kv_quant_horizon)
    # mixed prompt/gen lengths, seeded
    for i in range(args.requests):
        plen = int(rng.integers(max(args.prompt_len // 2, sched.engine.dm.min_prompt_len),
                                args.prompt_len + 1))
        gen = int(rng.integers(max(args.gen // 2, 1), args.gen + 1))
        sched.submit(Request(
            rid=f"req{i}", prompt=rng.integers(0, setup.cfg.vocab_size, size=plen).tolist(),
            max_new_tokens=gen, temperature=args.temperature, top_k=args.top_k,
            seed=args.seed + i))
    _sync(setup.device)
    t0 = time.perf_counter()
    done = sched.run()
    _sync(setup.device)
    dt = time.perf_counter() - t0
    st = sched.stats()
    lat = [c.finish_step - c.submit_step for c in done.values()]
    ttft = [c.first_token_time - c.submit_time for c in done.values()]
    print(f"# {setup.cfg.name} continuous on {setup.device}: {len(done)} requests, "
          f"{st['tokens_generated']} tokens in {dt:.2f}s "
          f"({st['tokens_generated'] / dt:.1f} tok/s incl. kernel build), "
          f"occupancy {st['mean_occupancy']:.2f}/{st['slots']}, "
          f"latency p50={np.percentile(lat, 50):.0f} p95={np.percentile(lat, 95):.0f} steps, "
          f"ttft p95={np.percentile(ttft, 95):.3f}s")
    if args.prefill_chunk:
        print(f"# chunked prefill: chunk={args.prefill_chunk} buckets={sched.buckets} -> "
              f"{st['prefill_chunks']} chunk launches, {st['prefill_traces']} bucket shapes")
    if sched.pool is not None:
        print(f"# paged KV pool: {st['blocks_total']} blocks x {setup.spec.kv_block_size} "
              f"tok, prefix hit rate {st['prefix_hit_rate']:.2f}, cow forks "
              f"{st['cow_forks']}, cold blocks {st['cold_blocks']} (demoted "
              f"{st['demotions']}, rehydrated {st['rehydrations']}, {st['cold_bytes']} bytes)")
    if setup.spec.speculative:
        print(f"# speculative: draft {setup.spec.draft_bits}-bit x depth "
              f"{setup.spec.draft_depth} -> accepted/launch {st['accepted_per_launch']:.2f}, "
              f"launches/token {st['launches_per_token']:.2f}, draft overhead "
              f"{st['draft_overhead']:.2f} draft lane-steps/token")
    first = done[sorted(done)[0]]
    print("sample:", first.tokens.tolist())
    return 0


def run_batch(setup, args) -> int:
    data = SyntheticLM(vocab_size=setup.cfg.vocab_size, seq_len=args.prompt_len,
                       global_batch=args.batch, seed=args.seed)
    tokens, _ = data.sample(0)
    prompt = make_prompt_batch(setup.cfg, setup.spec, setup.ms, tokens, setup.device)
    kw = {}
    if setup.spec.paged:  # paged serving prefills in chunks, one fixed model
        kw = dict(prefill_chunk=args.prefill_chunk, prefill_buckets=args.prefill_buckets,
                  fold_step_keys=False)
    t0 = time.perf_counter()
    out = setup.engine.generate(setup.params, prompt, n_tokens=args.gen, **kw)
    _sync(setup.device)
    dt = time.perf_counter() - t0
    print(f"# {setup.cfg.name} on {setup.device}: generated {args.batch}x{args.gen} "
          f"tokens in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s incl. "
          f"kernel build)")
    print("sample:", out[0].tolist())
    return 0


def main(argv=None):
    args = parse_args(argv)
    if args.plan_qsdp is not None:
        qsdp = args.plan_qsdp
    else:
        qsdp = QSDPConfig.baseline() if args.baseline else QSDPConfig(weight_bits=args.wbits)
    setup = build_serve_setup(
        args.arch, smoke=args.smoke, qsdp=qsdp, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
        sampling=args.continuous and (args.temperature > 0 or args.top_k > 1),
        kv_block_size=args.kv_block_size, kv_pool_blocks=args.kv_pool_blocks,
        draft_bits=args.draft_bits, draft_depth=args.draft_depth, device=args.device)
    if args.continuous:
        return run_continuous(setup, args)
    return run_batch(setup, args)


if __name__ == "__main__":
    raise SystemExit(main())
