#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, each of which makes the script exit non-zero when it fails:

1. build   -- nvcc builds every kernel source of the port, in parallel.
2. kernels -- each CUDA kernel (K1 quantize->pack drawing its threefry
              bits from the key, K2 unpack->dequantize, K3 rowquant matmul,
              K4 unpacked quantize, K5 unpacked dequantize, and the
              sampler's draw random_bits) against its plain PyTorch version
              on the card at the gpt-1.3b shapes of its path: K1/K2/K4/K5
              and random_bits byte-equal, K3 within tolerance; K1/K2 also
              at the cold tier's block shape (W4, bucket 128), K3 also at
              the chunk path's M (off the path, for the record); K1/K2 at
              the experiments' policies at gpt-125m's embedding (W8 nearest
              at bucket 65536, W4 shift at 256, W6 at 1024); K2 also
              over a whole gpt-1.3b layer's wire buffer in one launch
              (bf16 and f32 out) and over segments off 16-byte alignment;
              at olmoe-1b-7b's shapes K1 W8 shift on one expert stack
              (134,217,728 values), K2 over a whole olmoe layer's buffer
              into bf16 and K2 on the draft's W4 expert stack.
              Times by CUDA events on cold L2 and by the profiler (kernel
              alone) beside the bound (bytes, f32 and INT32 operations),
              and beside the one library call that computes the same
              function where there is one (K2/K5: ``torch.addcmul``; K3:
              ``torch.matmul`` on the dequantized bf16 weight).  Then the
              K4/K5 entry points' own path (``quantize_buckets`` ->
              ``dequantize_buckets`` of an embedding-sized gradient).
3. small   -- the gpt-1.3b smoke config on the card and on the CPU (plain
              versions, which the CPU tests hold to the JAX package): served
              (gathered wire bytes equal, f32 logits within tolerance) and
              trained for 2 steps from the same state (gathered weights
              byte-equal, losses within tolerance).
4. serve   -- gpt-1.3b at full width and depth, batch 4, prompt 128, gen 16,
              greedy, seed 0, through ``build_serve_setup`` ->
              ``ServeEngine.generate``: dense, then rowquant MLP.  Launch
              counts per kernel are checked against the counts the code's
              structure predicts (K2: one per decoded wire buffer), and the
              two runs' first decode-step logits must agree.  ``--profile``
              adds a profiled decode step of each (kernel time by name, the
              bf16 casts and K2's launches).
5. continuous -- gpt-1.3b at full width and depth through
              ``make_scheduler`` -> ``ContinuousScheduler.run``: 4 slots,
              ring 512, KV block 16 (paged pool of 256 blocks, prefix
              sharing, 4-bit cold tier with horizon 8), chunk 64 with 3
              buckets, 12 requests (CONT_PLAN: half behind a shared
              128-token prefix, half sampled at temperature 0.8 / top-k 40).
              Two runs with the same tokens; greedy requests bit-equal to
              their solo runs; pool invariants, demotions and
              rehydrations; launch counts against the structure; one
              profiled step without int64 bitwise/shift kernels.  Every
              engine runs the fixed-shape route (every decode-path launch
              at blocks of 4 lanes), so every request that attaches no
              rehydrated block must equal its solo run on a batch-of-1
              engine, and the route's row gate must pass at every launch
              shape of the path.  Prints tokens/s, TTFT, step times,
              occupancy, prefix hit rate, cold bytes, which GEMM/attention
              launches are not row-invariant across row counts, and what
              the fixed shapes cost a batch-of-1 engine.
6. speculative -- the continuous phase's configuration and requests with
              self-speculative decoding (a 4-bit draft of depth 4): every
              request on no rehydrated block commits the tokens of its
              non-speculative batch-of-1 solo run, drafts are accepted,
              K1/K2/K3/random_bits launches equal the structure's, pool
              invariants; one profiled step.  Prints tokens/s, TTFT, the
              draft and verify launches' times, acceptance and draft
              overhead; the kernel phase adds K2 at the draft layer and K3
              at the draft MLP.
7. moe     -- the MoE family: olmoe-1b-7b's smoke config on the card and
              on the CPU (gathered wire bytes equal, expert stacks
              included; top-k experts equal where the CPU router margin is
              clear; logits within tolerance); then olmoe-1b-7b at full
              width (64 experts top-8) cut to MOE_SERVE_LAYERS = 2 of its
              16 layers for the run's time (random weights from seed 0,
              default QSDPConfig): batch serving (the
              serve phase's shape, run twice: equal tokens, K1 15 / K2 3
              launches per decode step as the structure derives them), the
              continuous phase's cell and
              gates and the speculative phase's (4-bit draft, depth 4;
              the draft's 3-D expert stacks go through K2, never K3), and
              the fixed-shape route's row gate at the MoE launch shapes.
              Prints the phase's seconds and peak memory.
7b. ssm    -- the SSM and hybrid families: mamba2-370m's and zamba2-7b's
              smoke configs on the card and on the CPU (gathered wire bytes
              equal, logits within tolerance, tokens equal), zamba2's smoke
              rowquant decode (shared MLP through K3) equal to its dense
              one; then mamba2-370m (SSM_SERVE_LAYERS: 6 of its 48 layers)
              and zamba2-7b (15 of 81 layers: two invocations of the shared
              attention+MLP block, each with its own KV ring, and the
              tail) at full width (both serve at full depth
              too), random weights from seed 0, default QSDPConfig: batch
              serving (the serve phase's shape, run twice: equal tokens,
              K1/K2 launches per step as the structure and the hand count
              derive them; zamba2 also rowquant, K3 on the shared
              w_gate/w_up), the continuous cell with blocking admission (4
              slots, ring 512 for zamba2's shared KV, CONT_PLAN: two runs
              equal, greedy requests equal to their batch-of-1 solo runs,
              launches, one profiled decode step) and the fixed-shape
              route's row gate at their launch shapes (the Mamba2
              projections and one recurrent step).  The kernel phase adds
              K1 on zamba2's w_z and mamba2's w_dt, K2 over a whole Mamba2
              layer of each, and K3 at zamba2's shared w_gate/w_up.
7c. vlmaudio -- the VLM and audio families: qwen2-vl-72b's and
              seamless-m4t-large-v2's smoke configs on the card and on the
              CPU (gathered wire bytes equal, logits within tolerance,
              tokens equal; qwen2-vl's on a prompt with an image block),
              seamless's smoke rowquant decode (decoder MLP through
              K3) equal to its dense one; then qwen2-vl-72b at full width
              cut to MM_LAYERS = 2 of 80 layers (80 layers hold 286 GB of
              f32 rest weights, 16 fit one card) and seamless-m4t-large-v2
              at full width cut to 3 of its 24 encoder and 24 decoder
              layers (both for the run's time), random weights from seed 0, default
              QSDPConfig: batch serving dense and rowquant (the serve
              phase's shape; qwen2-vl's prompts carry an 8 x 8 image block
              at positions 16-79 with Qwen2-VL's M-RoPE positions,
              seamless's the reference's audio stub of 64 frames), the
              first decode steps' logits dense vs rowquant within
              LOGIT_RTOL, launches by the structure and the hand count; the
              continuous cell with blocking admission (CONT_PLAN, greedy
              requests equal to their batch-of-1 solo runs, one profiled
              decode step); the fixed-shape route's row gate at their launch
              shapes, the decoder's cross-attention included.  The kernel
              phase adds K1 on a qwen2-vl-72b MLP weight and seamless's
              lm_head, K2 over a whole qwen2-vl-72b layer, and K3 at
              qwen2-vl's w_down and seamless's decoder w_gate/w_up.
8. train   -- gpt-1.3b at full width and depth, default QSDPConfig (W8
              shift weights, G8 stochastic gradients, bucket 1024,
              coalesced, bf16 compute, full remat), AdamW + cosine, batch 4
              x seq 2048, 2 microbatches, SyntheticLM seed 0, through
              ``build_train_step``: one warm-up step, 3 timed steps (launch
              counts checked against the code's structure), one step under
              torch.profiler (K1's device time, no threefry int64 kernels
              left); the same steps under remat "dots" (losses bit-equal to
              "full", launches equal; time and peak beside "full"); the
              same steps under ``QSDPConfig(prefetch=True)`` (losses and
              grad norms bit-equal to "full", K1/K2 launches equal to the
              prefetch form of the structure's: the layers' replays decode
              their carried wire buffers and encode nothing; time and peaks
              beside "full"; one profiled step: the layers' encodes on the
              side stream, as many as the pipeline starts, and the share
              of their time that compute-stream kernels overlap); then
              quantized_state vs quantize_master (8-bit moments) for 2
              steps, losses equal.
8b. moetrain -- olmoe-1b-7b's training: first its smoke config one f32
              step card vs CPU (loss and grad norm within the CPU tests'
              step tolerances when no CPU router margin is below
              ROUTE_MARGIN; routes equal where it is clear); then full width
              cut to 8 of 16 layers (3.46 G parameters, random weights from
              seed 0, default QSDPConfig, AdamW with 8-bit moments, TRAIN's
              batch, sequence, microbatches and schedule): step 0 twice from
              one state bit-equal, 3 timed steps (K1/K2 launches equal the
              structure's, moment codes included), the first loss less the
              load-balance term within 0.5 of ln 50,304, per-layer aux and
              capacity drops, one profiled step (busy share; K1, K2, expert
              products, dispatch/combine, attention; no int64 threefry
              kernel), then one quantized_state step equal to the
              quantize_master step.  The kernel phase adds K1 G8 stochastic
              on one expert-stack gradient and K2 into f32 over a whole
              olmoe layer's gradient buffer.
8c. ssmtrain -- the SSM and hybrid families' training: first
              mamba2-370m's and zamba2-7b's smoke configs one f32 step each
              card vs CPU (every gathered weight byte-equal, the shared
              block's at each invocation; loss and grad norm within the CPU
              tests' step tolerances); then mamba2-370m at full width and
              depth (48 layers, f32 moments) and zamba2-7b at full width cut
              to 39 of 81 layers (6 groups of 6 with the shared block after
              each, and a 3-layer tail; 3.36 G parameters; 8-bit moments),
              random weights from seed 0, default QSDPConfig, AdamW + cosine,
              TRAIN's batch, sequence, microbatches and schedule: step 0 twice
              from one state bit-equal, 3 timed steps (K1/K2 launches equal
              the structure's, the shared block's gathers and reduce-scatters
              once per invocation), the first loss within 0.5 of ln(vocab),
              for mamba2-370m one profiled step (busy share; no int64
              threefry kernel; zamba2-7b's by-part profile was cut for the
              run's time in PR 31).  Prints step times, tokens/s, peak memory and the
              phase's seconds.  The kernel phase adds K1 G8 stochastic on
              zamba2's w_z gradient and K2 into f32 over a whole zamba2
              Mamba2 layer's gradient buffer.
8d. mmtrain -- the VLM and audio families' training: first
              qwen2-vl-72b's and seamless-m4t-large-v2's smoke configs one
              f32 step each card vs CPU (every gathered weight byte-equal,
              the encoder's under its own key scope; qwen2-vl's batch with
              an image block; loss and grad norm within the CPU tests' step
              tolerances); then qwen2-vl-72b at full width cut to 2 of 80
              layers (3.00 G parameters, 8-bit moments; every row's image
              block a 16 x 32 grid at positions 64-575 with Qwen2-VL's
              M-RoPE positions, no loss on it) and seamless-m4t-large-v2 at
              full width and depth (24 encoder and 24 decoder layers, 2.04 G
              parameters, f32 moments; the frame stub of 1,024 frames),
              random weights from seed 0, default QSDPConfig, AdamW +
              cosine, TRAIN's batch, sequence, microbatches and schedule:
              step 0 twice from one state bit-equal, 3 timed steps (K1/K2
              launches equal the structure's, the encoder's gathers and
              reduce-scatters included), the first loss within 0.5 of
              ln(vocab) + d s^2 / 2, for qwen2-vl-72b one profiled step
              (busy share; no int64 threefry kernel) and one by part.  Prints
              step times, tokens/s, peak memory and the phase's seconds and
              peak.  The kernel phase adds K1 G8 stochastic on qwen2-vl's
              embedding gradient and seamless's lm_head gradient, and K2 into
              f32 over a whole qwen2-vl layer's gradient buffer.
9. experiments -- first the theory runs' draws (64-bit bits, f64 and f32
              uniforms), the f64 lattice quantizers and one ``run_qsgd``
              trajectory on the card against the CPU twin; then the
              paper's experiments through ``repro_torch.experiments``
              at the JAX package's suite sizes (its ``benchmarks/run.py``)
              but for the training runs' steps, halved for the run's time:
              the Theorem 2 / Corollary 3 table (3 kappas x 5 variants x 8
              seeds), Table 1 (120 steps of the suite's 240), Table 2 (2x2
              grid, 80 of 160), Tables 3/6 (compression at 3/4/5 bits, W4
              training, 80 of 160) and Figures 7/8 (80 of 160), on the
              2-layer bench GPT at batch 8 x seq 128;
              then Table 1 at gpt-125m's full width and depth (baseline vs
              W8G8, batch 8 x seq 512, 50 steps).  Every experiment's
              PASS/FAIL gates at the reference's bands, gpt-125m's losses
              finite and falling and its W8G8 within 8 % of the baseline,
              and K1/K2 launches equal to the structure's per train step;
              one profiled W8G8 step of each model.
10. tune   -- the deployment-plan autotuner (``repro_torch.tune``), both
              launchers' ``--plan`` and the examples' one-rank twins: the
              ``h100`` cost preset's t_launch and ser_bw fitted on one
              gpt-1.3b layer (forward + backward of ``gather_layer``, per
              tensor and coalesced timed in turns, median of 20) through
              the cost model's own equations at wire 0, and the committed
              preset's coalesce decision for that layer group held to the
              faster measured form (either within 5 %); ``tune.autotune`` at gpt-125m's full
              width and depth (batch 8 x seq 1024, the h100 preset, the
              shortlist measured by the port's train step: K1/K2 launches a
              step equal the structure's for each candidate's policy; the
              plan's layer policies equal the engine its qsdp section
              builds; predicted vs measured ms printed); ``launch/train.py
              --plan`` losses bit-equal to the equivalent flags' and
              ``launch/serve.py --plan`` tokens equal to ``--wbits``' (batch
              4 x prompt 128 x gen 16), launches by the structure; then
              ``examples/learned_levels`` (yi-6b smoke: learned beats
              uniform on every tensor, card within 1e-4 of the CPU),
              ``quickstart`` and ``train_gpt_qsdp --full-width --steps 20``
              (the last logged loss below the first).  Prints the phase's
              seconds.
11. roofline -- the train phase's profiled gpt-1.3b step and the tune
              phase's first measured gpt-125m step (its untimed second
              step, profiled) counted again on the meta device by the dry
              run's counter (``roofline.counter``: no new card step) and
              held against their runs on the card: the counted K1/K2
              launches equal the structure's and the step's, the counted
              product FLOPs (mm/addmm/bmm) the profiler's own
              (``with_flops``) within 1 %, the device's busy time at least
              the larger of the dtype-aware compute floor (bf16 products at
              989 TFLOP/s, f32 at 67) and t_memory_min, the counted peak of
              live bytes within 10 % of ``max_memory_allocated``.  Prints
              the counts, the three terms at the published peaks and the
              measured step, busy time and their ratio to the larger floor;
              then runs the dry run's gpt-1.3b x decode_32k pair on this
              host's torch (``launch/dryrun.py``).  Prints the phase's
              seconds.

12. analysis -- qlint's trace audit (``repro_torch.analysis.trace_audit``,
              the reference's jaxpr audit) on the card: the speculative
              phase traces one decode step, one chunked-prefill launch
              and one verify launch of gpt-1.3b on its engine (paged pool,
              sampling, 4-bit draft), the train phase one more f32 step
              and its last quantized_state step, each under the audit's
              dispatch mode over real launches (the trace's launches equal
              to the wrappers' counts); this phase traces the same five
              programs on the meta device at the same configurations.
              Gates: per program the findings (QJ101-103) on the card
              equal those on meta, and so do the kernel launches; no
              finding is new against ``src/repro_torch/analysis/
              qlint_baseline.json``.  Prints the findings, the launches and
              the seconds of the card traces and of the meta twin.
13. dist   -- QSDP over torch.distributed on the (data, model) grid, on one
              card: (b) the train launcher at gpt-125m under
              ``torch.distributed.run --standalone --nproc_per_node 1 ...
              --data-par 1 --model-par 1`` and without torchrun, side by side
              in processes of their own: losses bit-equal; (a) meanwhile, the
              one-rank grid's NCCL groups (data and model) formed through a
              FileStore, and one gpt-1.3b train step at full width and
              depth (TRAIN's batch) through them under the profiler: torch's
              records of the NCCL collectives as many as the port's counter
              of calls (``collectives.COMM``), which equals the structure's
              formula (``expected_train_comm``); then, once (b) is done, the
              step from the seed's state in place (``group=None``) and
              through the group: loss, grad norm and the device digests of
              every parameter and moment bit-equal, K1/K2 launches equal to
              the structure's.  (c) the wire work of P = 2, 4 and 8 ranks for
              one gpt-1.3b layer and its gradient, emulated in one process
              (each rank's K1 encodes under the shared key; the gathered
              buffer decoded by one K2 launch over a table of 7 P entries;
              each destination's P gradient rows dequant-summed), byte-equal
              to the same functions on K1/K2's plain versions; it runs in
              the kernel phase, which times the P-row decode against its
              bound (rows "gpt-1.3b gathered layer, P = ..."), and in this
              phase only without that one.  (d) tensor parallelism's blocks
              rank by rank: gpt-1.3b's attention and MLP blocks at full
              width (forward) at M = 2 and 4, and qwen2.5-3b's attention
              at M = 4 (its 2 KV heads replicated): each model rank's share
              computed from its tp-local weights, gathered through K1/K2 as
              the engine gathers them, the M shares summed in rank order,
              within TP_BLOCK_TOL of the one-rank block on the whole
              weights assembled from the same decoded shards, in bf16 and
              f32.  (e) the tp-local wire work of gpt-1.3b's layer at (P,
              M) = (1, 2), (1, 4), (1, 8) and (2, 2): each rank's K1
              encodes of its tp-local shards and K2's one decode of the P
              gathered rows, byte-equal to the plain versions; timed in the
              kernel phase (K1 on a rank's MLP shard, K2 beside
              ``torch.addcmul``: rows "... tp-local ..."), checked here only
              without it.  (f) checkpoint resharding: gpt-125m's state at
              full width and depth, quantized (8-bit wire codes), saved at
              (1, 1) and loaded block by block at (P, M) = (2, 2), (1, 2)
              and (2, 1) with ``dequantize=True`` on the card (K2) and on
              the CPU (its plain version): every block byte-equal, each
              layout's blocks laid end to end the whole decoded state.
              Prints that NCCL at more than one rank has not run on a
              card.

Prints the kernel table as one JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import functools
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
# 32-bit integer operations: 64 INT32 lanes per SM (Hopper architecture white
# paper) x 132 SMs x 1.98 GHz, the clock at which the data sheet's f32 rate
# (128 lanes x 2 flop) is 67 TFLOP/s
INT32_OP_PER_S = 16.7e12

K3_TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py:61-96
# dense vs rowquant first decode step, max |diff| / max |logit|: the dense
# path rounds each dequantized weight to bf16 before the matmul, rowquant
# keeps it exact in f32.  Measured 1.9e-2 at 24 layers (smoke widths, CPU);
# a wrong code layout or affine gives O(1).
LOGIT_RTOL = 1e-1


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps=10, flush=None):
    """Mean device time of fn() over `reps` launches, each after an
    (untimed) L2 flush, by CUDA events; one warm-up launch first.  A short
    spin on the card after the flush keeps it busy while the host enqueues
    fn, so the host's own time between the two events is not counted."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(200_000)  # ~0.1 ms at the H100's 1.98 GHz
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def _not_ours(name):
    """Kernels kernel_ms leaves out by default: the L2 flush's fill and
    PyTorch's elementwise kernels (none of the port's kernels is one)."""
    return "fill" in name.lower() or "elementwise" in name


def kernel_ms(torch, fn, reps=10, flush=None, keep=lambda name: not _not_ours(name)):
    """Mean device time of the kernels fn() launches whose names `keep`
    accepts, read from torch.profiler (cold L2 as in cuda_ms): unlike CUDA
    events around one launch it leaves out the launch latency and any host
    gap."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a session can come back without some of its kernel events, which
    # would understate the mean: take one that recorded a whole number of
    # kernels per call, and ask again otherwise
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        times = [e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and keep(e.name)]
        if times and len(times) % reps == 0:
            return sum(times) / reps / 1e3
    raise PhaseError("torch.profiler did not record every kernel of the timed calls")


def bound(work):
    """(least ms, what bounds it) of a kernel's `work`
    (``kernels.cost.KernelCost``, the formulas the meta path reports): the
    larger of its bytes over the memory rate and its operations over their
    peak rates (f32 and INT32 run on separate lanes, so the larger of those
    two counts)."""
    t_b = work.nbytes / HBM_BYTES_PER_S * 1e3
    t_o = max(work.flops / F32_FLOP_PER_S, work.int_ops / INT32_OP_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

GPT13_NB = {"attn (wq/wk/wv/wo)": 4096, "mlp (w_gate/w_up/w_down)": 16384,
            "embed": 100608}
K3_SHAPES = {"w_gate/w_up": (4, 2048, 8192, 8), "w_down": (4, 8192, 2048, 2),
             # zamba2-7b's shared MLP under rowquant, one lane block per
             # invocation (its w_down's 3,584 columns are not whole buckets of
             # 1,024, so K2 decodes it)
             "zamba2 shared w_gate/w_up": (4, 3584, 14336, 14),
             # the vlmaudio phase's rowquant decode: qwen2-vl-72b's w_down
             # (its w_gate/w_up's 29,568 columns are 28.875 buckets of 1,024,
             # so K2 decodes them) and seamless-m4t-large-v2's decoder MLP
             "qwen2-vl w_down": (4, 29568, 8192, 8),
             "seamless dec w_gate/w_up": (4, 1024, 8192, 8),
             "seamless dec w_down": (4, 8192, 1024, 1)}
# K3 at the continuous phase's chunk M = slots x top bucket, timed for the
# record: the chunk path gathers its MLP densely (as the reference does:
# rowquant is a decode path), so these shapes are off the main path
K3_CHUNK_SHAPES = {"w_gate/w_up, chunk M": (256, 2048, 8192, 8),
                   "w_down, chunk M": (256, 8192, 2048, 2)}
# the speculative draft (make_draft_params at gpt-1.3b: 4 bits, nearest,
# bucket gcd(n_local, 256) = 256): K3 runs the draft MLP at M = slots from
# the codes unpacked to one byte each, n_seg = N / 256; K2 decodes one
# draft layer's wq/wk/wv/wo (four wire segments, each in its own buffer) in
# one launch
DRAFT_BITS, DRAFT_BUCKET = 4, 256
K3_DRAFT_SHAPES = {"w_gate/w_up, draft W4": (4, 2048, 8192, 8192 // DRAFT_BUCKET),
                   "w_down, draft W4": (4, 8192, 2048, 2048 // DRAFT_BUCKET)}
# the cold tier's codec at gpt-1.3b: one KV block (24 layers x 16 tokens x
# 32 heads x 64) of k or v, 4 bits, buckets of 128, f32 scale/zero
COLD_NB, COLD_BUCKET, COLD_BITS = 24 * 16 * 32 * 64 // 128, 128, 4
# the sampler's draw: one row of vocabulary size per sampled slot (4 slots)
RANDOM_BITS_SHAPE = (4, 50304)
# the gpt-125m embedding's values (50,304 x 768) and the (bits, bucket, mode)
# of the experiments' policies K1/K2 are also held at there
EMBED_125M = 50304 * 768
EXP_KERNEL_ROWS = ((8, 65536, "nearest"), (4, 256, "shift"), (6, 1024, "shift"))
# one olmoe-1b-7b expert stack (w_gate, w_up or w_down of a layer): 64 x
# 2048 x 1024 values
OLMOE_EXPERT = 64 * 2048 * 1024
# the SSM/hybrid families' largest and smallest quantized Mamba2 weights:
# zamba2-7b's w_z (3,584 x 7,168) and mamba2-370m's w_dt (1,024 x 32 heads)
SSM_K1_ROWS = (("zamba2-7b w_z (3584 x 7168)", 3584 * 7168),
               ("mamba2-370m w_dt (1024 x 32)", 1024 * 32))
# the VLM and audio families' largest quantized tensors: a qwen2-vl-72b MLP
# weight (8,192 x 29,568) and seamless-m4t-large-v2's untied lm_head
# (256,206 x 1,024)
MM_K1_ROWS = (("qwen2-vl-72b w_gate (8192 x 29568)", 8192 * 29568),
              ("seamless lm_head (256206 x 1024)", 256206 * 1024))
# their training's largest gradients, G8 stochastic: qwen2-vl-72b's tied
# embedding (152,064 x 8,192: the largest K1 launch on any path; its plain
# version draws its int64 threefry in chunks of 65,536 buckets, which fit the
# card) and seamless-m4t-large-v2's lm_head; (what, values, plain's chunk)
MM_GRAD_K1_ROWS = (("qwen2-vl-72b embed grad (152064 x 8192)", 152064 * 8192, 1 << 16),
                   ("seamless lm_head grad (256206 x 1024)", 256206 * 1024, None))


def dt_name(dt) -> str:
    return {"torch.float32": "f32", "torch.bfloat16": "bf16"}[str(dt)]


def log_decode_row(name, r, log):
    b_ms, b_by = r["bound"]
    lib = ("no torch.addcmul (packed codes)" if r["library_ms"] is None else
           f"torch.addcmul {r['library_ms']:.4f}, kernel {r['library_kernel_ms']:.4f}: "
           f"{r['library_ms'] / r['ms']:.2f}x by events, "
           f"{r['library_kernel_ms'] / r['kernel_ms']:.2f}x kernel alone")
    log(f"{name} {r['shape']:34s} nb={r['nb']:6d}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
        f"bound {b_ms:.4f} by {b_by}); kernel time alone (profiler) {r['kernel_ms']:.4f} ms, "
        f"{100 * b_ms / r['kernel_ms']:.0f}% of bound; {lib}")


def encode_layout(torch, gen, layout, seed, dev):
    """A wire buffer of `layout` (K1 under the engine's per-segment keys) over
    random values."""
    from repro_torch.core import collectives as coll
    from repro_torch.core import prng
    xs = [torch.randn(seg.n, generator=gen, device=dev) * 0.02 for seg in layout.segments]
    keys = [prng.fold_in(prng.PRNGKey(seed), i) if seg.cfg is not None else None
            for i, seg in enumerate(layout.segments)]
    return coll.encode_wire(xs, layout, keys)


def layer_decode_rows(torch, log, gen, decode_row, addcmul_ms, dev="cuda", arch="gpt-1.3b",
                      dtypes=("bfloat16", "float32"), grad=False):
    """K2 over a whole wire buffer, as the gathers decode it.  Timed: one
    layer of `arch` as its real buffer (gpt-1.3b: 7 quantized matmul weights
    and 2 fp norms; olmoe-1b-7b: 4 attention weights and 3 expert stacks, the
    router and 2 norms as fp segments; encoded by K1 under the engine's
    layout) decoded in one launch into each of `dtypes`, byte-equal to the
    plain version; the library call is ``torch.addcmul`` over the layer's
    codes gathered into one tensor.  `grad`: the layer's gradient
    reduce-scatter buffer instead (G8 stochastic, bf16 fp segments), as the
    backward decodes it."""
    from repro_torch import configs
    from repro_torch.core import collectives as coll
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.kernels import cost, ops, ref
    from repro_torch.models.transformer import Model

    eng = Model(configs.get_config(arch), MeshSpec(("data", "model"), (1, 1)),
                QSDPConfig()).engine
    names = tuple(sorted(n for n in eng.specs if n.startswith("layers/")))
    layout = eng.rs_layout(names) if grad else eng.layout(names)
    buf = encode_layout(torch, gen, layout, 20, dev)
    out = []
    for dt in (getattr(torch, d) for d in dtypes):
        table, dts = coll.wire_table(layout, 1, [dt] * len(layout.segments))
        nb = sum(t.nb for t in table)
        out.append(decode_row(
            f"{arch} layer{' grad' if grad else ''} ({len(table)} tensors), {dt_name(dt)} out",
            nb,
            lambda: ops.unpack_dequantize_wire(buf, table, dts),
            lambda: ref.unpack_dequantize_wire_ref(buf, table, dts),
            wire_addcmul(torch, addcmul_ms, buf, table, dts),
            cost.unpack_dequantize_wire(table, [d.itemsize for d in dts])))
    return out


def wire_addcmul(torch, addcmul_ms, buf, table, dts):
    """``torch.addcmul``'s time over the codes of a K2 table (W8, f32
    scale/zero): the codes gathered into one (nb, bucket) tensor and the
    scale/zero into (nb, 1), against the plain decode."""
    from repro_torch.kernels import ref
    check(all(t.meta_dtype == torch.float32 and t.bits == 8 for t in table),
          "layer codes are not W8 with f32 scale/zero")
    want = torch.cat(ref.unpack_dequantize_wire_ref(buf, table, dts))
    meta = [buf[t.scale:t.zero + 4 * t.nb].clone().view(torch.float32).view(2, t.nb, 1)
            for t in table]
    return addcmul_ms(torch.cat([buf[t.codes:t.scale].view(t.nb, t.bucket) for t in table]),
                      torch.cat([m[0] for m in meta]), torch.cat([m[1] for m in meta]), want)


def unaligned_decode_check(torch, log, gen, dev="cuda"):
    """K2 over segments off 16-byte alignment, in two rows, byte-equal to the
    plain version in bf16 and f32 (checked, not timed)."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import ops, ref
    # odd nb moves the next segment 8 bytes off 16 at 8 bits; bf16 scale/zero
    # and an odd bf16 fp payload leave even 4-byte alignment behind
    odd = coll.WireLayout((
        coll.WireSegment(5 * 1024 - 3, QuantConfig(bits=8, meta_dtype="bfloat16")),
        coll.WireSegment(77, None, "bfloat16"),
        coll.WireSegment(3 * 1024, QuantConfig(bits=4, meta_dtype="bfloat16")),
        coll.WireSegment(7 * 1024 + 1, QuantConfig(bits=2)),
        coll.WireSegment(2000, QuantConfig(bits=3, bucket_size=100)),
        coll.WireSegment(33 * 1024, QuantConfig(bits=8))))
    rows = torch.cat([encode_layout(torch, gen, odd, 21, dev),
                      encode_layout(torch, gen, odd, 22, dev)])
    for dt in (torch.bfloat16, torch.float32):
        table, dts = coll.wire_table(odd, 2, [dt] * len(odd.segments))
        check(any((rows.data_ptr() + t.codes) % 16 for t in table),
              "unaligned case: every segment is 16-byte aligned")
        for g, w in zip(ops.unpack_dequantize_wire(rows, table, dts),
                        ref.unpack_dequantize_wire_ref(rows, table, dts), strict=True):
            check(torch.equal(g.view(torch.uint8), w.view(torch.uint8)),
                  f"K2 unaligned segments, {dt_name(dt)} out: values differ")
    log(f"K2 over wire buffers: segments off 16-byte alignment (bits 2/3/4/8, bf16 and f32 "
        f"scale/zero, 2 rows, {len(table)} table entries) byte-equal, bf16 and f32 out")


def kernel_phase(torch, log, dev="cuda"):
    from repro_torch.core import prng
    from repro_torch.kernels import cost, ops, ref

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def key_uniform(nb, cols, lo, hi, seed):
        return prng.uniform(prng.PRNGKey(seed), (nb, cols), dev, lo, hi)

    def addcmul_ms(codes, scale, zero, want):
        """The library's one call for codes * scale + zero at one code per
        byte (``addcmul`` promotes the u8 codes, computes in f32 and writes
        `want`'s dtype), after a check that it computes the kernel's
        function (within one rounding of that dtype): its time by events
        and its kernels' time alone (profiler), as the kernel's are taken."""
        out = torch.empty_like(want)
        torch.addcmul(zero, codes, scale, out=out)
        err = (out.float() - want.float()).abs().max().item()
        rel = 1e-6 if want.dtype == torch.float32 else 2.0 ** -7
        check(err <= rel * want.float().abs().max().item(), f"torch.addcmul differs by {err:.3e}")

        def call():
            return torch.addcmul(zero, codes, scale, out=out)
        return dict(library_ms=cuda_ms(torch, call, flush=flush),
                    library_kernel_ms=kernel_ms(torch, call, flush=flush,
                                                keep=lambda name: "fill" not in name.lower()))

    def decode_row(what, nb, call, plain, library, work):
        """A K2/K5 row: `call` (the kernel, a tensor or a list of them)
        byte-equal to `plain`, then timed by events and by the profiler
        beside the plain version and the library call (`library`: its
        times, or None where no library call computes the function)."""
        got, want = call(), plain()
        got, want = (got, want) if isinstance(got, list) else ([got], [want])
        for g, w in zip(got, want, strict=True):
            check(g.dtype == w.dtype and torch.equal(g.view(torch.uint8), w.view(torch.uint8)),
                  f"{what}: differs from the plain version in "
                  f"{(g.float() != w.float()).sum().item()} values")
        return dict(shape=what, nb=nb, ms=cuda_ms(torch, call, flush=flush),
                    kernel_ms=kernel_ms(torch, call, flush=flush),
                    plain_ms=cuda_ms(torch, plain, reps=3, flush=flush),
                    **(library or dict(library_ms=None, library_kernel_ms=None)),
                    bound=bound(work),
                    max_abs_err=max((g.float() - w.float()).abs().max().item()
                                    for g, w in zip(got, want)))

    def k1_row(what, x, key, mode, rand_bits=32, bits=8, chunk=None):
        """K1 in its key form against its plain version (threefry twin +
        quantize_pack_ref) at one shape and width: byte-equal, then timed.
        With `chunk` (stochastic mode), the plain version runs `chunk`
        buckets at a time at their own counters (``ref.k1_counters``: bucket
        b's value j at b * bucket + j), the same draws and arithmetic."""
        nb = x.shape[0]
        levels = (1 << bits) - 1

        def call():
            return ops.quantize_pack(x, key, levels, bits, mode, rand_bits)

        def plain():
            if chunk is None:
                return ref.quantize_pack_key_ref(x, key, levels, bits, mode, rand_bits)
            check(mode == "stochastic" and rand_bits == 32, "chunked plain K1: stochastic only")
            parts = []
            for b0 in range(0, nb, chunk):
                xb = x[b0:b0 + chunk]
                ctr = ref.k1_counters(xb.shape[0], xb.shape[1], mode, dev) + b0 * xb.shape[1]
                parts.append(ref.quantize_pack_ref(xb, prng.to_uniform(prng.bits_at(key, ctr)),
                                                   levels, bits, mode, 1.0))
            return tuple(torch.cat(p) for p in zip(*parts))

        q, qr = call(), plain()
        for g, w, part in zip(q, qr, ("codes", "scale", "zero")):
            check(torch.equal(g, w), f"K1 {what} {mode}: {part} differ in "
                  f"{(g != w).sum().item()} places")
        return q, dict(
            shape=what, nb=nb, mode=mode,
            ms=cuda_ms(torch, call, flush=flush), kernel_ms=kernel_ms(torch, call, flush=flush),
            plain_ms=cuda_ms(torch, plain, reps=3, flush=flush),
            bound=bound(cost.quantize_pack(nb, x.shape[1], bits, mode)),
            max_abs_err=max((a.float() - b.float()).abs().max().item() for a, b in zip(q, qr)))

    # K1 (key form) + K2 correctness: bits x modes x rand_bits at the MLP
    # shape, byte-equal
    nb = GPT13_NB["mlp (w_gate/w_up/w_down)"]
    x = torch.randn((nb, 1024), generator=gen, device=dev) * 0.02
    for bits in (2, 4, 8):
        for mode in ("nearest", "stochastic", "shift"):
            for rand_bits in (16, 32):
                key = prng.fold_in(prng.PRNGKey(bits), rand_bits)
                levels = (1 << bits) - 1
                got = ops.quantize_pack(x, key, levels, bits, mode, rand_bits)
                want = ref.quantize_pack_key_ref(x, key, levels, bits, mode, rand_bits)
                for g, w, what in zip(got, want, ("codes", "scale", "zero")):
                    check(torch.equal(g, w), f"K1 bits={bits} mode={mode} rand_bits="
                          f"{rand_bits}: {what} differ in {(g != w).sum().item()} places")
                for dt in (torch.float32, torch.bfloat16):
                    d = ops.unpack_dequantize(*got, bits, dt)
                    dw = ref.unpack_dequantize_ref(*got, bits, dt)
                    check(torch.equal(d.view(torch.uint8), dw.view(torch.uint8)),
                          f"K2 bits={bits} mode={mode} {dt}: values differ")
    log("K1 quantize_pack (key form, in-kernel threefry): byte-equal to plain, bits {2,4,8} x "
        f"{{nearest,stochastic,shift}} x rand_bits {{16,32}}, nb={nb} x 1024")
    log("K2 unpack_dequantize: byte-equal to plain, same cases, f32 and bf16 out")

    # K1/K2 at every main-path gather shape (W8, shift), byte-equal and
    # timed; K2 in bf16 (the gather's decode, written in the compute dtype)
    # and f32 (the reduce-scatter's dequant-sum)
    k1, k2 = [], []
    for what, nb in GPT13_NB.items():
        x = torch.randn((nb, 1024), generator=gen, device=dev) * 0.02
        q, row = k1_row(what, x, prng.PRNGKey(nb), "shift")
        k1.append(row)
        for dt in (torch.bfloat16, torch.float32):
            k2.append(decode_row(
                f"{what}, {dt_name(dt)} out", nb, lambda: ops.unpack_dequantize(*q, 8, dt),
                lambda: ref.unpack_dequantize_ref(*q, 8, dt),
                addcmul_ms(*q, ref.unpack_dequantize_ref(*q, 8, dt)),
                cost.unpack_dequantize(nb, 1024, 8, dt.itemsize)))
        del x, q
    # buckets past 1 KB of codes (``launch/train.py --bucket 4096``): the
    # 16-byte path walks them in 1 KB chunks; timed at the MLP's value count
    # at 8 bits (beside torch.addcmul) and 4 bits (packed: no library call)
    n = GPT13_NB["mlp (w_gate/w_up/w_down)"] * 1024
    x = torch.randn((n // 4096, 4096), generator=gen, device=dev) * 0.02
    for bits in (8, 4):
        q = ops.quantize_pack(x, prng.PRNGKey(bits), (1 << bits) - 1, bits, "shift")
        for dt in (torch.bfloat16, torch.float32):
            k2.append(decode_row(
                f"bucket 4096 W{bits} (MLP size), {dt_name(dt)} out", n // 4096,
                lambda: ops.unpack_dequantize(*q, bits, dt),
                lambda: ref.unpack_dequantize_ref(*q, bits, dt),
                addcmul_ms(*q, ref.unpack_dequantize_ref(*q, bits, dt)) if bits == 8 else None,
                cost.unpack_dequantize(n // 4096, 4096, bits, dt.itemsize)))
        del q
    del x
    # the gradient path's mode at the embedding shape: K1 stochastic, one
    # threefry draw per value (Def. 12)
    x = torch.randn((GPT13_NB["embed"], 1024), generator=gen, device=dev) * 1e-3
    k1.append(k1_row("embed grad", x, prng.fold_in(prng.PRNGKey(12), 0x5D), "stochastic")[1])
    del x
    k2 += layer_decode_rows(torch, log, gen, decode_row, addcmul_ms, dev)
    # the dist phase's P-rank wire work, K2 over a gathered layer of P rows
    # timed (off the one-rank main path), and the tp-local layer's
    k2 += dist_wire(torch, log, dev, decode_row=decode_row, addcmul_ms=addcmul_ms)
    tp_k1, tp_k2 = tp_wire(torch, log, dev, timing=(k1_row, decode_row, addcmul_ms))
    k1 += tp_k1
    k2 += tp_k2
    unaligned_decode_check(torch, log, gen, dev)
    # olmoe-1b-7b (moe phase): K1 W8 shift on one expert stack, as every
    # decode step gathers it; K2 over a whole layer's buffer into bf16
    x = torch.randn((OLMOE_EXPERT // 1024, 1024), generator=gen, device=dev) * 0.02
    k1.append(k1_row("olmoe expert (64 x 2048 x 1024)", x, prng.PRNGKey(64), "shift")[1])
    del x
    k2 += layer_decode_rows(torch, log, gen, decode_row, addcmul_ms, dev, arch="olmoe-1b-7b",
                            dtypes=("bfloat16",))
    # olmoe training (moetrain phase): K1 G8 stochastic on one expert stack's
    # gradient, one threefry draw per value; K2 over a layer's gradient
    # buffer into f32, the reduce-scatter's local decode
    x = torch.randn((OLMOE_EXPERT // 1024, 1024), generator=gen, device=dev) * 1e-3
    k1.append(k1_row("olmoe expert grad", x, prng.fold_in(prng.PRNGKey(65), 0x5D),
                     "stochastic")[1])
    del x
    k2 += layer_decode_rows(torch, log, gen, decode_row, addcmul_ms, dev, arch="olmoe-1b-7b",
                            dtypes=("float32",), grad=True)
    # the SSM/hybrid families (ssm phase): K1 W8 shift on zamba2-7b's w_z and
    # mamba2-370m's w_dt, as every decode step gathers them; K2 over a whole
    # Mamba2 layer's buffer of each (5 quantized weights, 6 fp segments)
    # into bf16
    for what, n in SSM_K1_ROWS:
        x = torch.randn((n // 1024, 1024), generator=gen, device=dev) * 0.02
        k1.append(k1_row(what, x, prng.PRNGKey(n % 9973), "shift")[1])
        del x
    for arch in ("zamba2-7b", "mamba2-370m"):
        k2 += layer_decode_rows(torch, log, gen, decode_row, addcmul_ms, dev, arch=arch,
                                dtypes=("bfloat16",))
    # SSM/hybrid training (ssmtrain phase): K1 G8 stochastic on zamba2-7b's
    # w_z gradient, one threefry draw per value; K2 over a zamba2 Mamba2
    # layer's gradient buffer into f32, the reduce-scatter's local decode
    n = SSM_K1_ROWS[0][1]
    x = torch.randn((n // 1024, 1024), generator=gen, device=dev) * 1e-3
    k1.append(k1_row("zamba2-7b w_z grad", x, prng.fold_in(prng.PRNGKey(66), 0x5D),
                     "stochastic")[1])
    del x
    k2 += layer_decode_rows(torch, log, gen, decode_row, addcmul_ms, dev, arch="zamba2-7b",
                            dtypes=("float32",), grad=True)
    # the VLM and audio families (vlmaudio phase): K1 W8 shift on a
    # qwen2-vl-72b MLP weight and on seamless-m4t-large-v2's lm_head, as
    # every decode step gathers them; K2 over a whole qwen2-vl-72b layer's
    # buffer (7 quantized weights, 3 biases and 2 norms as fp segments) into
    # bf16
    for what, n in MM_K1_ROWS:
        x = torch.randn((n // 1024, 1024), generator=gen, device=dev) * 0.02
        k1.append(k1_row(what, x, prng.PRNGKey(n % 9973), "shift")[1])
        del x
    k2 += layer_decode_rows(torch, log, gen, decode_row, addcmul_ms, dev, arch="qwen2-vl-72b",
                            dtypes=("bfloat16",))
    # the VLM and audio families trained (mmtrain phase): K1 G8 stochastic
    # on their largest gradients; K2 over a qwen2-vl-72b layer's gradient
    # buffer into f32, the reduce-scatter's local decode
    for what, n, chunk in MM_GRAD_K1_ROWS:
        x = torch.randn((n // 1024, 1024), generator=gen, device=dev) * 1e-3
        k1.append(k1_row(what, x, prng.fold_in(prng.PRNGKey(n % 9973), 0x5D), "stochastic",
                         chunk=chunk)[1])
        del x
    k2 += layer_decode_rows(torch, log, gen, decode_row, addcmul_ms, dev, arch="qwen2-vl-72b",
                            dtypes=("float32",), grad=True)
    # the experiments phase's policies at the gpt-125m embedding (50,304 x
    # 768): Table 1's rtn-nobucket (W8 nearest, bucket 65536: K1's generic
    # body, one warp per bucket), Table 3's W4 at bucket 256 (shift) and the
    # full grid's W6 (one byte per code); K2 decodes each into bf16, beside
    # torch.addcmul on the codes one per byte
    for bits, bucket, mode in EXP_KERNEL_ROWS:
        nb = -(-EMBED_125M // bucket)
        x = torch.zeros(nb * bucket, device=dev)
        x[:EMBED_125M] = torch.randn(EMBED_125M, generator=gen, device=dev) * 0.02
        x = x.view(nb, bucket)
        key = None if mode == "nearest" else prng.PRNGKey(bucket + bits)
        what = f"gpt-125m embed W{bits} b{bucket}"
        q, row = k1_row(what, x, key, mode, bits=bits)
        k1.append(row)
        want = ref.unpack_dequantize_ref(*q, bits, torch.bfloat16)
        k2.append(decode_row(
            f"{what}, bf16 out", nb, lambda: ops.unpack_dequantize(*q, bits, torch.bfloat16),
            lambda: ref.unpack_dequantize_ref(*q, bits, torch.bfloat16),
            addcmul_ms(ref.unpack_codes(q[0], bits), q[1], q[2], want),
            cost.unpack_dequantize(nb, bucket, bits, 2)))
        del x, q, want
    for r in k1:
        b_ms, b_by = r["bound"]
        log(f"K1 {r['shape']:26s} {r['mode']:10s} nb={r['nb']:6d}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, bound {b_ms:.4f} by {b_by}, {100 * b_ms / r['ms']:.0f}% "
            f"of bound); kernel time alone (profiler) {r['kernel_ms']:.4f} ms, "
            f"{100 * b_ms / r['kernel_ms']:.0f}% of bound")
    for r in k2:
        log_decode_row("K2", r, log)
    rows["quantize_pack"] = k1
    rows["unpack_dequantize"] = k2

    # the cold tier's codec at its gpt-1.3b block shape (continuous phase):
    # K1 nearest at 4 bits, bucket 128; K2 decoding it into bf16
    x = torch.randn((COLD_NB, COLD_BUCKET), generator=gen, device=dev)
    levels = (1 << COLD_BITS) - 1
    q = ops.quantize_pack(x, None, levels, COLD_BITS, "nearest")
    qr = ref.quantize_pack_key_ref(x, None, levels, COLD_BITS, "nearest")
    for g, w, part in zip(q, qr, ("codes", "scale", "zero")):
        check(torch.equal(g, w), f"K1 cold block: {part} differ in {(g != w).sum().item()} places")
    k1.append(dict(
        shape="cold KV block, W4 bucket 128", nb=COLD_NB, mode="nearest",
        ms=cuda_ms(torch, lambda: ops.quantize_pack(x, None, levels, COLD_BITS, "nearest"),
                   flush=flush),
        kernel_ms=kernel_ms(torch, lambda: ops.quantize_pack(x, None, levels, COLD_BITS,
                                                             "nearest"), flush=flush),
        plain_ms=cuda_ms(torch, lambda: ref.quantize_pack_key_ref(x, None, levels, COLD_BITS,
                                                                  "nearest"),
                         reps=3, flush=flush),
        bound=bound(cost.quantize_pack(COLD_NB, COLD_BUCKET, COLD_BITS, "nearest")),
        max_abs_err=max((a.float() - b.float()).abs().max().item() for a, b in zip(q, qr))))
    r = k1[-1]
    log(f"K1 {r['shape']} nb={COLD_NB}: byte-equal to plain; {r['ms']:.4f} ms, kernel "
        f"{r['kernel_ms']:.4f} (plain {r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} by "
        f"{r['bound'][1]})")
    k2.append(decode_row(
        "cold KV block, W4 bucket 128, bf16 out", COLD_NB,
        lambda: ops.unpack_dequantize(*q, COLD_BITS, torch.bfloat16),
        lambda: ref.unpack_dequantize_ref(*q, COLD_BITS, torch.bfloat16), None,
        cost.unpack_dequantize(COLD_NB, COLD_BUCKET, COLD_BITS, 2)))
    log_decode_row("K2", k2[-1], log)
    del x, q, qr

    # the speculative draft's layer: wq/wk/wv/wo at 4 bits, bucket 256, each
    # tensor its own wire buffer, decoded into bf16 in one launch
    from repro_torch.core import quant
    dcfg = quant.QuantConfig(bits=DRAFT_BITS, bucket_size=DRAFT_BUCKET, mode="nearest")
    n1 = 2048 * 2048
    qs = [quant.quantize(torch.randn(n1, generator=gen, device=dev) * 0.02, dcfg)
          for _ in range(4)]
    bufs = [quant.wire_pack(q) for q in qs]
    table = [quant.wire_codes(0, n1, dcfg)] * 4
    dts = [torch.bfloat16] * 4
    want = ref.unpack_dequantize_wire_ref(bufs, table, dts)
    nb = 4 * n1 // DRAFT_BUCKET
    k2.append(decode_row(
        "draft layer wq/wk/wv/wo, W4 bucket 256, bf16 out", nb,
        lambda: ops.unpack_dequantize_wire(bufs, table, dts),
        lambda: ref.unpack_dequantize_wire_ref(bufs, table, dts),
        # the library reads the codes unpacked to one byte each
        addcmul_ms(torch.cat([ref.unpack_codes(q.codes, DRAFT_BITS) for q in qs]),
                   torch.cat([q.scale for q in qs])[:, None],
                   torch.cat([q.zero for q in qs])[:, None], torch.cat(want)),
        cost.unpack_dequantize_wire(table, [2] * 4)))
    log_decode_row("K2", k2[-1], log)
    del qs, bufs, want
    # the olmoe draft's expert stack: one 4-bit wire buffer of 134 M values,
    # decoded into bf16 by K2 (3-D, so never K3)
    q = quant.quantize(torch.randn(OLMOE_EXPERT, generator=gen, device=dev) * 0.02, dcfg)
    bufs, table = [quant.wire_pack(q)], [quant.wire_codes(0, OLMOE_EXPERT, dcfg)]
    want = ref.unpack_dequantize_wire_ref(bufs, table, dts[:1])
    nb = OLMOE_EXPERT // DRAFT_BUCKET
    k2.append(decode_row(
        "olmoe draft expert, W4 bucket 256, bf16 out", nb,
        lambda: ops.unpack_dequantize_wire(bufs, table, dts[:1]),
        lambda: ref.unpack_dequantize_wire_ref(bufs, table, dts[:1]),
        addcmul_ms(ref.unpack_codes(q.codes, DRAFT_BITS), q.scale[:, None], q.zero[:, None],
                   want[0]),
        cost.unpack_dequantize_wire(table, [2])))
    log_decode_row("K2", k2[-1], log)
    del q, bufs, want

    # the sampler's draw: jax.random bits of a vocabulary per sampled row
    from repro_torch.core import prng as _prng
    rows_n, vocab = RANDOM_BITS_SHAPE
    keys = _prng.as_i32(_prng.fold_in_rows(
        torch.tensor([_prng.PRNGKey(i) for i in range(rows_n)]), torch.arange(rows_n) + 129))
    keys_d = keys.to(dev)
    got, want = ops.random_bits(keys_d, vocab), ref.random_bits_ref(keys, vocab)
    check(torch.equal(got.cpu(), want), f"random_bits: {(got.cpu() != want).sum().item()} "
          "values differ from the plain version")
    rows["random_bits"] = [dict(
        shape=f"{rows_n} rows x {vocab}", nb=rows_n,
        ms=cuda_ms(torch, lambda: ops.random_bits(keys_d, vocab), flush=flush),
        kernel_ms=kernel_ms(torch, lambda: ops.random_bits(keys_d, vocab), flush=flush),
        plain_ms=cuda_ms(torch, lambda: ref.random_bits_ref(keys_d, vocab), reps=3,
                         flush=flush),
        bound=bound(cost.random_bits(rows_n, vocab)),
        max_abs_err=0.0)]
    r = rows["random_bits"][0]
    log(f"random_bits {r['shape']}: byte-equal to plain (jax.random.bits); {r['ms']:.4f} ms, "
        f"kernel {r['kernel_ms']:.4f} (plain {r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} "
        f"by {r['bound'][1]}); no library call computes threefry bits")

    # K4/K5: the unpacked forms, byte-equal for levels x modes, f32 and bf16
    nb = GPT13_NB["mlp (w_gate/w_up/w_down)"]
    x = torch.randn((nb, 1024), generator=gen, device=dev) * 0.02
    rand = key_uniform(nb, 1024, 0.0, 1.0, 13)
    for levels in (3, 15, 63, 255):
        for stochastic in (False, True):
            got = ops.quantize_buckets(x, rand, levels, stochastic)
            want = ref.quantize_buckets_ref(x, rand, levels, stochastic)
            for g, w, what in zip(got, want, ("codes", "scale", "zero")):
                check(torch.equal(g, w), f"K4 levels={levels} stochastic={stochastic}: "
                      f"{what} differ in {(g != w).sum().item()} places")
            for dt in (torch.float32, torch.bfloat16):
                dd = ops.dequantize_buckets(*got, dt)
                dw = ref.dequantize_buckets_ref(*got, dt)
                check(torch.equal(dd.view(torch.uint8), dw.view(torch.uint8)),
                      f"K5 levels={levels} {dt}: values differ")
    log("K4 quantize_buckets: byte-equal to plain, levels {3,15,63,255} x {nearest,stochastic}, "
        f"nb={nb} x 1024; K5 dequantize_buckets byte-equal (tolerance 0), f32 and bf16 out")
    nb = GPT13_NB["embed"]
    x = torch.randn((nb, 1024), generator=gen, device=dev) * 1e-3
    rand = key_uniform(nb, 1024, 0.0, 1.0, 14)
    q = ops.quantize_buckets(x, rand, 255, True)
    qr = ref.quantize_buckets_ref(x, rand, 255, True)
    check(all(torch.equal(a, b) for a, b in zip(q, qr)), "K4 embed: differs")
    rows["quantize_buckets"] = [dict(
        shape="embed, stochastic", nb=nb,
        ms=cuda_ms(torch, lambda: ops.quantize_buckets(x, rand, 255, True), flush=flush),
        kernel_ms=kernel_ms(torch, lambda: ops.quantize_buckets(x, rand, 255, True),
                            flush=flush),
        plain_ms=cuda_ms(torch, lambda: ref.quantize_buckets_ref(x, rand, 255, True), reps=3,
                         flush=flush),
        bound=bound(cost.quantize_buckets(nb, 1024, True)),
        max_abs_err=max((a.float() - b.float()).abs().max().item() for a, b in zip(q, qr)))]
    rows["dequantize_buckets"] = [
        decode_row(f"embed, {dt_name(dt)} out", nb, lambda: ops.dequantize_buckets(*q, dt),
                   lambda: ref.dequantize_buckets_ref(*q, dt),
                   addcmul_ms(*q, ref.dequantize_buckets_ref(*q, dt)),
                   cost.dequantize_buckets(nb, 1024, dt.itemsize))
        for dt in (torch.float32, torch.bfloat16)]
    r = rows["quantize_buckets"][0]
    log(f"quantize_buckets {r['shape']} nb={nb}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
        f"bound {r['bound'][0]:.4f} by {r['bound'][1]}); kernel time alone (profiler) "
        f"{r['kernel_ms']:.4f} ms, {100 * r['bound'][0] / r['kernel_ms']:.0f}% of bound")
    for r in rows["dequantize_buckets"]:
        log_decode_row("K5 dequantize_buckets", r, log)
    del x, rand, q, qr

    # K3: tolerance against plain, both x dtypes; times in bf16 (main path)
    # beside torch.matmul on the dense bf16 weight
    k3 = []
    for what, (m, k, n, n_seg) in {**K3_SHAPES, **K3_CHUNK_SHAPES, **K3_DRAFT_SHAPES}.items():
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        bits = DRAFT_BITS if what in K3_DRAFT_SHAPES else 8
        bucket = n // n_seg
        nb = k * n // bucket
        codes, s, z = (ops.quantize_pack(w.reshape(nb, bucket), None, 15, bits, "nearest")
                       if bits < 8 else
                       ops.quantize_pack(w.reshape(nb, bucket), prng.PRNGKey(k), 255, 8, "shift"))
        codes = ref.unpack_codes(codes, bits)
        codes, s, z = codes.reshape(k, n), s.reshape(k, n_seg), z.reshape(k, n_seg)
        for dt in (torch.float32, torch.bfloat16):
            xx = torch.randn((m, k), generator=gen, device=dev).to(dt)
            y = ops.rowquant_matmul(xx, codes, s, z).float()
            yr = ref.rowquant_matmul_ref(xx, codes, s, z).float()
            err = (y - yr).abs().max().item()
            tol = K3_TOL[str(dt).split(".")[1]] * max(yr.abs().max().item(), 1.0)
            check(math.isfinite(err) and err <= tol,
                  f"K3 {what} {dt}: max |err| {err:.3e} > {tol:.3e}")
            log(f"K3 {what} x {dt}: max |err| {err:.3e} (tol {tol:.3e})")
        xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        wd = ref.unpack_dequantize_ref(codes.reshape(nb, bucket), s.reshape(nb, 1),
                                       z.reshape(nb, 1), 8).reshape(k, n).to(torch.bfloat16)
        err = (ops.rowquant_matmul(xb, codes, s, z).float()
               - ref.rowquant_matmul_ref(xb, codes, s, z).float()).abs().max().item()
        k3.append(dict(
            shape=what, m=m, k=k, n=n, n_seg=n_seg,
            ms=cuda_ms(torch, lambda: ops.rowquant_matmul(xb, codes, s, z), flush=flush),
            plain_ms=cuda_ms(torch, lambda: ref.rowquant_matmul_ref(xb, codes, s, z),
                             reps=3, flush=flush),
            library_ms=cuda_ms(torch, lambda: torch.matmul(xb, wd), flush=flush),
            kernel_ms=kernel_ms(torch, lambda: ops.rowquant_matmul(xb, codes, s, z), flush=flush),
            library_kernel_ms=kernel_ms(torch, lambda: torch.matmul(xb, wd), flush=flush),
            bound=bound(cost.rowquant_matmul(m, k, n, n_seg, xb.dtype.itemsize)),
            max_abs_err=err, main_path=what in K3_SHAPES))
        del w, codes, s, z, wd
    for r in k3:
        log(f"K3 {r['shape']:12s} M={r['m']} K={r['k']} N={r['n']}: {r['ms']:.4f} ms "
            f"(plain {r['plain_ms']:.4f}, torch.matmul bf16 {r['library_ms']:.4f}, "
            f"bound {r['bound'][0]:.4f} by {r['bound'][1]}, "
            f"{100 * r['bound'][0] / r['ms']:.0f}% of bound); kernel time alone (profiler) "
            f"{r['kernel_ms']:.4f} ms vs torch.matmul's {r['library_kernel_ms']:.4f} ms: "
            f"{'faster' if r['kernel_ms'] < r['library_kernel_ms'] else 'SLOWER'}, "
            f"{100 * r['bound'][0] / r['kernel_ms']:.0f}% of bound")
    rows["rowquant_matmul"] = k3
    return rows


def whole_leaf_adamw(torch, cfg, params, grads, st, grad_scale):
    """The AdamW update on whole leaves, the plain version the chunked
    update (``optim.make_adamw``) is held to: each leaf's moments decoded
    whole (8-bit codes through ``qparam_decode``), the same elementwise op
    sequence on the whole leaf, the moments re-encoded whole
    (``qparam_encode``).  Updates `params` in place; returns the moments."""
    from repro_torch.core.quant import QuantConfig, QuantizedParam, qparam_decode, qparam_encode
    from repro_torch.optim.optimizers import MOMENT_BUCKET_SIZE

    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    mq = (QuantConfig(bits=cfg.moment_bits, bucket_size=MOMENT_BUCKET_SIZE, mode="nearest")
          if cfg.moment_bits else None)
    step = st.step + 1
    lr = cfg.schedule(step) if cfg.schedule is not None else f32(cfg.lr)
    c1 = 1.0 - f32(cfg.b1) ** f32(step)
    c2 = 1.0 - f32(cfg.b2) ** f32(step)
    mu, nu = {}, {}
    for k, p in params.items():
        g = grads[k].float() * grad_scale
        m, v = st.mu[k], st.nu[k]
        m = qparam_decode(m) if isinstance(m, QuantizedParam) else m
        v = qparam_decode(v) if isinstance(v, QuantizedParam) else v
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        step_dir = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.weight_decay:
            step_dir = step_dir + cfg.weight_decay * p
        p.sub_(lr * step_dir)
        mu[k] = qparam_encode(m, mq) if mq is not None else m
        nu[k] = qparam_encode(v, mq) if mq is not None else v
    return mu, nu


# the update row: a stacked leaf of 4 slices of 256 buckets and an unstacked
# leaf split into ranges of UPDATE_ROW_CHUNK values (its last one ends inside
# a bucket), 8-bit moments, UPDATE_ROW_STEPS updates
UPDATE_ROW = dict(stacked=(4, 1, 1, 256 * 1024), unstacked=(1, 1, 3 * 2048 + 904), steps=3)
UPDATE_ROW_CHUNK = 2048


def update_row(torch, log, dev="cuda"):
    """The chunked optimizer update (``make_adamw`` with 8-bit moments and
    weight decay: per layer slice and per range, moments decoded by K2 and
    re-encoded in place by K1) against ``whole_leaf_adamw`` on the same
    inputs: every parameter and moment wire torch.equal after each of
    UPDATE_ROW's steps; the stacked leaf's gradient handed over as its
    layer slices, as the train step hands it."""
    import repro_torch.optim.optimizers as optim_mod
    from repro_torch.core.quant import qparam_encode
    from repro_torch.optim import AdamWConfig, OptState, cosine_schedule, make_adamw

    gen = torch.Generator(device=dev).manual_seed(11)
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, schedule=cosine_schedule(1e-2, 1, 5),
                      moment_bits=8)
    shapes = {"a": UPDATE_ROW["unstacked"], "b": UPDATE_ROW["stacked"]}
    pc = {k: torch.randn(s, generator=gen, device=dev) for k, s in shapes.items()}
    pw = {k: v.clone() for k, v in pc.items()}
    opt = make_adamw(cfg)
    sc = opt.init(pc)
    mw = {k: qparam_encode(torch.zeros(s, device=dev), sc.mu[k].cfg) for k, s in shapes.items()}
    sw = OptState(step=0, mu=mw, nu={k: qparam_encode(torch.zeros(s, device=dev),
                                                       sc.mu[k].cfg) for k, s in shapes.items()})
    scale = torch.tensor(0.5, device=dev)
    chunks = 0
    with hooked(optim_mod, "CHUNK_VALUES", lambda _: UPDATE_ROW_CHUNK):
        for i in range(UPDATE_ROW["steps"]):
            g = {k: torch.randn(s, generator=gen, device=dev) for k, s in shapes.items()}
            gc = {"a": g["a"].clone(), "b": list(g["b"].clone().unbind(0))}
            pc, sc = opt.update(pc, gc, sc, grad_scale=scale)
            mu, nu = whole_leaf_adamw(torch, cfg, pw, g, sw, scale)
            sw = OptState(step=sw.step + 1, mu=mu, nu=nu)
            for k in shapes:
                check(torch.equal(pc[k], pw[k]), f"update row: step {i} parameter {k} differs "
                      "from the whole-leaf update")
                for which, a, b in (("mu", sc.mu, sw.mu), ("nu", sc.nu, sw.nu)):
                    check(torch.equal(a[k].wire, b[k].wire), f"update row: step {i} {which} "
                          f"codes of {k} differ from the whole-leaf update's")
        chunks = sum(len(optim_mod.chunk_ranges(s)) for s in shapes.values())
    log(f"update row: chunked AdamW (8-bit moments, weight decay) == whole-leaf on {dev}: "
        f"stacked {shapes['b']} by layer slice and unstacked {shapes['a']} in ranges of "
        f"{UPDATE_ROW_CHUNK}, {chunks} chunks, parameters and moment wires torch.equal after "
        f"each of {UPDATE_ROW['steps']} steps")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

KERNEL_META = {  # name: (source, the TPU kernel's pl.pallas_call)
    "quantize_pack": ("src/repro_torch/kernels/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:194"),
    "unpack_dequantize": ("src/repro_torch/kernels/csrc/quantize.cu",
                          "src/repro/kernels/quantize.py:248"),
    "rowquant_matmul": ("src/repro_torch/kernels/csrc/dequant_matmul.cu",
                        "src/repro/kernels/dequant_matmul.py:80"),
    "quantize_buckets": ("src/repro_torch/kernels/csrc/quantize.cu",
                         "src/repro/kernels/quantize.py:88"),
    "dequantize_buckets": ("src/repro_torch/kernels/csrc/quantize.cu",
                           "src/repro/kernels/quantize.py:280"),
    # not a TPU kernel: it draws the jax.random.gumbel bits of the reference's
    # sampler on the card
    "random_bits": ("src/repro_torch/kernels/csrc/quantize.cu",
                    "src/repro/models/layers.py:225"),
}


def buckets_path(torch, log):
    """The K4/K5 entry points' own path, as a caller uses them: stochastic
    8-bit quantize of an embedding-sized (100,608 x 1024) gradient with
    ``quantize_buckets``, decoded by ``dequantize_buckets``; counts zeroed
    just before and read just after."""
    from repro_torch.core import prng
    from repro_torch.kernels import ops
    nb = GPT13_NB["embed"]
    x = torch.randn((nb, 1024), generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda") * 1e-3
    rand = prng.uniform(prng.PRNGKey(15), (nb, 1024), "cuda")
    ops.reset_launches()
    codes, scale, zero = ops.quantize_buckets(x, rand, 255, True)
    y = ops.dequantize_buckets(codes, scale, zero)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    check(counts["quantize_buckets"] == 1 and counts["dequantize_buckets"] == 1
          and sum(counts.values()) == 2, f"buckets path launches {counts}")
    # stochastic rounding moves each value by less than one step of its bucket
    err = ((y - x).abs() / scale).max().item()
    check(math.isfinite(err) and err <= 1.0 + 1e-5, f"buckets path: error {err:.3f} steps")
    log(f"buckets path: quantize_buckets -> dequantize_buckets of {nb} x 1024, max error "
        f"{err:.4f} bucket steps; launches {counts}")
    return counts


def kernel_line(rows, launches):
    """One entry per kernel; times/bounds are those of the kernel's largest
    main-path shape (the other shapes are in the log above)."""
    out = []
    for name, (src, replaces) in KERNEL_META.items():
        big = max((r for r in rows[name] if r.get("main_path", True)),
                  key=lambda r: r["bound"][0])
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound"][0], "bound_by": big["bound"][1],
            "library_ms": big.get("library_ms"),
            "kernel_ms": big.get("kernel_ms"),
            "library_kernel_ms": big.get("library_kernel_ms"),
            "shape": big["shape"],
        })
    return {"kernels": out}


def smi_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if res.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,kernels,small,serve,continuous,speculative,moe,ssm,vlmaudio,"
                            "train,moetrain,ssmtrain,mmtrain,experiments,tune,roofline,analysis,"
                            "dist",
                    help="comma-separated subset of build,kernels,small,serve,continuous,"
                         "speculative,moe,ssm,vlmaudio,train,moetrain,ssmtrain,mmtrain,"
                         "experiments,tune,roofline,analysis,dist (roofline reads the steps the "
                         "train and tune phases profile; analysis the programs the "
                         "speculative and train phases trace)")
    ap.add_argument("--profile", action="store_true",
                    help="serve phase: also profile one decode step of each run "
                         "(chrome traces kept)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    if not (REPO / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels run only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    t0 = time.time()

    def log(msg):
        print(f"[chip_smoke {time.time() - t0:6.1f}s] {msg}", flush=True)

    try:
        card = smi_line()
        log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
        if "build" in phases:
            tb = time.time()
            logs = build.build_all()
            for name, text in logs.items():
                for line in text.splitlines():
                    if ("registers" in line or "error" in line.lower()
                            or ("spill" in line and " 0 bytes spill stores" not in line)):
                        log(f"nvcc {name}: {line.strip()}")
            log(f"build: {time.time() - tb:.1f} s")
        rows, paths = None, []
        measured = {} if "roofline" in phases else None
        built = {} if "analysis" in phases else None
        if "kernels" in phases:
            rows = kernel_phase(torch, log)
            paths.append(buckets_path(torch, log))
            update_row(torch, log)
        if "small" in phases:
            small_phase(torch, log)
            small_train_phase(torch, log)
        if "serve" in phases:
            paths.append(serve_phase(torch, log, profile=args.profile))
        if "continuous" in phases:
            paths.append(continuous_phase(torch, log))
        if "speculative" in phases:
            paths.append(speculative_phase(torch, log, built=built))
        if "moe" in phases:
            paths.append(moe_phase(torch, log))
        if "ssm" in phases:
            paths.append(ssm_phase(torch, log))
        if "vlmaudio" in phases:
            paths.append(vlmaudio_phase(torch, log))
        if "train" in phases:
            paths.append(train_phase(torch, log, measured=measured, built=built))
        if "moetrain" in phases:
            paths.append(moetrain_phase(torch, log))
        if "ssmtrain" in phases:
            paths.append(ssmtrain_phase(torch, log))
        if "mmtrain" in phases:
            paths.append(mmtrain_phase(torch, log))
        if "experiments" in phases:
            paths.append(experiments_phase(torch, log)[0])
        if "tune" in phases:
            paths.append(tune_phase(torch, log, measured=measured))
        if "roofline" in phases:
            roofline_phase(torch, log, measured, card)
        if "analysis" in phases:
            analysis_phase(torch, log, built)
        if "dist" in phases:
            paths.append(dist_phase(torch, log, wire="kernels" not in phases)[0])
        launches = {k: sum(p.get(k, 0) for p in paths) for k in KERNEL_META}
        if rows is not None:
            print(json.dumps(kernel_line(rows, launches)))
        print(card)
    except PhaseError as e:
        log(f"FAILED: {e}")
        return 1
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


@contextlib.contextmanager
def hooked(obj, attr, wrap):
    """Temporarily replace obj.attr by wrap(original).  A method found on
    the class is deleted from the instance afterwards, not set back: an
    instance holding its own bound method is a reference cycle, which would
    keep it (and the device memory it holds) alive until a GC pass."""
    orig = getattr(obj, attr)
    own = attr in vars(obj)
    setattr(obj, attr, wrap(orig))
    try:
        yield
    finally:
        if own:
            setattr(obj, attr, orig)
        else:
            delattr(obj, attr)


@contextlib.contextmanager
def phase_peak(torch, dev):
    """A phase's peak device memory: the peak is reset where the phase
    starts, and every reset inside it (a cell's own, for the cell's peak)
    first keeps the peak so far.  Yields a function that returns the
    phase's peak in GiB so far (nan off the card)."""
    if dev != "cuda":
        yield lambda: float("nan")
        return
    seen = [0]

    def wrap(orig):
        def f(*a, **k):
            seen.append(torch.cuda.max_memory_allocated())
            return orig(*a, **k)
        return f

    torch.cuda.reset_peak_memory_stats()
    with hooked(torch.cuda, "reset_peak_memory_stats", wrap):
        yield lambda: max(seen + [torch.cuda.max_memory_allocated()]) / 2**30


def capture_logits(store):
    def wrap(orig):
        def f(h, w):
            out = orig(h, w)
            store.append(out)
            return out
        return f
    return wrap


def capture_gathers(model, store):
    import torch

    def wrap(orig):
        def f(name, full):
            n = model.specs[name].n_logical_local(model.ms.model_size)
            raw = full[:n].detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
            store.setdefault(name, []).append(hashlib.sha256(raw).hexdigest())
            return orig(name, full)
        return f
    return wrap


# ---------------------------------------------------------------------------
# phase 3: small input, card against CPU
# ---------------------------------------------------------------------------

SMALL = dict(batch=2, prompt_len=16, gen=4, seed=0)
# f32 compute, logits of magnitude ~1: cuBLAS and the CPU sum in different
# orders, and a 1-ulp difference upstream can flip the bf16 rounding of a
# cached k/v element (2^-9 relative); measured 1.5e-4 on an H100
SMALL_LOGIT_ATOL = 1e-3
# the router's f32 product sums in other orders on the card and the CPU: a
# token whose k-th and (k+1)-th probabilities lie closer than this on the
# CPU may take another expert on the card, and is left out of the routing
# gate (the count is printed)
ROUTE_MARGIN = 1e-5


def capture_routes(store):
    """Hook on ``moe.route``: each call's (probs, top-k ids), on the host."""
    def wrap(orig):
        def f(x, router, cfg):
            probs, topw, tope = orig(x, router, cfg)
            store.append((probs.detach().cpu(), tope.cpu()))
            return probs, topw, tope
        return f
    return wrap


def route_agreement(torch, card_routes, cpu_routes, k):
    """Per token routing of the card against the CPU: (compared, left out)
    counts; fails where a token whose CPU router margin (k-th minus (k+1)-th
    probability) is at least ROUTE_MARGIN took other top-k experts."""
    check(len(card_routes) == len(cpu_routes),
          f"{len(card_routes)} MoE calls on the card, {len(cpu_routes)} on the CPU")
    compared = excluded = 0
    for (_, ec), (pp, ep) in zip(card_routes, cpu_routes):
        # the card's decode calls carry its dead lanes after the live ones
        ec = ec[:len(ep)]
        top = torch.sort(pp, dim=-1, descending=True).values
        clear = (top[:, k - 1] - top[:, k]) >= ROUTE_MARGIN
        same = (ec.sort(dim=-1).values == ep.sort(dim=-1).values).all(dim=-1)
        check(bool(same[clear].all()), f"top-{k} experts differ between card and CPU for "
              f"{int((~same & clear).sum())} tokens with a clear router margin")
        compared += int(clear.sum())
        excluded += int((~clear).sum())
    return compared, excluded


def small_phase(torch, log, arch="gpt-1.3b", prompt_fn=None):
    """`arch`'s smoke config (f32 compute) on the card and on the CPU from
    the same weights: gathered weight bytes equal (K1/K2 are bit-exact), the
    live lanes' logits within SMALL_LOGIT_ATOL, same greedy tokens; for the
    MoE family also every MoE call's top-k experts, for the tokens whose CPU
    router margin is at least ROUTE_MARGIN.  The prompt batch is
    ``prompt_fn(setup, tokens)`` (default ``make_prompt_batch``)."""
    import repro_torch.models.layers as L
    import repro_torch.models.moe as moe_mod
    from repro_torch.core.qsdp import QSDPConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.serve import build_serve_setup, make_prompt_batch

    qcfg = QSDPConfig(compute_dtype="float32")
    res = {}
    params = None
    for dev in ("cuda", "cpu"):
        setup = build_serve_setup(arch, smoke=True, qsdp=qcfg, device=dev,
                                  params=params, **SMALL)
        params = {k: v.cpu() for k, v in setup.params.items()}
        tokens, _ = SyntheticLM(setup.cfg.vocab_size, SMALL["prompt_len"], SMALL["batch"],
                                seed=SMALL["seed"]).sample(0)
        prompt = (prompt_fn(setup, tokens) if prompt_fn is not None else
                  make_prompt_batch(setup.cfg, setup.spec, setup.ms, tokens, setup.device))
        logits, gathers, routes = [], {}, []
        with hooked(L, "vocab_parallel_logits", capture_logits(logits)), \
                hooked(setup.model.engine, "_reshape_full",
                       capture_gathers(setup.model, gathers)), \
                hooked(moe_mod, "route", capture_routes(routes)):
            out = setup.engine.generate(setup.params, prompt, n_tokens=SMALL["gen"])
        res[dev] = (out.cpu(), [t.cpu() for t in logits], gathers, routes)
    (tc, lc, gc, rc), (tp, lp, gp, rp) = res["cuda"], res["cpu"]
    check(gc == gp, f"small {arch}: gathered weight bytes differ between card and CPU")
    check(bool(rc) == setup.cfg.is_moe, f"small {arch}: {len(rc)} MoE calls")
    k = setup.cfg.moe_top_k
    try:
        compared, excluded = route_agreement(torch, rc, rp, k)
    except PhaseError as e:
        raise PhaseError(f"small {arch}: {e}") from None
    # the card's launches run at LANE_BLOCK lanes: its logits carry dead lanes
    err = max((a[:len(b)] - b).abs().max().item() for a, b in zip(lc, lp))
    check(math.isfinite(err) and err <= SMALL_LOGIT_ATOL,
          f"small {arch}: logits differ by {err:.3e} > {SMALL_LOGIT_ATOL}")
    check(torch.equal(tc, tp), f"small {arch}: tokens differ: {tc.tolist()} vs {tp.tolist()}")
    routing = (f"; top-{k} experts equal for {compared} token routings of {len(rc)} MoE "
               f"calls, {excluded} left out (CPU router margin < {ROUTE_MARGIN:g})"
               if rc else "")
    log(f"small: {setup.cfg.name} on card == CPU: {sum(map(len, gc.values()))} gathers "
        f"byte-equal{routing}, logits max |diff| {err:.3e}, tokens {tc.tolist()}")


# ---------------------------------------------------------------------------
# phase 4: gpt-1.3b serving, dense then rowquant
# ---------------------------------------------------------------------------

SERVE = dict(batch=4, prompt_len=128, gen=16, seed=0)
SERVE_REPS = 3  # timed generate() runs per path


def k2_buffers(eng, quantized, skip=(), invocations=None) -> tuple[int, int]:
    """K2 launches that decode the gathered (or, with `quantized` the
    engine's ``_is_grad_quantized``, reduce-scattered) wire buffers of one
    pass over the parameters, as ``core.qsdp.layer_kernel_launches`` counts
    them (one rank: one row per buffer): (top-level tensors, each gathered
    alone; the buffers of the grouped tensors not named in `skip`: one per
    layer of a stack, and one per each of the `invocations` of an
    un-stacked block, the hybrid's shared block)."""
    from repro_torch.core.qsdp import layer_kernel_launches
    part = "reduce" if quantized == eng._is_grad_quantized else "gather"
    alone, layers = 0, 0
    groups = {}
    for n in eng.specs:
        groups.setdefault(n.rsplit("/", 1)[0] if "/" in n else n, []).append(n)
    for g, names in groups.items():
        k2 = layer_kernel_launches(eng, sorted(names), skip)[part][1]
        s = eng.specs[names[0]]
        if "/" not in names[0]:
            alone += k2
            continue
        times = s.stack if s.stack is not None else invocations
        if times is None and k2:
            raise ValueError(f"{g}/ is gathered once per invocation: pass `invocations`")
        layers += k2 * (times or 0)
    return alone, layers


def expected_launches(model, gen: int, rowquant: bool) -> dict:
    """Kernel launches of generate() by the code's structure: every decode
    step (and the prefill) quantizes each quantized tensor once (K1) and
    decodes each gathered buffer that holds a quantized tensor in one launch
    (K2) -- the embedding's, and one per layer -- except, with rowquant, the
    decode MLP weights, which go through K3 (each one falling back to a
    buffer of its own where its buckets do not tile its rows)."""
    from repro_torch.models.decode import ROWQUANT_MLP
    eng = model.engine
    n_q = sum((s.stack or 1) for s in eng.specs.values() if eng._is_quantized(s))
    rq = [n for n in eng.specs if n.split("/")[-1] in ROWQUANT_MLP] if rowquant else []
    n_rq = sum(eng.specs[n].stack or 1 for n in rq if eng.rowquant_eligible(n))
    k2_prefill = sum(k2_buffers(eng, eng._is_quantized))
    k2_step = (sum(k2_buffers(eng, eng._is_quantized, skip=ROWQUANT_MLP if rowquant else ()))
               + sum(eng.specs[n].stack or 1 for n in rq
                     if eng._is_quantized(eng.specs[n]) and not eng.rowquant_eligible(n)))
    steps = gen - 1
    return {"quantize_pack": n_q * gen,
            "unpack_dequantize": k2_prefill + k2_step * steps,
            "rowquant_matmul": n_rq * steps,
            "per_step": (n_q, k2_step, n_rq)}


def serve_phase(torch, log, profile=False):
    import repro_torch.models.layers as L
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.serve import build_serve_setup, make_prompt_batch

    totals = {k: 0 for k in ops.KERNELS}
    first_step = {}
    for rowquant in (False, True):
        tag = "rowquant" if rowquant else "dense"
        setup = build_serve_setup("gpt-1.3b", smoke=False, rowquant_mlp=rowquant,
                                  device="cuda", **SERVE)
        cfg = setup.cfg
        tokens, _ = SyntheticLM(cfg.vocab_size, SERVE["prompt_len"], SERVE["batch"],
                                seed=SERVE["seed"]).sample(0)
        prompt = make_prompt_batch(cfg, setup.spec, setup.ms, tokens, setup.device)
        gen = SERVE["gen"]

        def run(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = setup.engine.generate(setup.params, prompt, n_tokens=n)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        run(2)  # warm-up: allocator, cuBLAS handles
        t_prefill = statistics.median(run(1)[1] for _ in range(SERVE_REPS))
        torch.cuda.reset_peak_memory_stats()
        logits = []
        ops.reset_launches()
        with hooked(L, "vocab_parallel_logits", capture_logits(logits)):
            out, t_first = run(gen)
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        totals_s = [t_first] + [run(gen)[1] for _ in range(SERVE_REPS - 1)]
        want = expected_launches(setup.model, gen, rowquant)
        check(tuple(out.shape) == (SERVE["batch"], gen), f"{tag}: tokens shape {out.shape}")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"{tag}: token out of range")
        check(all(bool(torch.isfinite(t).all()) for t in logits), f"{tag}: non-finite logits")
        check(len(logits) == gen, f"{tag}: {len(logits)} logit sets for {gen} tokens")
        for k in ops.KERNELS:
            check(counts[k] == want.get(k, 0), f"{tag}: {k} launched {counts[k]} times, "
                  f"the code's structure predicts {want.get(k, 0)}")
            totals[k] += counts[k]
        check(counts["quantize_pack"] > 0 and counts["unpack_dequantize"] > 0
              and (counts["rowquant_matmul"] > 0) == rowquant,
              f"{tag}: a kernel of the path was never launched: {counts}")
        first_step[tag] = logits[1].float()
        step_ms = sorted((t - t_prefill) / (gen - 1) * 1e3 for t in totals_s)
        t_total = statistics.median(totals_s)
        log(f"serve {tag}: gpt-1.3b {SERVE['batch']}x{gen} tokens, median of {SERVE_REPS} "
            f"runs {t_total:.3f} s ({SERVE['batch'] * gen / t_total:.1f} tok/s); prefill "
            f"{t_prefill * 1e3:.1f} ms; decode step median {statistics.median(step_ms):.2f} ms "
            f"(min {step_ms[0]:.2f}, max {step_ms[-1]:.2f}); peak memory {peak / 2**30:.2f} GiB")
        log(f"serve {tag}: launches {counts} = per decode step K1/K2/K3 {want['per_step']}")
        log(f"serve {tag}: tokens[0] = {out[0].tolist()}")
        if profile:
            profile_step(torch, setup, prompt, log, tag)
        del setup, prompt, logits, out
        torch.cuda.empty_cache()
    a, b = first_step["dense"], first_step["rowquant"]
    rel = (a - b).abs().max().item() / a.abs().max().item()
    check(math.isfinite(rel) and rel <= LOGIT_RTOL,
          f"first decode step logits: dense vs rowquant differ by {rel:.3e} of max |logit|")
    log(f"serve: first decode step logits dense vs rowquant: max |diff| / max |logit| = "
        f"{rel:.3e} (tol {LOGIT_RTOL})")
    return totals


def profile_step(torch, setup, prompt, log, tag):
    """torch.profiler over one decode step (after prefill and one warm-up
    step): device kernel time by name, the number of kernel launches, and
    the device's busy share of the step's wall time, read from the exported
    chrome trace (kernel events only, overlapping kernels counted once)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import prng
    eng, params = setup.engine, setup.params
    key = prng.PRNGKey(0)
    b, s = prompt["tokens"].shape
    with torch.inference_mode():
        nxt, cache = eng.prefill_step()(params, prompt, key)
        dec = eng.decode_step()
        pos = torch.full((b,), s, dtype=torch.int64, device=setup.device)
        nxt, cache = dec(params, cache, nxt, pos, prng.fold_in(key, 0))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            dec(params, cache, nxt, pos + 1, prng.fold_in(key, 1))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / f"trace_decode_{tag}.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    busy, kernels = busy_share(events)
    check(kernels, f"profile {tag}: the trace holds no kernel events")
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e["name"], [0.0, 0])
        d[0] += e["dur"]
        d[1] += 1
    log(f"profile {tag} (one decode step, profiler on): wall {wall_ms:.1f} ms, "
        f"{len(kernels)} kernels, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / 1e3 / wall_ms:.1f}% of wall, idle {100 - 100 * busy / 1e3 / wall_ms:.1f}%)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"profile {tag}:   {us / 1e3:8.3f} ms  x{n:5d}  {name[:80]}")
    for what, key in (("bfloat16_copy (casts to bf16)", "bfloat16_copy"),
                      ("K2 unpack_dequantize", "unpack_dequantize")):
        hits = [v for k, v in by_name.items() if key in k]
        log(f"profile {tag}: {what}: {sum(v[1] for v in hits)} kernels, "
            f"{sum(v[0] for v in hits) / 1e3:.3f} ms")
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    log(f"profile {tag}: {len(copies)} memory copies (not kernels), "
        f"{sum(e['dur'] for e in copies) / 1e3:.3f} ms")


# ---------------------------------------------------------------------------
# phase 5: continuous batching of gpt-1.3b (scheduler, chunked prefill, paged
# KV pool with prefix sharing and its quantized cold tier, sampling)
# ---------------------------------------------------------------------------

# pool: 256 blocks, twice one window per slot, so that an idle prefix reaches
# the cold horizon before the allocator has to evict it
CONT_ARCH = "gpt-1.3b"
CONT = dict(slots=4, ring=512, block=16, pool_blocks=256, chunk=64, buckets=3, interleave=1,
            quant_bits=4, horizon=8, seed=0, temperature=0.8, top_k=40, prefix=128)
# (behind the shared prefix?, sampled?, prompt tokens, new tokens) of the
# requests in submission order: prompts 32-384 tokens, 16-32 new tokens.
# The scheduler's decisions depend on these lengths only, so the plan fixes
# what happens: c0 and c1 start together (no hit; c0's prefix blocks are
# registered first), c3 retires early and c4 is admitted while c0 holds the
# prefix (a greedy hot hit), the long c5-c8 keep every slot busy past the
# cold horizon after the last prefix holder retires, and c9 rehydrates the
# demoted prefix, c10 and c11 share it hot.  c9-c11 are sampled: a
# rehydrated block holds 4-bit KV that no solo run of the request has.
CONT_PLAN = ((True, False, 288, 24), (True, True, 352, 32), (False, False, 320, 28),
             (False, False, 32, 16), (True, False, 160, 16), (False, True, 384, 32),
             (False, False, 384, 30), (False, True, 384, 32), (False, False, 256, 20),
             (True, True, 224, 24), (True, True, 300, 20), (True, True, 192, 18))


def continuous_requests(vocab: int):
    """CONT_PLAN's requests: prompts from rows of SyntheticLM seed
    CONT['seed'], the shared prefix the first CONT['prefix'] tokens of one
    more row."""
    from repro_torch.data import SyntheticLM
    from repro_torch.serve import Request
    longest = max(n for _, _, n, _ in CONT_PLAN)
    rows, _ = SyntheticLM(vocab, longest, len(CONT_PLAN) + 1, seed=CONT["seed"]).sample(0)
    prefix = rows[-1, :CONT["prefix"]].tolist()
    reqs = []
    for i, (shared, sampled, plen, gen) in enumerate(CONT_PLAN):
        prompt = (prefix + rows[i, :plen - CONT["prefix"]].tolist() if shared
                  else rows[i, :plen].tolist())
        reqs.append(Request(rid=f"c{i}", prompt=prompt, max_new_tokens=gen,
                            temperature=CONT["temperature"] if sampled else 0.0,
                            top_k=CONT["top_k"] if sampled else 0, seed=CONT["seed"] + i))
    return reqs


def expected_continuous_launches(model, st: dict, draft_params=None) -> dict:
    """K1/K2/K3/random_bits launches of one scheduler run by the code's
    structure: every chunk launch, decode step and speculative verify
    gathers the whole model once (K1 per quantized tensor, K2 per buffer:
    the embedding's and one per layer; the chunk path gathers its MLP
    densely, so no K3); each demoted block encodes k and v (K1 x 2), each
    rehydrated one decodes them (K2 x 2); one random_bits launch per
    sampler pass that draws for a row.  With `draft_params` (speculative),
    each draft launch gathers the tensors the draft keeps dense as a decode
    step does, decodes each layer's wire-form tensors that K3 does not take
    in one K2 launch, and runs K3 once per wire-form MLP weight."""
    from repro_torch.core.quant import QuantizedParam
    from repro_torch.models.decode import ROWQUANT_MLP
    eng = model.engine
    n_q = sum((s.stack or 1) for s in eng.specs.values() if eng._is_quantized(s))
    passes = st["prefill_chunks"] + st["decode_launches"] + st["verify_launches"]
    out = {"quantize_pack": n_q * passes + 2 * st["demotions"],
           "unpack_dequantize": sum(k2_buffers(eng, eng._is_quantized)) * passes
           + 2 * st["rehydrations"],
           "random_bits": st["sampled_launches"]}
    if draft_params:
        wire = {n for n, v in draft_params.items() if isinstance(v, QuantizedParam)}
        rq = {n for n in wire if n.split("/")[-1] in ROWQUANT_MLP
              and eng.rowquant_wire_eligible(n, draft_params[n])}
        dense_q = sum((s.stack or 1) for n, s in eng.specs.items()
                      if eng._is_quantized(s) and n not in wire)
        k2_dense = sum(k2_buffers(eng, eng._is_quantized,
                                  skip={n.split("/")[-1] for n in wire}))
        k2_wire = sum({n.rsplit("/", 1)[0]: eng.specs[n].stack or 1
                       for n in wire - rq}.values())
        d = st["draft_launches"]
        out["quantize_pack"] += dense_q * d
        out["unpack_dequantize"] += (k2_dense + k2_wire) * d
        out["rowquant_matmul"] = sum(eng.specs[n].stack or 1 for n in rq) * d
    return out


def launch_timer(torch, store, dev):
    """A ``hooked`` wrapper of an engine's step-function getter: each launch
    of the step it returns adds its host time to its tokens (the call, then
    a sync: the scheduler reads the tokens right after) to `store`."""
    def wrap(orig):
        def step_fn(*a, **k):
            fn = orig(*a, **k)

            def f(*a2, **k2):
                t = time.perf_counter()
                out = fn(*a2, **k2)
                if dev == "cuda":
                    torch.cuda.synchronize()
                store.append(time.perf_counter() - t)
                return out
            return f
        return step_fn
    return wrap


def route_setup(setup):
    """`setup` with the card's fixed-shape route (LANE_BLOCK lanes per
    launch) on any device: the CPU's default is the plain shapes, so a CPU
    rehearsal of the phase runs the card's route."""
    from repro_torch.models.decode import LANE_BLOCK
    from repro_torch.serve import ServeEngine
    spec = dataclasses.replace(setup.spec, lane_block=LANE_BLOCK)
    return dataclasses.replace(setup, spec=spec,
                               engine=ServeEngine(setup.model, spec, setup.device))


# the non-speculative batch-of-1 solo runs of CONT_PLAN's requests (the
# reference's solo form) by (model, request), shared by the continuous and
# speculative phases: both build their model from seed CONT["seed"] and
# serve it under one key
_SOLO: dict = {}


def solo_runs(torch, setup, reqs, key, chunk=CONT["chunk"]) -> dict:
    """{rid: tokens} of each request served alone on a batch-of-1 engine of
    the setup's spec (speculation off): ``generate(fold_step_keys=False,
    prefill_chunk=chunk)`` with the request's sampling parameters (chunk 0:
    whole-prompt prefill, the blocking scheduler's) on the scheduler's
    batch-of-1 prompt batch."""
    from repro_torch.serve import ServeEngine, make_prompt_batch, make_sample_params
    spec1 = dataclasses.replace(setup.spec, batch_global=1, draft_bits=0, draft_depth=0)
    solo = ServeEngine(setup.model, spec1, setup.device)
    for r in reqs:
        if (setup.cfg.name, r.rid) not in _SOLO:
            # the scheduler's batch-of-1 prefill batch, modality stubs included
            prompt = make_prompt_batch(setup.cfg, dataclasses.replace(spec1, batch_sharded=False),
                                       setup.ms, [list(r.prompt)], setup.device)
            _SOLO[setup.cfg.name, r.rid] = solo.generate(
                setup.params, prompt, r.max_new_tokens, key=key, fold_step_keys=False,
                sample=make_sample_params(r.temperature, r.top_k, r.seed),
                prefill_chunk=chunk, prefill_buckets=CONT["buckets"])[0].tolist()
    return {r.rid: _SOLO[setup.cfg.name, r.rid] for r in reqs}


def track_cold(sched):
    """Hooks that collect the requests whose lanes attach a block the cold
    tier rehydrated (4-bit KV that no solo run has): (hooks, that set)."""
    rehydrated, cold = set(), set()

    def rehydrate(orig):
        def f(*a, **k):
            bid, cache = orig(*a, **k)
            rehydrated.add(bid)
            return bid, cache
        return f

    def attach(orig):
        def f(slot_i, st):
            orig(slot_i, st)
            n = st.pf_off // sched.spec.kv_block_size
            if rehydrated & set(sched.block_tables[slot_i, :n].tolist()):
                cold.add(st.req.rid)
        return f

    return [(sched.engine, "rehydrate_block", rehydrate), (sched, "_prefix_attach", attach)], cold


def row_invariance(torch, log, dev):
    """Row 0's bits of the path's GEMMs and decode attention at M rows
    against at one row, at gpt-1.3b shapes: 0 where the row is
    row-invariant, else the max |difference|.  Says which launch a pooled
    batch changes when shapes follow the batch composition."""
    import repro_torch.models.layers as L
    from repro_torch import configs
    from repro_torch.models.attention import AttnConfig, decode_attend
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    def row0(fn, ms, make):
        base, res = None, {}
        for m in ms:
            r = fn(make(m))[0].float().cpu()
            base = r if base is None else base
            res[m] = 0.0 if torch.equal(r, base) else (r - base).abs().max().item()
        return res

    ms = (1, 4, 22, 43, 64, 88, 172, 256)
    out = {}
    for what, (k, n, dt, m_set) in {
            "x @ wq/wk/wv/wo (K 2048, N 2048) bf16": (2048, 2048, torch.bfloat16, ms),
            "x @ w_gate/w_up (K 2048, N 8192) bf16": (2048, 8192, torch.bfloat16, ms),
            "x @ w_down (K 8192, N 2048) bf16": (8192, 2048, torch.bfloat16, ms),
            "logits (K 2048, N 50304) f32": (2048, 50304, torch.float32, (1, 2, 4, 8))}.items():
        w = rnd(k, n, dt=dt) * 0.02
        x0 = rnd(1, k, dt=dt)
        out[what] = row0(lambda x, w=w: x @ w, m_set,
                         lambda m, x0=x0, k=k, dt=dt: torch.cat([x0, rnd(m - 1, k, dt=dt)]))
    wn = torch.ones(2048, device=dev)
    x0 = rnd(1, 2048)
    out["rms_norm (2048) bf16"] = row0(lambda x: L.rms_norm(x, wn), ms,
                                       lambda m: torch.cat([x0, rnd(m - 1, 2048)]))
    acfg = AttnConfig(n_heads=32, n_kv=32, head_dim=64, tp=1)
    q0, c0 = rnd(1, 32, 64), rnd(1, CONT["ring"], 32, 64)

    def attend(qc):
        q, c = qc
        return decode_attend(q, c, c, acfg, torch.full((q.shape[0],), 300, device=dev),
                             CONT["ring"])
    out["decode attention (ring 512) bf16"] = row0(
        attend, (1, 2, 4, 8), lambda m: (torch.cat([q0, rnd(m - 1, 32, 64)]),
                                         torch.cat([c0, rnd(m - 1, CONT["ring"], 32, 64)])))
    for what, res in out.items():
        varies = {m: d for m, d in res.items() if d}
        log(f"continuous: row invariance, {what}: "
            + (f"row 0 differs at M = {varies}" if varies else
               f"row 0 bit-equal at every M in {tuple(res)}"))
    out["route"] = route_invariance(torch, log, dev, rnd, configs.get_config(CONT_ARCH))
    return out


def route_invariance(torch, log, dev, rnd, cfg):
    """The fixed-shape route's gate for model config `cfg`: every launch of
    the decode path runs at LANE_BLOCK lanes (decode and verify: M =
    LANE_BLOCK rows; chunks: M = LANE_BLOCK x the top bucket), so a
    request's rows must come out with the same bits whatever the other lanes
    hold and whichever lane it rides: alone in lane 0 with the others dead
    (zeros; a batch-of-1 engine, M = 1 or one lane's chunk), or in lane 2
    beside live lanes (the pool).  Checked for every GEMM weight shape of the
    layer, the MoE layer (drop-free: a token's slot in its experts' buffers
    moves with the other lanes' routing), the f32 logits, decode attention
    (ring) and chunk attention (paged, the continuous cell's).  A verify
    launch runs each drafted token at the decode block's shape, so the
    decode gates hold it.  The SSM and hybrid families add the Mamba2
    projections and one recurrent step of the mixer (its output and both
    states); they have no chunk path, and the SSM family no attention."""
    import repro_torch.models.layers as L
    from repro_torch.models.attention import AttnConfig, chunk_attend, decode_attend
    from repro_torch.models.decode import CHUNKED_PREFILL_ARCHS, LANE_BLOCK
    from repro_torch.models.moe import MoEConfig, moe_layer
    lb, lq, ring = LANE_BLOCK, CONT["chunk"], CONT["ring"]
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    acfg = AttnConfig(n_heads=nh, n_kv=nkv, head_dim=hd, tp=1)
    chunked = cfg.arch_type in CHUNKED_PREFILL_ARCHS
    mamba = cfg.arch_type in ("ssm", "hybrid")
    din, n_ssm = cfg.ssm_expand * d, cfg.ssm_state

    def gate(what, fn, req, live, rows=1):
        """fn over lanes of `rows` rows: `req` one lane's input tensors,
        `live` the same tensors for all lanes; the request's output rows in
        lane 0 (the other lanes zero) and in lane 2 (the others live)."""
        def place(lane, fill):
            return [torch.cat([f[:lane * rows], r, f[(lane + 1) * rows:]])
                    for r, f in zip(req, fill)]
        a = fn(*place(0, [torch.zeros_like(f) for f in live]))[:rows].float().cpu()
        b = fn(*place(2, live))[2 * rows:3 * rows].float().cpu()
        diff = 0.0 if torch.equal(a, b) else (a - b).abs().max().item()
        check(diff == 0.0, f"fixed-shape route: {what}: the request's rows differ by {diff:.3e} "
              "between lane 0 beside dead lanes and lane 2 beside live ones")
        done.append(what)

    done = []
    gemms = {}
    shapes = []
    if cfg.has_attention:
        shapes += [("wq", (d, nh * hd)), ("wk/wv", (d, nkv * hd)), ("wo", (nh * hd, d))]
    if cfg.d_ff and not cfg.is_moe:
        shapes += [("w_gate/w_up", (d, cfg.d_ff)), ("w_down", (cfg.d_ff, d))]
    if mamba:
        shapes += [("w_z/w_x", (d, din)), ("w_bc", (d, 2 * n_ssm)),
                   ("w_dt", (d, din // cfg.ssm_head_dim)), ("w_out", (din, d))]
    for what, shape in shapes:
        gemms[shape] = f"{gemms[shape]}/{what}" if shape in gemms else what
    for (k, n), what in gemms.items():
        w = rnd(k, n) * 0.02
        for rows in ((1, lq) if chunked else (1,)):
            gate(f"x @ {what} bf16 at M = {lb * rows}", lambda x, w=w: x @ w,
                 [rnd(rows, k)], [rnd(lb * rows, k)], rows)
        del w
    if mamba:
        from repro_torch.models.mamba import MambaConfig, mamba2_decode
        mc = MambaConfig(d_model=d, d_state=n_ssm, head_dim=cfg.ssm_head_dim,
                         expand=cfg.ssm_expand, conv_k=cfg.ssm_conv, chunk=cfg.ssm_chunk, tp=1)
        h = mc.n_heads
        mw = {"w_z": rnd(d, din) * 0.02, "w_x": rnd(d, din) * 0.02,
              "w_bc": rnd(d, 2 * n_ssm) * 0.02, "w_dt": rnd(d, h) * 0.02,
              "conv_x": rnd(din, mc.conv_k) * 0.3, "conv_bc": rnd(2 * n_ssm, mc.conv_k) * 0.3,
              "a_log": rnd(h) * 0.1 + 0.5, "dt_bias": rnd(h) * 0.3 - 4.0, "d_skip": rnd(h) + 1,
              "norm": rnd(din) * 0.1 + 1, "w_out": rnd(din, d) * 0.02}

        def mixer(x, conv, ssm):
            out, conv, ssm = mamba2_decode(x, mw, mc, conv, ssm)
            return torch.cat([out.float().flatten(1), conv.flatten(1), ssm.flatten(1)], 1)

        cc = din + 2 * n_ssm
        gate(f"Mamba2 decode step (out, conv ring, state) at B = {lb}", mixer,
             [rnd(1, d), rnd(1, mc.conv_k - 1, cc, dt=torch.float32),
              rnd(1, h, mc.head_dim, n_ssm, dt=torch.float32)],
             [rnd(lb, d), rnd(lb, mc.conv_k - 1, cc, dt=torch.float32),
              rnd(lb, h, mc.head_dim, n_ssm, dt=torch.float32)])
        del mw
    if cfg.is_moe:
        e, ff = cfg.n_experts, cfg.moe_d_ff
        ecfg = MoEConfig(n_experts=e, top_k=cfg.moe_top_k, d_model=d, d_ff=ff, tp=1)
        ew = {"router": rnd(d, e, dt=torch.float32) / d ** 0.5,
              "w_gate": rnd(e, d, ff) * 0.02, "w_up": rnd(e, d, ff) * 0.02,
              "w_down": rnd(e, ff, d) * 0.02}
        for rows in (1, lq):
            gate(f"MoE layer ({e} experts, top-{cfg.moe_top_k}, drop-free) bf16 at "
                 f"M = {lb * rows}", lambda x: moe_layer(x, ew, ecfg, no_drop=True)[0],
                 [rnd(rows, d)], [rnd(lb * rows, d)], rows)
        del ew
    head, fnorm = rnd(cfg.vocab_size, d, dt=torch.float32) * 0.02, torch.ones(d, device=dev)
    gate(f"final norm + f32 logits at M = {lb}",
         lambda x: L.vocab_parallel_logits(L.rms_norm(x, fnorm), head),
         [rnd(1, d)], [rnd(lb, d)])
    del head
    pos = torch.full((lb,), 300, device=dev)
    if cfg.has_attention:
        gate(f"decode attention (ring {ring}) at B = {lb}",
             lambda q, c: decode_attend(q, c, c, acfg, pos, ring),
             [rnd(1, nh, hd), rnd(1, ring, nkv, hd)], [rnd(lb, nh, hd), rnd(lb, ring, nkv, hd)])
    if cfg.arch_type == "audio":
        from repro_torch.models.attention import decode_cross_attention
        enc = (CONT["ring"] - max(g for *_, g in CONT_PLAN)) // cfg.enc_frames_ratio
        xw = {"wq": rnd(d, nh * hd) * 0.02, "wo": rnd(nh * hd, d) * 0.02}
        gate(f"decode cross attention ({enc} frames) at B = {lb}",
             lambda x, c: decode_cross_attention(x, xw, acfg, c, c, enc),
             [rnd(1, d), rnd(1, enc, nkv, hd)], [rnd(lb, d), rnd(lb, enc, nkv, hd)])
        del xw
    if chunked:
        bs = CONT["block"]
        bt = torch.arange(lb * (ring // bs), device=dev).reshape(lb, ring // bs)
        cpos = (torch.arange(lq, device=dev) + 200)[None].expand(lb, lq)
        gate(f"chunk attention (paged, block {bs}) at B = {lb} x {lq}",
             lambda q, c: chunk_attend(q, c, c, acfg, cpos, ring, bt, bs),
             [rnd(1, lq, nh, hd), rnd(1, ring, nkv, hd)],
             [rnd(lb, lq, nh, hd), rnd(lb, ring, nkv, hd)])
    log(f"{cfg.name}: fixed-shape route: a request's rows bit-equal in lane 0 beside dead "
        f"lanes and in lane 2 beside live ones, for {done}")
    return done


def fixed_shape_cost(torch, log, setup, key, reps=5):
    """What the fixed-shape route costs a batch-of-1 engine: one lane's
    decode step and 21-token chunk launch at the route's shapes (LANE_BLOCK
    lanes, the top bucket) vs at batch-composition shapes (one lane, the
    chunk's own bucket), host clock to the token on the host, in turns
    (plain, fixed, fixed, plain).  The 4-slot pool's launches already ran
    at LANE_BLOCK lanes and the top bucket, so its steps are the same
    either way."""
    from repro_torch.core import prng
    from repro_torch.serve import ServeEngine, make_sample_params
    spec1 = dataclasses.replace(setup.spec, batch_global=1)
    engines = {"plain": ServeEngine(setup.model, dataclasses.replace(spec1, lane_block=1),
                                    setup.device),
               "fixed": ServeEngine(setup.model, spec1, setup.device)}
    clen, top = 21, CONT["chunk"]
    tokens = torch.arange(clen, dtype=torch.int64)[None] + 100
    bt = torch.arange(setup.spec.blocks_per_slot, dtype=torch.int64)[None]
    sample = make_sample_params(b=1)
    times = {(t, w): [] for t in engines for w in ("chunk", "decode")}
    with torch.inference_mode():
        for tag in ["plain", "fixed", "fixed", "plain"] * reps:
            dm = engines[tag].dm
            cache = engines[tag].init_cache()
            torch.cuda.synchronize()
            t = time.perf_counter()
            nxt, cache = dm.prefill_chunk_fn(setup.params, cache, tokens, torch.tensor([0]),
                                             torch.tensor([clen]), key, sample, bt,
                                             compute_len=top if tag == "fixed" else 0)
            nxt = nxt.cpu()
            times[tag, "chunk"].append(time.perf_counter() - t)
            t = time.perf_counter()
            dm.decode_fn(setup.params, cache, nxt, torch.tensor([clen]), key, sample,
                         bt)[0].cpu()
            times[tag, "decode"].append(time.perf_counter() - t)
            del cache
    med = {k: 1e3 * statistics.median(v) for k, v in times.items()}
    log(f"continuous: fixed-shape cost, one lane (median of {2 * reps}, ms): decode step "
        f"{med['plain', 'decode']:.2f} at 1 lane -> {med['fixed', 'decode']:.2f} at "
        f"{engines['fixed'].dm.lanes} lanes; chunk launch of {clen} tokens "
        f"{med['plain', 'chunk']:.2f} at 1 lane x {clen} -> {med['fixed', 'chunk']:.2f} at "
        f"{engines['fixed'].dm.lanes} lanes x {top}")
    del engines
    torch.cuda.empty_cache()
    return med


def continuous_phase(torch, log, dev="cuda", profile=True, arch=None):
    """`arch` (gpt-1.3b unless given) at full width and depth through
    ``make_scheduler`` -> ``ContinuousScheduler.run``: CONT's configuration,
    CONT_PLAN's requests, every launch on the fixed-shape route.  Run 1 (profiling one pooled
    decode step of sampled lanes: no int64 bitwise or shift kernel may
    appear) and run 2 (counts zeroed just before, read just after, against
    the code's structure; timed) must give every request the same tokens;
    every request that attached no rehydrated block (every greedy one) must
    equal its solo run on a batch-of-1 engine (``generate(fold_step_keys=
    False, prefill_chunk=64)``, the reference's solo form); the pool's
    invariants hold, blocks were demoted and rehydrated, and none is left in
    use.  On the card, for gpt-1.3b, also ``row_invariance`` and
    ``fixed_shape_cost``."""
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.kernels import ops
    from repro_torch.serve import make_scheduler

    arch = arch or CONT_ARCH
    setup = continuous_setup(torch, dev, arch)
    reqs = continuous_requests(setup.cfg.vocab_size)
    key = prng.PRNGKey(CONT["seed"])

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def run(profile_step):
        sched = make_scheduler(setup, gather_key=key, prefill_chunk=CONT["chunk"],
                               prefill_buckets=CONT["buckets"],
                               prefill_interleave=CONT["interleave"],
                               kv_quant_bits=CONT["quant_bits"],
                               kv_quant_horizon=CONT["horizon"])
        hooks, cold = track_cold(sched)
        launches = {"chunk": [], "decode": []}
        hooks += [(sched.engine, "prefill_chunk_step",
                   launch_timer(torch, launches["chunk"], dev)),
                  (sched.engine, "decode_step", launch_timer(torch, launches["decode"], dev))]
        steps, prof = [], None
        sync()
        with contextlib.ExitStack() as stack:
            for h in hooks:
                stack.enter_context(hooked(*h))
            for r in reqs:
                sched.submit(r)
            t0 = time.perf_counter()
            while sched.queue or sched.n_active():
                decoding = [s for s in sched.slots if s is not None and not s.prefilling]
                if (profile_step and prof is None
                        and any(s.req.needs_sampling for s in decoding)):
                    prof = profile_train_step(torch, lambda _: sched.step(), None, log,
                                              tag="continuous")
                    continue
                chunked = sched.prefill_chunk_count
                t = time.perf_counter()
                sched.step()  # ends in a host read of the tokens
                steps.append((time.perf_counter() - t, sched.prefill_chunk_count > chunked))
            sync()
            wall = time.perf_counter() - t0
        sched.pool.check_invariants()
        return sched, {r: c.tokens.tolist() for r, c in sched.finished.items()}, cold, \
            steps, prof, wall, launches

    with torch.inference_mode():
        s1, out1, cold1, _, prof, _, _ = run(profile)
        ops.reset_launches()
        s2, out2, cold2, steps, _, wall, launch_s = run(False)
        counts = dict(ops.LAUNCHES)
    st = s2.stats()
    check(out1 == out2, "continuous: two runs gave different tokens: " + str(
        sorted(r for r in out1 if out1[r] != out2.get(r))))
    check(set(out2) == {r.rid for r in reqs}, "continuous: not every request finished")
    for r in reqs:
        check(len(out2[r.rid]) == r.max_new_tokens
              and all(0 <= t < setup.cfg.vocab_size for t in out2[r.rid]),
              f"continuous {r.rid}: tokens {out2[r.rid]}")
    check(st["demotions"] > 0 and st["rehydrations"] > 0,
          f"continuous: demotions {st['demotions']}, rehydrations {st['rehydrations']}")
    check(st["blocks_in_use"] == 0, f"continuous: {st['blocks_in_use']} blocks left in use")
    greedy = [r for r in reqs if not r.needs_sampling]
    check(not cold2 & {r.rid for r in greedy} and cold1 == cold2 and cold2,
          f"continuous: requests that attached rehydrated blocks: {cold1} / {cold2}")
    want = expected_continuous_launches(setup.model, st)
    for k in ops.KERNELS:
        check(counts[k] == want.get(k, 0), f"continuous: {k} launched {counts[k]} times, "
              f"the code's structure predicts {want.get(k, 0)}")
    check(all(counts[k] > 0 for k in want), f"continuous: a kernel never launched: {counts}")
    if profile:
        check(prof is not None, "continuous: no step with a sampled lane decoding to profile")
        check(prof["threefry_int64"] == 0, f"continuous: {prof['threefry_int64']} int64 "
              "bitwise/shift kernels in the profiled step (a threefry draw outside the kernels)")
        check(prof["rb_n"] >= 1, "continuous: no random_bits launch in the profiled step of "
              "a sampled lane")

    # every request that attached no rehydrated block against its solo run
    # on a batch-of-1 engine (the reference's solo form); the fixed-shape
    # route makes that engine launch at the pool's shapes
    solo = solo_runs(torch, setup, [r for r in reqs if r.rid not in cold2], key)
    for rid, ref in solo.items():
        check(ref == out2[rid], f"continuous {rid}: scheduler tokens {out2[rid]} != batch-of-1 "
              f"solo run {ref} (first difference at token "
              f"{next((i for i, (a, b) in enumerate(zip(ref, out2[rid])) if a != b), None)})")
    log(f"continuous: {len(solo)} requests bit-equal to their batch-of-1 solo runs "
        f"({sorted(solo)}; greedy {[r.rid for r in greedy]}); sampled "
        f"{[r.rid for r in reqs if r.needs_sampling]} equal across two runs; requests on "
        f"rehydrated blocks {sorted(cold2)}")

    ttft = sorted(c.first_token_time - c.submit_time for c in s2.finished.values())
    dec = sorted(t for t, chunked in steps if not chunked)
    mix = sorted(t for t, chunked in steps if chunked)
    pct = (lambda a, q: float(np.percentile(a, q)) if a else float("nan"))
    log(f"continuous: {setup.cfg.name}, {len(reqs)} requests on {CONT['slots']} slots, ring "
        f"{CONT['ring']}, block {CONT['block']}, chunk {CONT['chunk']} (buckets {s2.buckets}): "
        f"{st['tokens_generated']} tokens in {wall:.3f} s = "
        f"{st['tokens_generated'] / wall:.2f} tokens/s; TTFT p50 {pct(ttft, 50):.3f} s, "
        f"p95 {pct(ttft, 95):.3f} s")
    log(f"continuous: step ms: decode only median {1e3 * pct(dec, 50):.2f} (p95 "
        f"{1e3 * pct(dec, 95):.2f}, {len(dec)} steps); with a chunk launch median "
        f"{1e3 * pct(mix, 50):.2f} (p95 {1e3 * pct(mix, 95):.2f}, {len(mix)} steps); "
        f"occupancy {st['mean_occupancy']:.3f} of {CONT['slots']}; {st['prefill_chunks']} "
        f"chunk launches, {st['decode_launches']} decode steps")
    log(f"continuous: launch ms (host, to the tokens): chunk launch median "
        f"{1e3 * pct(launch_s['chunk'], 50):.2f} (p95 {1e3 * pct(launch_s['chunk'], 95):.2f}, "
        f"{len(launch_s['chunk'])}), decode launch median {1e3 * pct(launch_s['decode'], 50):.2f} "
        f"(p95 {1e3 * pct(launch_s['decode'], 95):.2f}, {len(launch_s['decode'])})")
    log(f"continuous: prefix hit rate {st['prefix_hit_rate']:.3f} ({st['prefix_hits']} hits), "
        f"demotions {st['demotions']}, rehydrations {st['rehydrations']}, cold blocks at the "
        f"end {st['cold_blocks']} = {st['cold_bytes']} bytes "
        f"({st['cold_compression']:.2f}x smaller than hot), cow forks {st['cow_forks']}")
    log(f"continuous: launches {counts} = structure {want}")
    if profile:
        log(f"continuous: profiled step: {prof['kernels']} kernels, busy "
            f"{prof['busy_ms']:.1f} of {prof['wall_ms']:.1f} ms "
            f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%); random_bits {prof['rb_n']}, "
            f"K1 {prof['k1_n']} ({prof['k1_ms']:.3f} ms), K2 {prof['k2_n']} "
            f"({prof['k2_ms']:.3f} ms); int64 elementwise kernels {prof['int64_n']}, of which "
            f"bitwise/shift {prof['threefry_int64']}")
    if dev == "cuda" and arch == CONT_ARCH:
        row_invariance(torch, log, dev)
        fixed_shape_cost(torch, log, setup, key)
    del setup, s1, s2
    if dev == "cuda":
        torch.cuda.empty_cache()
    return counts


def continuous_setup(torch, dev, arch, **kw):
    """`arch` at CONT's configuration on the fixed-shape route; `kw` adds
    DecodeSpec fields (the speculative phase's draft)."""
    from repro_torch.serve import build_serve_setup
    gen_max = max(g for *_, g in CONT_PLAN)
    setup = build_serve_setup(arch, smoke=False, batch=CONT["slots"],
                              prompt_len=CONT["ring"] - gen_max, gen=gen_max,
                              seed=CONT["seed"], sampling=True, kv_block_size=CONT["block"],
                              kv_pool_blocks=CONT["pool_blocks"], device=dev, **kw)
    check(setup.spec.cache_len == CONT["ring"], f"ring {setup.spec.cache_len}")
    return route_setup(setup)


# ---------------------------------------------------------------------------
# phase 6: self-speculative decoding of gpt-1.3b in the continuous cell
# ---------------------------------------------------------------------------

# the reference's qsdp-spec setting (benchmarks/bench_serve.py:362): a 4-bit
# draft of the same weights drafts up to 4 tokens per slot per step
SPEC = dict(draft_bits=4, draft_depth=4)


def speculative_phase(torch, log, dev="cuda", arch=None, built=None):
    """`arch` (gpt-1.3b unless given) at full width and depth through
    ``make_scheduler`` with
    ``DecodeSpec(draft_bits=4, draft_depth=4)``: CONT's configuration and
    CONT_PLAN's requests, as the continuous phase.  Gates: every request
    that attached no rehydrated block, greedy and sampled, commits the
    tokens of its non-speculative batch-of-1 solo run; at least one drafted
    token is accepted; the launches of K1/K2/K3/random_bits (counts zeroed
    just before the run, read just after) are those the code's structure
    derives from the run's statistics; the pool's invariants hold and no
    block is left in use.  Prints tokens/s, TTFT, the draft and verify
    launches' times, the acceptance rate and the draft overhead.  With
    `built` (a dict), its engine's decode, chunked-prefill and verify
    programs are then traced for the analysis phase (:func:`card_traces`)."""
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.kernels import ops
    from repro_torch.serve import make_scheduler

    setup = continuous_setup(torch, dev, arch or CONT_ARCH, **SPEC)
    reqs = continuous_requests(setup.cfg.vocab_size)
    key = prng.PRNGKey(CONT["seed"])

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    times = {"draft": [], "verify": []}
    sched = make_scheduler(setup, gather_key=key, prefill_chunk=CONT["chunk"],
                           prefill_buckets=CONT["buckets"], prefill_interleave=CONT["interleave"],
                           kv_quant_bits=CONT["quant_bits"], kv_quant_horizon=CONT["horizon"])
    hooks, cold = track_cold(sched)
    hooks += [(sched.draft_engine, "decode_step", launch_timer(torch, times["draft"], dev)),
              (sched.engine, "verify_step", launch_timer(torch, times["verify"], dev))]
    steps = []
    with torch.inference_mode(), contextlib.ExitStack() as stack:
        for h in hooks:
            stack.enter_context(hooked(*h))
        for r in reqs:
            sched.submit(r)
        sync()
        ops.reset_launches()
        t0 = time.perf_counter()
        while sched.queue or sched.n_active():
            chunked = sched.prefill_chunk_count
            t = time.perf_counter()
            sched.step()
            steps.append((time.perf_counter() - t, sched.prefill_chunk_count > chunked))
        sync()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
    sched.pool.check_invariants()
    st = sched.stats()
    out = {r: c.tokens.tolist() for r, c in sched.finished.items()}
    check(set(out) == {r.rid for r in reqs}, "speculative: not every request finished")
    check(st["blocks_in_use"] == 0, f"speculative: {st['blocks_in_use']} blocks left in use")
    check(st["verify_launches"] > 0 and st["draft_launches"] > 0,
          f"speculative: {st['draft_launches']} draft and {st['verify_launches']} verify launches")
    check(st["spec_tokens"] > st["spec_lane_steps"],
          f"speculative: no drafted token accepted ({st['spec_tokens']} tokens in "
          f"{st['spec_lane_steps']} verified lane steps)")
    want = expected_continuous_launches(setup.model, st, sched.draft_params)
    for k in ops.KERNELS:
        check(counts[k] == want.get(k, 0), f"speculative: {k} launched {counts[k]} times, "
              f"the code's structure predicts {want.get(k, 0)}")
    check(all(counts[k] > 0 for k, n in want.items() if n),
          f"speculative: a kernel never launched: {counts}")
    solo = solo_runs(torch, setup, [r for r in reqs if r.rid not in cold], key)
    check(any(r.needs_sampling for r in reqs if r.rid in solo)
          and all(r.rid in solo for r in reqs if not r.needs_sampling),
          f"speculative: requests on rehydrated blocks {sorted(cold)} leave no sampled one "
          "or take a greedy one")
    for rid, ref in solo.items():
        check(ref == out[rid], f"speculative {rid}: committed tokens {out[rid]} != the "
              f"non-speculative batch-of-1 solo run {ref}")
    ttft = sorted(c.first_token_time - c.submit_time for c in sched.finished.values())
    pct = (lambda a, q: float(np.percentile(a, q)) if a else float("nan"))
    dec = sorted(t for t, chunked in steps if not chunked)
    log(f"speculative: {len(solo)} requests ({sorted(solo)}) commit the tokens of their "
        f"non-speculative batch-of-1 solo runs, greedy and sampled; requests on rehydrated "
        f"blocks {sorted(cold)}")
    log(f"speculative: {setup.cfg.name}, draft {SPEC['draft_bits']}-bit x depth "
        f"{SPEC['draft_depth']}, "
        f"{len(reqs)} requests on {CONT['slots']} slots: {st['tokens_generated']} tokens in "
        f"{wall:.3f} s = {st['tokens_generated'] / wall:.2f} tokens/s; TTFT p50 "
        f"{pct(ttft, 50):.3f} s, p95 {pct(ttft, 95):.3f} s")
    log(f"speculative: step ms: without a chunk launch median {1e3 * pct(dec, 50):.2f} "
        f"({len(dec)} steps); draft launch median {1e3 * pct(times['draft'], 50):.2f} "
        f"({len(times['draft'])}), verify launch median {1e3 * pct(times['verify'], 50):.2f} "
        f"({len(times['verify'])}); {st['prefill_chunks']} chunk launches, "
        f"{st['decode_launches']} plain decode steps")
    log(f"speculative: accepted per verify lane step {st['accepted_per_launch']:.3f} "
        f"({st['spec_tokens']} tokens / {st['spec_lane_steps']} lane steps), draft overhead "
        f"{st['draft_overhead']:.3f} draft lane steps per token, launches per token "
        f"{st['launches_per_token']:.3f}; demotions {st['demotions']}, rehydrations "
        f"{st['rehydrations']}")
    log(f"speculative: launches {counts} = structure {want}")
    if dev == "cuda":
        profile_speculative_step(torch, log, sched, reqs, k3=want["rowquant_matmul"] > 0)
    if built is not None:  # the analysis phase's serving programs, traced on the card
        from repro_torch.analysis import trace_audit
        with torch.inference_mode():
            card_traces(torch, trace_audit.serve_programs(sched.engine, sched.params,
                                                          sched.cache, key, CONT["chunk"]),
                        built)
    del setup, sched
    if dev == "cuda":
        torch.cuda.empty_cache()
    return counts


def profile_speculative_step(torch, log, sched, reqs, k3=True):
    """After the timed run: 4 more greedy requests (64-token prompts, one
    chunk launch for all of them), then one step of draft and verify
    launches under torch.profiler (device busy share, kernel time by name),
    then the queue drained.  No int64 bitwise or shift kernel may appear,
    and the step must run K2, and K3 where the draft's MLP takes it (`k3`)."""
    from repro_torch.serve import Request
    for i, r in enumerate(reqs[:4]):
        sched.submit(Request(rid=f"p{i}", prompt=list(r.prompt[:CONT["chunk"]]),
                             max_new_tokens=12))
    sched.step()  # the chunk launch, then the first window
    with torch.inference_mode():
        prof = profile_train_step(torch, lambda _: sched.step(), None, log, tag="speculative")
        sched.run()
    check(prof["threefry_int64"] == 0, f"speculative: {prof['threefry_int64']} int64 bitwise/"
          "shift kernels in the profiled step")
    check((prof["k3_n"] > 0) == k3 and prof["k2_n"] > 0, f"speculative: the profiled step ran "
          f"K3 {prof['k3_n']} and K2 {prof['k2_n']} times")
    log(f"speculative: profiled step: K1 {prof['k1_n']} ({prof['k1_ms']:.3f} ms), K2 "
        f"{prof['k2_n']} ({prof['k2_ms']:.3f} ms), K3 {prof['k3_n']} ({prof['k3_ms']:.3f} ms); "
        f"int64 elementwise kernels {prof['int64_n']}, of which bitwise/shift "
        f"{prof['threefry_int64']}")


# ---------------------------------------------------------------------------
# phase 7: the MoE family -- olmoe-1b-7b at full width and depth through
# batch, continuous and speculative serving
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
# layers served: olmoe-1b-7b serves at full depth (16 layers) on one card;
# its serving cells run 2 (8, then 4, before) to make room in the
# run's time for the train cells at full depth and the roofline and
# analysis phases (host-bound steps, whose time scales with the layers)
MOE_SERVE_LAYERS = 2


def moe_batch(torch, log, dev="cuda"):
    """olmoe-1b-7b at full width, MOE_SERVE_LAYERS deep, through ``build_serve_setup`` ->
    ``ServeEngine.generate``: SERVE's batch 4 x prompt 128 x 16 greedy
    tokens, run twice after a warm-up.  Gates: the two runs' tokens equal,
    tokens in range, the launches of a run (counts zeroed just before, read
    just after) equal the code's structure (K1 per quantized tensor, K2 per
    layer buffer and the embedding's, per step)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.serve import build_serve_setup, make_prompt_batch

    setup = build_serve_setup(cut_config(MOE_ARCH, MOE_SERVE_LAYERS), smoke=False, device=dev,
                              **SERVE)
    cfg, gen = setup.cfg, SERVE["gen"]
    tokens, _ = SyntheticLM(cfg.vocab_size, SERVE["prompt_len"], SERVE["batch"],
                            seed=SERVE["seed"]).sample(0)
    prompt = make_prompt_batch(cfg, setup.spec, setup.ms, tokens, setup.device)

    def run(n):
        if dev == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = setup.engine.generate(setup.params, prompt, n_tokens=n).cpu()
        return out, time.perf_counter() - t

    run(2)  # warm-up: allocator, cuBLAS handles
    t_prefill = statistics.median(run(1)[1] for _ in range(2))
    ops.reset_launches()
    out1, t1 = run(gen)
    counts = dict(ops.LAUNCHES)
    out2, t2 = run(gen)
    want = expected_launches(setup.model, gen, False)
    nl = cfg.n_layers
    check(want["per_step"] == (7 * nl + 1, nl + 1, 0),
          f"moe batch: per-step K1/K2/K3 {want['per_step']}, the layer holds 7 quantized "
          f"tensors in one buffer")
    check(tuple(out1.shape) == (SERVE["batch"], gen), f"moe batch: tokens shape {out1.shape}")
    check(bool(((out1 >= 0) & (out1 < cfg.vocab_size)).all()), "moe batch: token out of range")
    check(torch.equal(out1, out2), f"moe batch: two runs differ: {out1.tolist()} vs "
          f"{out2.tolist()}")
    for k in ops.KERNELS:
        check(counts[k] == want.get(k, 0), f"moe batch: {k} launched {counts[k]} times, the "
              f"code's structure predicts {want.get(k, 0)}")
    step_ms = sorted((t - t_prefill) / (gen - 1) * 1e3 for t in (t1, t2))
    log(f"moe batch: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.moe_top_k}, {cfg.n_params() / 1e9:.3f} G params, "
        f"{cfg.n_active_params() / 1e9:.3f} G active) {SERVE['batch']}x{gen} tokens: "
        f"runs {t1:.3f} / {t2:.3f} s ({SERVE['batch'] * gen / min(t1, t2):.1f} tok/s); prefill "
        f"{t_prefill * 1e3:.1f} ms; decode step {step_ms[0]:.2f} / {step_ms[1]:.2f} ms")
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else float("nan")
    log(f"moe batch: launches {counts} = per decode step K1/K2/K3 {want['per_step']}; peak "
        f"device memory {peak:.2f} GiB; tokens[0] = {out1[0].tolist()}")
    del setup, prompt
    if dev == "cuda":
        torch.cuda.empty_cache()
    return counts


def moe_phase(torch, log, dev="cuda"):
    """The MoE family on the card: olmoe-1b-7b's smoke config card vs CPU
    (``small_phase``), then at full width cut to MOE_SERVE_LAYERS of its 16
    layers (64 experts top-8, random weights from seed 0, default
    QSDPConfig) batch serving
    (``moe_batch``), the continuous phase's cell (CONT, CONT_PLAN: two runs,
    solo gates, pool, launches, a profiled step) and the speculative phase's
    (a 4-bit draft of depth 4, whose expert stacks K2 decodes), and the
    fixed-shape route's row gate at the MoE launch shapes.  Prints the
    phase's seconds and its peak device memory.  Returns the launches of the
    driven paths (the small phase's and the gates' are not counted)."""
    from collections import Counter
    from repro_torch import configs
    t0 = time.perf_counter()
    if dev == "cuda":
        small_phase(torch, log, MOE_ARCH)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    counts = Counter(moe_batch(torch, log, dev))
    cfg = cut_config(MOE_ARCH, MOE_SERVE_LAYERS)
    counts.update(continuous_phase(torch, log, dev, profile=dev == "cuda", arch=cfg))
    counts.update(speculative_phase(torch, log, dev, arch=cfg))
    g = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    route_invariance(torch, log, dev, rnd, configs.get_config(MOE_ARCH))
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else float("nan")
    if dev == "cuda":
        torch.cuda.empty_cache()
    log(f"moe: phase {time.perf_counter() - t0:.1f} s, peak device memory {peak:.2f} GiB; "
        f"launches {dict(counts)}")
    return dict(counts)


# ---------------------------------------------------------------------------
# phase 7b: the SSM and hybrid families -- mamba2-370m and zamba2-7b at full
# width and depth through batch and continuous serving
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2-370m", "zamba2-7b")
# layers served: both models serve at full depth (48 and 81 layers) on one
# card; the serving cells are cut to 6 of mamba2-370m's 48 layers (24,
# then 12, before) and 15 of zamba2-7b's 81 (two groups of 6 Mamba2
# layers, each followed by the shared block, so its decode keeps two KV
# rings, and the 3-layer tail; 27 before)
# to make room in the run's time for the train cells at full depth and the
# roofline phase.  The steps are host-bound: their time scales with the
# layers
SSM_SERVE_LAYERS = {"mamba2-370m": 6, "zamba2-7b": 15}
# the reference's rowquant test config for the hybrid family
# (tests/test_kernel_dispatch.py:206): buckets of 128 tile the smoke shared
# MLP's rows, so its decode runs K3
SSM_RQ_QSDP = dict(min_quant_size=256, bucket_size=128)
# K1/K2/K3 launches of a whole-prompt prefill and of one decode step of the
# models served at full width (the ssm and vlmaudio phases, at the depths
# they serve), counted by hand from the configs, by (name, rowquant).
# mamba2-370m at 6 layers / zamba2-7b at 15: the embedding (K1 + K2), 5
# quantized Mamba2 weights in one buffer per layer, and for zamba2-7b 2
# shared-block invocations of 7 quantized weights in one buffer each; under
# rowquant the decode step's shared w_gate/w_up go through K3
# and w_down (3,584 columns: 3.5 buckets of 1,024) is gathered alone through
# K2.  qwen2-vl-72b at 2 layers: the embedding and 7 quantized weights a
# layer (its 3 biases and 2 norms ride the layer's buffer unquantized), one
# buffer a layer; under rowquant w_down goes through K3 and w_gate/w_up
# (29,568 columns: 28.875 buckets of 1,024) are gathered alone through K2.
# seamless-m4t-large-v2 at 3 + 3 layers: the embedding and the untied
# lm_head; prefill also gathers the encoder's 3 layers of 7 quantized
# weights; a decoder layer
# holds 11 (self- and cross-attention, MLP), one buffer each; under rowquant
# its MLP goes through K3
_MAMBA2 = (1 + 5 * 6, 1 + 6, 0)
_ZAMBA2 = (1 + 5 * 15 + 7 * 2, 1 + 15 + 2, 0)
_QWEN2VL = (1 + 7 * 2, 1 + 2, 0)
_SEAMLESS = (2 + 7 * 3 + 11 * 3, 2 + 3 + 3, 0)
SERVE_PER_STEP = {
    ("mamba2-370m", False): {"prefill": _MAMBA2, "step": _MAMBA2},
    ("zamba2-7b", False): {"prefill": _ZAMBA2, "step": _ZAMBA2},
    ("zamba2-7b", True): {"prefill": _ZAMBA2, "step": (1 + 5 * 15 + 7 * 2, 1 + 15 + 2 * 2,
                                                       2 * 2)},
    ("qwen2-vl-72b", False): {"prefill": _QWEN2VL, "step": _QWEN2VL},
    ("qwen2-vl-72b", True): {"prefill": _QWEN2VL, "step": (1 + 7 * 2, 1 + 2 * 3, 2)},
    ("seamless-m4t-large-v2", False): {"prefill": _SEAMLESS, "step": (2 + 11 * 3, 2 + 3, 0)},
    ("seamless-m4t-large-v2", True): {"prefill": _SEAMLESS,
                                      "step": (2 + 11 * 3, 2 + 3, 3 * 3)}}


def serve_family(cfg) -> str:
    """The phase that serves `cfg`'s family at full size: its log tag."""
    return "ssm" if cfg.arch_type in ("ssm", "hybrid") else "vlmaudio"


def expected_serve_launches(model, rowquant: bool) -> dict:
    """The launch formula of `model`'s family (``expected_ssm_launches`` or
    ``expected_mm_launches``)."""
    fn = expected_ssm_launches if serve_family(model.cfg) == "ssm" else expected_mm_launches
    return fn(model, rowquant)


def expected_ssm_launches(model, rowquant: bool) -> dict:
    """K1/K2/K3 launches of one whole-prompt prefill and one decode step of
    an SSM/hybrid model by the code's structure: K1 once per quantized
    tensor per gather (the shared block's at each of its n_layers // every
    invocations); K2 once per gathered buffer holding a quantized tensor
    (the embedding's, each layer's, each shared invocation's); with rowquant
    the decode step's shared MLP weights go through K3 where their buckets
    tile their rows and are gathered alone through K2 where not."""
    from repro_torch.kernels import ops
    from repro_torch.models.decode import ROWQUANT_MLP
    eng, cfg = model.engine, model.cfg
    groups = cfg.n_layers // cfg.hybrid_attn_every if cfg.arch_type == "hybrid" else 0
    q = [n for n, sp in eng.specs.items() if eng._is_quantized(sp)]
    top = [n for n in q if "/" not in n]
    layer = [n for n in q if n.startswith("layers/")]
    shared = [n for n in q if n.startswith("shared/")]
    rq = [n for n in shared if rowquant and n.split("/")[-1] in ROWQUANT_MLP]
    rq_ok = [n for n in rq if eng.rowquant_eligible(n)]

    def bufs(k):
        return -(-k // ops.WIRE_MAX_SEGS)

    k1 = len(top) + cfg.n_layers * len(layer) + groups * len(shared)
    k2 = len(top) + cfg.n_layers * bufs(len(layer))
    return {"prefill": (k1, k2 + groups * bufs(len(shared)), 0),
            "step": (k1, k2 + groups * (bufs(len(shared) - len(rq)) + len(rq) - len(rq_ok)),
                     groups * len(rq_ok))}


def serve_batch(torch, log, arch, dev="cuda", rowquant=False, params=None, prompt_fn=None):
    """`arch` (a registry name, served at full width and depth, or a
    ModelConfig) through ``build_serve_setup`` -> ``ServeEngine.generate``:
    SERVE's batch 4 x prompt 128 x 16 greedy tokens, run twice after a
    warm-up, on the weights `params` (drawn from seed 0 when None), the
    prompt batch ``prompt_fn(setup, tokens)`` (default
    ``make_prompt_batch``).  Gates: the two runs' tokens equal and in range,
    the logits finite, the launches of a run (counts zeroed just before,
    read just after) equal the code's structure
    (``expected_serve_launches``) and, where SERVE_PER_STEP has the config,
    the hand count.
    Returns (launches, params, the first decode step's logits)."""
    import repro_torch.models.layers as L
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.serve import build_serve_setup, make_prompt_batch

    setup = build_serve_setup(arch, smoke=False, device=dev, rowquant_mlp=rowquant,
                              params=params, **SERVE)
    cfg, gen = setup.cfg, SERVE["gen"]
    kind = serve_family(cfg)
    tag = f"{cfg.name} {'rowquant' if rowquant else 'dense'}"
    tokens, _ = SyntheticLM(cfg.vocab_size, SERVE["prompt_len"], SERVE["batch"],
                            seed=SERVE["seed"]).sample(0)
    prompt = (prompt_fn(setup, tokens) if prompt_fn is not None else
              make_prompt_batch(cfg, setup.spec, setup.ms, tokens, setup.device))

    def run(n):
        if dev == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = setup.engine.generate(setup.params, prompt, n_tokens=n).cpu()
        return out, time.perf_counter() - t

    run(2)  # warm-up: allocator, cuBLAS and cuDNN handles
    t_prefill = statistics.median(run(1)[1] for _ in range(2))
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    logits = []
    ops.reset_launches()
    with hooked(L, "vocab_parallel_logits", capture_logits(logits)):
        out1, t1 = run(gen)
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else float("nan")
    out2, t2 = run(gen)
    want = expected_serve_launches(setup.model, rowquant)
    pf, st = want["prefill"], want["step"]
    hand = SERVE_PER_STEP.get((cfg.name, rowquant), want)
    check(want == hand, f"{tag}: K1/K2/K3 by the structure {want}, by hand {hand}")
    check(tuple(out1.shape) == (SERVE["batch"], gen), f"{tag}: tokens shape {out1.shape}")
    check(bool(((out1 >= 0) & (out1 < cfg.vocab_size)).all()), f"{tag}: token out of range")
    check(all(bool(torch.isfinite(t).all()) for t in logits) and len(logits) == gen,
          f"{tag}: {len(logits)} logit sets, or non-finite logits")
    check(torch.equal(out1, out2), f"{tag}: two runs differ: {out1.tolist()} vs {out2.tolist()}")
    for k, i in (("quantize_pack", 0), ("unpack_dequantize", 1), ("rowquant_matmul", 2)):
        n = pf[i] + st[i] * (gen - 1)
        check(counts[k] == n, f"{tag}: {k} launched {counts[k]} times, the code's structure "
              f"predicts {n}")
    check(sum(counts.values()) == sum(pf) + sum(st) * (gen - 1),
          f"{tag}: launches of other kernels: {counts}")
    step_ms = sorted((t - t_prefill) / (gen - 1) * 1e3 for t in (t1, t2))
    log(f"{kind} batch {tag}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_params() / 1e9:.4f} G params, {SERVE['batch']}x{gen} tokens: runs "
        f"{t1:.3f} / {t2:.3f} s ({SERVE['batch'] * gen / min(t1, t2):.1f} tok/s); prefill "
        f"{t_prefill * 1e3:.1f} ms; decode step {step_ms[0]:.2f} / {step_ms[1]:.2f} ms; peak "
        f"device memory {peak:.2f} GiB")
    log(f"{kind} batch {tag}: launches {counts} = prefill K1/K2/K3 {pf} + {gen - 1} x per decode "
        f"step {st}; tokens[0] = {out1[0].tolist()}")
    params = setup.params
    del setup, prompt
    if dev == "cuda":
        torch.cuda.empty_cache()
    return counts, params, logits[1].float()


def serve_continuous(torch, log, arch, params, dev="cuda", profile=True):
    """`arch` (a registry name, served at full width and depth, or a
    ModelConfig) through ``make_scheduler`` with blocking admission (the
    reference's only admission for the SSM, hybrid, VLM and audio
    families): 4 slots, ring 512 (none for the SSM family), CONT_PLAN's 12
    requests (prompts 32-384, half sampled), every launch on the fixed-shape
    route, on the weights `params`; launches by
    ``expected_serve_launches``.  Run 1 (one pooled decode step with a sampled lane profiled: busy share; no int64 bitwise or
    shift kernel) and run 2 (counts zeroed just before, read just after,
    against the structure; timed) give every request the same tokens; every
    greedy request equals its batch-of-1 solo run (``generate(
    fold_step_keys=False)``, whole-prompt prefill)."""
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.kernels import ops
    from repro_torch.serve import build_serve_setup, make_scheduler

    gen_max = max(g for *_, g in CONT_PLAN)
    setup = route_setup(build_serve_setup(
        arch, smoke=False, batch=CONT["slots"], prompt_len=CONT["ring"] - gen_max, gen=gen_max,
        seed=CONT["seed"], sampling=True, device=dev, params=params))
    cfg = setup.cfg
    kind = serve_family(cfg)
    check(setup.spec.cache_len == (0 if cfg.arch_type == "ssm" else CONT["ring"]),
          f"ring {setup.spec.cache_len}")
    reqs = continuous_requests(cfg.vocab_size)
    key = prng.PRNGKey(CONT["seed"])

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def run(profile_step):
        sched = make_scheduler(setup, gather_key=key)
        launches = {"prefill": [], "decode": []}
        steps, prof = [], None
        hooks = [(sched.prefill_engine, "prefill_step",
                  launch_timer(torch, launches["prefill"], dev)),
                 (sched.engine, "decode_step", launch_timer(torch, launches["decode"], dev))]
        sync()
        with contextlib.ExitStack() as stack:
            for h in hooks:
                stack.enter_context(hooked(*h))
            for r in reqs:
                sched.submit(r)
            t0 = time.perf_counter()
            while sched.queue or sched.n_active():
                if (profile_step and prof is None and not sched.queue
                        and any(s is not None and s.req.needs_sampling for s in sched.slots)):
                    prof = profile_train_step(torch, lambda _: sched.step(), None, log,
                                              tag=f"{kind} continuous {cfg.name}")
                    continue
                prefills = sched.prefill_count
                t = time.perf_counter()
                sched.step()
                steps.append((time.perf_counter() - t, sched.prefill_count > prefills))
            sync()
            wall = time.perf_counter() - t0
        return sched, {r: c.tokens.tolist() for r, c in sched.finished.items()}, steps, prof, \
            wall, launches

    with torch.inference_mode():
        _, out1, _, prof, _, _ = run(profile and dev == "cuda")
        ops.reset_launches()
        s2, out2, steps, _, wall, launch_s = run(False)
        counts = dict(ops.LAUNCHES)
    st = s2.stats()
    tag = f"{kind} continuous {cfg.name}"
    check(out1 == out2, f"{tag}: two runs gave different tokens: "
          + str(sorted(r for r in out1 if out1[r] != out2.get(r))))
    check(set(out2) == {r.rid for r in reqs}, f"{tag}: not every request finished")
    for r in reqs:
        check(len(out2[r.rid]) == r.max_new_tokens
              and all(0 <= t < cfg.vocab_size for t in out2[r.rid]), f"{tag} {r.rid}: tokens "
              f"{out2[r.rid]}")
    check(st["prefills"] == len(reqs) and st["prefill_chunks"] == 0,
          f"{tag}: {st['prefills']} prefills, {st['prefill_chunks']} chunk launches")
    want = expected_serve_launches(setup.model, False)
    pf, sp = want["prefill"], want["step"]
    want_n = {"quantize_pack": pf[0] * st["prefills"] + sp[0] * st["decode_launches"],
              "unpack_dequantize": pf[1] * st["prefills"] + sp[1] * st["decode_launches"],
              "random_bits": st["sampled_launches"]}
    for k in ops.KERNELS:
        check(counts[k] == want_n.get(k, 0), f"{tag}: {k} launched {counts[k]} times, the "
              f"code's structure predicts {want_n.get(k, 0)}")
    check(all(v > 0 for v in want_n.values()), f"{tag}: a kernel never launched: {counts}")
    if prof is not None:
        check(prof["threefry_int64"] == 0, f"{tag}: {prof['threefry_int64']} int64 bitwise/"
              "shift kernels in the profiled step")
        check(prof["rb_n"] >= 1, f"{tag}: no random_bits launch in the profiled step")
    greedy = [r for r in reqs if not r.needs_sampling]
    solo = solo_runs(torch, setup, greedy, key, chunk=0)
    for rid, ref in solo.items():
        check(ref == out2[rid], f"{tag} {rid}: scheduler tokens {out2[rid]} != batch-of-1 solo "
              f"run {ref} (first difference at token "
              f"{next((i for i, (a, b) in enumerate(zip(ref, out2[rid])) if a != b), None)})")
    pct = (lambda a, q: float(np.percentile(a, q)) if a else float("nan"))
    ttft = sorted(c.first_token_time - c.submit_time for c in s2.finished.values())
    dec = sorted(t for t, admitted in steps if not admitted)
    log(f"{tag}: {len(solo)} greedy requests bit-equal to their batch-of-1 solo runs "
        f"({sorted(solo)}); sampled {[r.rid for r in reqs if r.needs_sampling]} equal across "
        "two runs")
    ring = {"ssm": "", "hybrid": f", shared-block ring {CONT['ring']}"}.get(
        cfg.arch_type, f", ring {CONT['ring']}")
    enc = f", cross KV of {setup.spec.enc_len} frames" if setup.spec.enc_len else ""
    log(f"{tag}: {len(reqs)} requests on {CONT['slots']} slots (blocking admission"
        f"{ring}{enc}): "
        f"{st['tokens_generated']} tokens in {wall:.3f} s = {st['tokens_generated'] / wall:.2f} "
        f"tokens/s; TTFT p50 {pct(ttft, 50):.3f} s, p95 {pct(ttft, 95):.3f} s; decode-only "
        f"step median {1e3 * pct(dec, 50):.2f} ms (p95 {1e3 * pct(dec, 95):.2f}, {len(dec)} "
        f"steps); prefill launch median {1e3 * pct(launch_s['prefill'], 50):.2f} ms (max "
        f"{1e3 * max(launch_s['prefill']):.2f}); occupancy {st['mean_occupancy']:.3f}")
    log(f"{tag}: stats {st}")
    log(f"{tag}: launches {counts} = structure {want_n}")
    if prof is not None:
        log(f"{tag}: profiled decode step: {prof['kernels']} kernels, busy "
            f"{prof['busy_ms']:.1f} of {prof['wall_ms']:.1f} ms "
            f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%); K1 {prof['k1_n']} "
            f"({prof['k1_ms']:.3f} ms), K2 {prof['k2_n']} ({prof['k2_ms']:.3f} ms), "
            f"random_bits {prof['rb_n']}")
    del setup, s2
    if dev == "cuda":
        torch.cuda.empty_cache()
    return counts


def small_rowquant(torch, log, dev="cuda", arch="zamba2-7b"):
    """`arch`'s smoke config (zamba2's or seamless's) under SSM_RQ_QSDP on
    `dev`: the rowquant decode (zamba2: the shared MLP, seamless: the
    decoder MLP, through K3) gives the dense decode's greedy tokens (the
    reference's ``test_serve_rowquant_decode_audio_hybrid``)."""
    from repro_torch.core.qsdp import QSDPConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import build_serve_setup, make_prompt_batch
    outs, params = {}, None
    tokens = torch.ones((SMALL["batch"], SMALL["prompt_len"]), dtype=torch.int64)
    for rowquant in (False, True):
        setup = build_serve_setup(arch, smoke=True, qsdp=QSDPConfig(**SSM_RQ_QSDP),
                                  rowquant_mlp=rowquant, device=dev, params=params, **SMALL)
        params = setup.params
        prompt = make_prompt_batch(setup.cfg, setup.spec, setup.ms, tokens, dev)
        ops.reset_launches()
        outs[rowquant] = setup.engine.generate(params, prompt, n_tokens=5).cpu()
        k3 = ops.LAUNCHES["rowquant_matmul"]
        check((k3 > 0) == rowquant or dev != "cuda", f"small {setup.cfg.name} "
              f"rowquant={rowquant}: K3 launched {k3} times")
    name = setup.cfg.name
    check(torch.equal(outs[False], outs[True]), f"small {name}: rowquant tokens "
          f"{outs[True].tolist()} != dense {outs[False].tolist()}")
    log(f"small: {name} rowquant decode ({'decoder' if setup.cfg.arch_type == 'audio' else 'shared'}"
        f" MLP through K3) == dense decode, tokens {outs[True].tolist()}")


def ssm_phase(torch, log, dev="cuda", archs=SSM_ARCHS):
    """The SSM and hybrid families on the card: both smoke configs card vs
    CPU (``small_phase``) and zamba2's rowquant smoke decode equal to its
    dense one; then mamba2-370m (6 of 48 layers) and zamba2-7b (15 of 81
    layers: two groups of 6 Mamba2 layers, each followed by the shared
    attention+MLP block, and a tail of 3) at full width (SSM_SERVE_LAYERS),
    random weights from seed 0, default QSDPConfig: batch serving (dense, and for zamba2 also
    rowquant), the continuous cell with blocking admission, and the
    fixed-shape route's row gate at their launch shapes.  Prints the
    phase's seconds and peak device memory.  Returns the launches of the
    driven paths (the small phase's and the gates' are not counted)."""
    from collections import Counter
    from repro_torch import configs
    t0 = time.perf_counter()
    with phase_peak(torch, dev) as peak:
        if dev == "cuda":
            for arch in archs:
                small_phase(torch, log, arch)
            small_rowquant(torch, log)
            torch.cuda.empty_cache()
        counts = Counter()
        g = torch.Generator(device=dev).manual_seed(4)

        def rnd(*shape, dt=torch.bfloat16):
            return torch.randn(shape, generator=g, device=dev).to(dt)

        for arch in archs:
            cfg = cut_config(arch, SSM_SERVE_LAYERS.get(arch))
            c, params, first = serve_batch(torch, log, cfg, dev)
            counts.update(c)
            if cfg.arch_type == "hybrid":
                c, params, first_rq = serve_batch(torch, log, cfg, dev, rowquant=True,
                                                  params=params)
                counts.update(c)
                rel = (first - first_rq).abs().max().item() / first.abs().max().item()
                check(math.isfinite(rel) and rel <= LOGIT_RTOL,
                      f"{arch}: first decode step logits dense vs rowquant differ by "
                      f"{rel:.3e} of max |logit|")
                log(f"ssm batch {arch}: first decode step logits dense vs rowquant: max "
                    f"|diff| / max |logit| = {rel:.3e} (tol {LOGIT_RTOL})")
            counts.update(serve_continuous(torch, log, cfg, params, dev))
            del params
            route_invariance(torch, log, dev, rnd, configs.get_config(arch))
            if dev == "cuda":
                torch.cuda.empty_cache()
        log(f"ssm: phase {time.perf_counter() - t0:.1f} s, peak device memory {peak():.2f} "
            f"GiB; launches {dict(counts)}")
    return dict(counts)


# ---------------------------------------------------------------------------
# phase 7c: the VLM and audio families served
# ---------------------------------------------------------------------------

MM_ARCHS = ("qwen2-vl-72b", "seamless-m4t-large-v2")
# layers served: qwen2-vl-72b's 80 layers hold 286 GB of f32 rest weights,
# 16 of them 61.2 GB (15.29 G parameters with the embedding), which one
# card serves, as it serves seamless-m4t-large-v2 (2.04 G) at full depth;
# the cells run qwen2-vl at 2 layers and seamless at 3 decoder and 3
# encoder layers (8 and 12 + 12 before), to make room in the run's
# time for the train cells at full depth
MM_LAYERS = {"qwen2-vl-72b": 2, "seamless-m4t-large-v2": 3}
# the image block of the VLM batch cell's prompts: an 8 x 8 grid of patch
# embeddings (random bf16, scale 0.02) at prompt positions 16-79, with
# Qwen2-VL's (t, h, w) positions (t = 16, h = 16 + row, w = 16 + col); the
# text after it continues from 16 + 8 = 24 in all three streams
MM_IMAGE = dict(start=16, rows=8, cols=8, scale=0.02, seed=6)
# the smoke configs' card-vs-CPU checks (vlmaudio, mmtrain): a 2 x 4 grid at
# positions 4-11
MM_SMALL_IMAGE = dict(MM_IMAGE, start=4, rows=2, cols=4)


def expected_mm_launches(model, rowquant: bool) -> dict:
    """K1/K2/K3 launches of one whole-prompt prefill and one decode step of
    a VLM or audio model by the code's structure: K1 once per quantized
    tensor gathered (prefill: every stack, the audio encoder's included;
    decode: the decoder's); K2 once per gathered buffer holding a quantized
    tensor (the top-level tensors each alone, a layer's in one); with
    rowquant the decode MLP weights go through K3 where their buckets tile
    their rows and are gathered alone through K2 where not."""
    from repro_torch.kernels import ops
    from repro_torch.models.decode import ROWQUANT_MLP
    eng, cfg = model.engine, model.cfg
    q = [n for n, sp in eng.specs.items() if eng._is_quantized(sp)]
    top = [n for n in q if "/" not in n]
    stacks = ({"enc": cfg.n_enc_layers, "dec": cfg.n_layers} if cfg.arch_type == "audio"
              else {"layers": cfg.n_layers})
    decoded = "dec" if cfg.arch_type == "audio" else "layers"

    def group(g):
        return [n for n in q if n.startswith(g + "/")]

    def bufs(k):
        return -(-k // ops.WIRE_MAX_SEGS)

    lay = group(decoded)
    rq = [n for n in lay if rowquant and n.split("/")[-1] in ROWQUANT_MLP]
    rq_ok = [n for n in rq if eng.rowquant_eligible(n)]
    nl = stacks[decoded]
    return {"prefill": (len(top) + sum(n * len(group(g)) for g, n in stacks.items()),
                        len(top) + sum(n * bufs(len(group(g))) for g, n in stacks.items()), 0),
            "step": (len(top) + nl * len(lay),
                     len(top) + nl * (bufs(len(lay) - len(rq)) + len(rq) - len(rq_ok)),
                     nl * len(rq_ok))}


def vlm_image_prompt(torch, cfg, spec, ms, tokens, dev, start, rows, cols, scale, seed):
    """The VLM prompt batch with one image block: ``make_prompt_batch``'s
    stubs, then rows x cols patch embeddings (random bf16 at `scale`, drawn
    on the host from `seed`) spliced at prompt positions start .. start +
    rows * cols - 1 (``vision_mask`` set), with Qwen2-VL's (t, h, w)
    positions t = start, h = start + row, w = start + col; the text after
    the block continues from start + max(rows, cols) in all three streams."""
    from repro_torch.serve import make_prompt_batch
    b = make_prompt_batch(cfg, spec, ms, tokens, "cpu")
    n_tok, s = b["tokens"].shape
    n = rows * cols
    end = start + n
    g = torch.Generator().manual_seed(seed)
    emb = b["vision_embeds"].clone()
    emb[:, start:end] = (torch.randn((n_tok, n, cfg.d_model), generator=g) * scale).to(
        torch.bfloat16)
    mask = b["vision_mask"].clone()
    mask[:, start:end] = True
    pos = torch.arange(s).repeat(3, 1)
    r, c = torch.arange(n) // cols, torch.arange(n) % cols
    pos[0, start:end] = start
    pos[1, start:end] = start + r
    pos[2, start:end] = start + c
    pos[:, end:] = torch.arange(s - end) + start + max(rows, cols)
    b.update(vision_embeds=emb, vision_mask=mask,
             positions=pos[:, None, :].expand(3, n_tok, s).contiguous())
    return {k: v.to(dev) for k, v in b.items()}


def cut_config(arch, layers):
    """`arch`'s full config, cut to `layers` layers where that is fewer (an
    encoder-decoder's encoder too)."""
    from repro_torch import configs
    cfg = configs.get_config(arch)
    if not layers or layers >= cfg.n_layers:
        return cfg
    enc = {"n_enc_layers": min(layers, cfg.n_enc_layers)} if cfg.arch_type == "audio" else {}
    return dataclasses.replace(cfg, n_layers=layers, **enc)


def mm_config(arch):
    """`arch`'s full config at the depth one card serves (MM_LAYERS)."""
    return cut_config(arch, MM_LAYERS.get(arch))


def small_vlm_image(torch, log, dev="cuda"):
    """qwen2-vl's smoke config card vs CPU (``small_phase``'s gates) on a
    prompt with an image block: a 2 x 4 patch grid at positions 4-11, so the
    splice and the per-row M-RoPE tables run on the card."""
    def prompt(setup, tokens):
        return vlm_image_prompt(torch, setup.cfg, setup.spec, setup.ms, tokens, setup.device,
                                **MM_SMALL_IMAGE)
    small_phase(torch, log, "qwen2-vl-72b", prompt_fn=prompt)


def vlmaudio_phase(torch, log, dev="cuda", archs=MM_ARCHS):
    """The VLM and audio families on the card: both smoke configs card vs
    CPU (``small_phase``; qwen2-vl's on a prompt with an image block) and
    seamless's rowquant smoke decode equal to its dense one; then
    qwen2-vl-72b and seamless-m4t-large-v2 at full width cut to MM_LAYERS
    (2 of 80 layers; 3 of 24 decoder and encoder layers), random weights from seed
    0, default QSDPConfig: batch serving dense and rowquant (qwen2-vl's
    prompts carry MM_IMAGE's image block; seamless's the reference's audio
    stub of prompt // 2 = 64 frames), their first decode steps' logits
    within LOGIT_RTOL, launches by the structure and the hand count
    (SERVE_PER_STEP); the continuous cell with blocking admission (CONT_PLAN,
    requests equal to their batch-of-1 solo runs, one profiled decode
    step); the fixed-shape route's row gate at their launch shapes (the
    audio decoder's cross-attention included).  Prints the phase's seconds
    and peak device memory.  Returns the launches of the driven paths."""
    from collections import Counter
    t0 = time.perf_counter()
    with phase_peak(torch, dev) as peak:
        if dev == "cuda":
            for arch in archs:
                if arch == "qwen2-vl-72b":
                    small_vlm_image(torch, log, dev)
                else:
                    small_phase(torch, log, arch)
            if "seamless-m4t-large-v2" in archs:
                small_rowquant(torch, log, dev, arch="seamless-m4t-large-v2")
            torch.cuda.empty_cache()
        counts = Counter()
        g = torch.Generator(device=dev).manual_seed(7)

        def rnd(*shape, dt=torch.bfloat16):
            return torch.randn(shape, generator=g, device=dev).to(dt)

        def image(setup, tokens):
            return vlm_image_prompt(torch, setup.cfg, setup.spec, setup.ms, tokens, setup.device,
                                    **MM_IMAGE)

        for arch in archs:
            cfg = mm_config(arch)
            prompt_fn = image if cfg.arch_type == "vlm" else None
            c, params, first = serve_batch(torch, log, cfg, dev, prompt_fn=prompt_fn)
            counts.update(c)
            c, params, first_rq = serve_batch(torch, log, cfg, dev, rowquant=True, params=params,
                                              prompt_fn=prompt_fn)
            counts.update(c)
            rel = (first - first_rq).abs().max().item() / first.abs().max().item()
            check(math.isfinite(rel) and rel <= LOGIT_RTOL,
                  f"{cfg.name}: first decode step logits dense vs rowquant differ by "
                  f"{rel:.3e} of max |logit|")
            log(f"vlmaudio batch {cfg.name}: first decode step logits dense vs rowquant: max "
                f"|diff| / max |logit| = {rel:.3e} (tol {LOGIT_RTOL})")
            counts.update(serve_continuous(torch, log, cfg, params, dev))
            del params
            if dev == "cuda":
                torch.cuda.empty_cache()
            route_invariance(torch, log, dev, rnd, cfg)
            if dev == "cuda":
                torch.cuda.empty_cache()
        log(f"vlmaudio: phase {time.perf_counter() - t0:.1f} s, peak device memory "
            f"{peak():.2f} GiB; launches {dict(counts)}")
    return dict(counts)


# ---------------------------------------------------------------------------
# phase 3b: small training input, card against CPU
# ---------------------------------------------------------------------------

SMALL_TRAIN = dict(batch=4, seq=32, n_micro=2, steps=2, seed=0)
# f32 compute from the same state: step 1's loss differs by summation order
# only (~1e-7 relative); step 2 also carries the few gradient codes that
# flip where cuBLAS and the CPU round a cotangent to the other side of a
# stochastic-rounding threshold (between the JAX package and the port on
# the CPU the second loss agrees to ~1e-5 relative)
SMALL_LOSS_RTOL = 1e-4


def small_train_phase(torch, log):
    """2 train steps of the gpt-1.3b smoke config (f32 compute) on the card
    and on the CPU from the same state: every gathered weight of step 1
    (forward and backward replay) byte-equal, losses within
    SMALL_LOSS_RTOL.  The gradient codes themselves may differ (see
    SMALL_LOSS_RTOL), so step 2's gathers are not compared."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, make_adamw
    from repro_torch.train.checkpoint import state_from_flat, state_to_flat
    from repro_torch.train.step import build_train_step, init_train_state

    cfg = configs.get_smoke("gpt-1.3b")
    model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig(compute_dtype="float32"))
    opt = make_adamw(AdamWConfig(lr=1e-3))
    flat = state_to_flat(init_train_state(model, opt, SMALL_TRAIN["seed"], "cpu"))
    data = SyntheticLM(cfg.vocab_size, SMALL_TRAIN["seq"], SMALL_TRAIN["batch"],
                       seed=SMALL_TRAIN["seed"])
    res = {}
    for dev in ("cuda", "cpu"):
        state = state_from_flat(*flat, device=dev)
        step = build_train_step(model, opt, n_micro=SMALL_TRAIN["n_micro"], device=dev)
        gathers, losses = {}, []
        for i in range(SMALL_TRAIN["steps"]):
            hook = capture_gathers(model, gathers) if i == 0 else (lambda orig: orig)
            with hooked(model.engine, "_reshape_full", hook):
                state, m = step(state, make_batch(data, i, dev), prng.fold_in(prng.PRNGKey(1), i))
            losses.append(float(m["loss"]))
        res[dev] = (losses, gathers)
    (lc, gc), (lp, gp) = res["cuda"], res["cpu"]
    check(gc == gp, "small train: gathered weight bytes differ between card and CPU")
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    check(all(map(math.isfinite, lc)) and rel <= SMALL_LOSS_RTOL,
          f"small train: losses {lc} (card) vs {lp} (CPU), rel diff {rel:.2e}")
    log(f"small train: gpt-1.3b smoke, 2 steps on card == CPU: "
        f"{sum(map(len, gc.values()))} step-1 gathers byte-equal, losses {lc} vs {lp} "
        f"(max rel diff {rel:.2e}, tol {SMALL_LOSS_RTOL})")


# ---------------------------------------------------------------------------
# phase 8: gpt-1.3b training
# ---------------------------------------------------------------------------

TRAIN = dict(batch=4, seq=2048, n_micro=2, seed=0, lr=6e-4, warmup=10, total=100)
TRAIN_TIMED = 3   # timed steps after one warm-up step
# gpt-1.3b's remat "dots" run: timed steps after its warm-up (it ran
# TRAIN_TIMED until the train cells at full depth needed the time)
DOTS_TIMED = 1
QSTATE_STEPS = 2  # quantized_state vs quantize_master
# random init at 0.02: the first loss is close to ln(vocab)
FIRST_LOSS_ATOL = 0.5


def shared_invocations(cfg) -> int:
    """Invocations of the hybrid's shared block in one forward pass."""
    return cfg.n_layers // cfg.hybrid_attn_every if cfg.arch_type == "hybrid" else 0


def gather_groups(model) -> list[tuple[tuple[str, ...], int, int, int]]:
    """Each group of params one gather takes (a stack's layer, a block's
    invocation, a top-level tensor), with the times a forward pass gathers
    it, the times the backward replays that gather and the times the
    backward only decodes a wire buffer the forward gathered: a stack's
    layers each, in a loop that runs the prefetch pipeline
    (``Model.pipelined``) decoded and otherwise replayed, a block's
    invocations replayed, a top-level tensor once and outside every
    checkpoint (no replay)."""
    eng = model.engine
    inv = shared_invocations(model.cfg)
    groups = {}
    for n in eng.specs:
        groups.setdefault(n.rsplit("/", 1)[0] if "/" in n else n, []).append(n)
    out = []
    for prefix, names in groups.items():
        s = eng.specs[names[0]]
        if s.stack is not None:
            loops = model.stack_traversals(prefix)
            decodes = sum(n for n in loops if model.pipelined(prefix, n))
            out.append((tuple(sorted(names)), s.stack, s.stack - decodes, decodes))
            continue
        times = inv if "/" in names[0] else 1
        out.append((tuple(sorted(names)), times, times if "/" in names[0] else 0, 0))
    return out


def expected_train_comm(model, n_micro: int) -> dict:
    """Calls into torch.distributed of one train step over a group, by op,
    by the code's structure: per microbatch one all-gather per coalesced
    gather, forward and replay (per tensor: three for a quantized tensor,
    one for an fp one: ``layer_gather_launches``; a prefetched layer's
    backward decodes the buffer its forward gathered), and for each group's
    gradients one all-to-all when coalesced, else three per quantized
    tensor and one fp reduce-scatter per fp tensor; then one all-reduce
    each for the grad norm and the loss."""
    from repro_torch.core.qsdp import layer_gather_launches
    eng = model.engine
    calls = dict(all_gather=0, all_to_all=0, reduce_scatter=0)
    for names, times, replays, _ in gather_groups(model):
        calls["all_gather"] += (times + replays) * layer_gather_launches(eng, names)
        if eng.layer_coalesced(names):
            calls["all_to_all"] += times
            continue
        for n in names:
            q = eng._is_grad_quantized(eng.specs[n])
            calls["all_to_all" if q else "reduce_scatter"] += times * (3 if q else 1)
    return {**{k: n_micro * v for k, v in calls.items()}, "all_reduce": 2}


def expected_train_launches(model, n_micro: int, moments: bool = False) -> dict:
    """K1/K2 launches of one train step by the code's structure.  Per
    microbatch: the forward gathers every quantized tensor once per use
    (embed at the top, each layer inside its checkpoint, the hybrid's shared
    block inside its own checkpoint at each of its invocations), the
    backward re-gathers every checkpointed buffer once more (the checkpoint
    replays the gather, under remat "dots" too) but for a prefetched
    layer's, which it only decodes again (K2, no K1: the wire buffer is an
    input of the layer's checkpoint), and every gather's
    gradient-quantized tensors are reduce-scattered once (the shared block's
    once per invocation, the reduce-scatters summed).  K1 encodes each
    quantized tensor of a gather or reduce-scatter; K2 decodes each buffer
    that holds one, in one launch (the final norm's buffers hold fp payloads
    only).  The prefetch pipeline issues no wrapped-around gather (ROADMAP
    C5), so it adds no launch.  With `moments` (Adam moments kept as 8-bit
    codes) the update walks every leaf in chunks (``optim.chunk_ranges``: a
    stacked leaf by layer slice, a large unstacked one by range) and, per
    chunk, decodes both moments in one K2 launch and re-encodes each with
    K1."""
    from repro_torch.core.qsdp import layer_kernel_launches
    eng = model.engine
    k1, k2 = [0, 0, 0], [0, 0, 0]
    for names, times, replays, decodes in gather_groups(model):
        c = layer_kernel_launches(eng, names)
        k1[0] += times * c["gather"][0]
        k1[1] += replays * c["gather"][0]
        k1[2] += times * c["reduce"][0]
        k2[0] += times * c["gather"][1]
        k2[1] += (replays + decodes) * c["gather"][1]
        k2[2] += times * c["reduce"][1]
    fwd, replay, grads = k1
    k2 = tuple(k2)
    from repro_torch.optim.optimizers import chunk_ranges
    chunks = (sum(len(chunk_ranges(s.rest_shape(model.ms))) for s in eng.specs.values())
              if moments else 0)
    return {"quantize_pack": n_micro * (fwd + replay + grads) + 2 * chunks,
            "unpack_dequantize": n_micro * sum(k2) + chunks,
            "per_micro": (fwd, replay, grads), "k2_per_micro": k2,
            "moment_chunks": chunks}


def timed_step(torch, step, st, batch, key):
    """One train step between two synchronizations: (state, loss, grad
    norm, seconds)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    st, m = step(st, batch, key)
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # synchronizes
    torch.cuda.synchronize()
    return st, loss, gnorm, time.perf_counter() - t


def timed_train_steps(torch, step, state, batches, key, dev="cuda", timed=None):
    """One warm-up step, then `timed` (TRAIN_TIMED unless given) timed steps
    with the launch counts zeroed just before and the peak memory reset.
    Returns the state, the
    losses and grad norms of all steps, the timed steps' seconds, the
    warm-up's, the timed steps' launches and their peak memory (bytes)."""
    from repro_torch.kernels import ops

    def run(i, st):
        return timed_step(torch, step, st, batches[i], key(i))

    state, loss0, gnorm0, t_warm = run(0, state)
    losses, gnorms, times = [loss0], [gnorm0], []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for i in range(1, 1 + (TRAIN_TIMED if timed is None else timed)):
        state, loss, gnorm, dt = run(i, state)
        losses.append(loss)
        gnorms.append(gnorm)
        times.append(dt)
    counts = dict(ops.LAUNCHES)
    return state, losses, gnorms, times, t_warm, counts, torch.cuda.max_memory_allocated()


def check_train_launches(counts, want, what):
    from repro_torch.kernels import ops
    for k in ops.KERNELS:
        n_want = TRAIN_TIMED * want.get(k, 0)
        check(counts[k] == n_want, f"{what}: {k} launched {counts[k]} times in "
              f"{TRAIN_TIMED} steps, the code's structure predicts {n_want}")


def train_phase(torch, log, dev="cuda", measured=None, built=None):
    """gpt-1.3b's train cell (module docstring, phase 8); with `measured`
    (a dict), its profiled step also takes the roofline phase's
    measurement, kept there under "gpt-1.3b train"; with `built` (a dict),
    one more f32 step and the last quantized_state step are traced for the
    analysis phase (:func:`card_traces`)."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
    from repro_torch.train.step import (build_train_step, dequantize_train_state,
                                        init_train_state, quantize_train_state)

    cfg = configs.get_config("gpt-1.3b")
    model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
    sched = cosine_schedule(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    opt = make_adamw(AdamWConfig(lr=TRAIN["lr"], schedule=sched))
    data = SyntheticLM(cfg.vocab_size, TRAIN["seq"], TRAIN["batch"], seed=TRAIN["seed"])
    n_steps = 1 + TRAIN_TIMED + 1
    batches = [make_batch(data, i, dev) for i in range(n_steps)]

    def key(i):
        return prng.fold_in(prng.PRNGKey(TRAIN["seed"] + 1), i)

    n_params = sum(math.prod(s.shape) * (s.stack or 1) for s in model.specs.values())
    state = init_train_state(model, opt, TRAIN["seed"], dev)
    step = build_train_step(model, opt, n_micro=TRAIN["n_micro"], device=dev)
    state, losses, gnorms, times, t_warm, counts, peak = timed_train_steps(
        torch, step, state, batches, key, dev)
    reserved = torch.cuda.max_memory_reserved() if dev == "cuda" else 0
    want = expected_train_launches(model, TRAIN["n_micro"])
    check_train_launches(counts, want, "train")
    check(all(map(math.isfinite, losses + gnorms)), f"train: losses {losses}, norms {gnorms}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= FIRST_LOSS_ATOL,
          f"train: first loss {losses[0]:.4f}, ln(vocab) = {math.log(cfg.vocab_size):.4f}")
    tok = TRAIN["batch"] * TRAIN["seq"]
    med = statistics.median(times)
    log(f"train: gpt-1.3b ({n_params / 1e9:.3f} G params), batch {TRAIN['batch']} x seq "
        f"{TRAIN['seq']}, n_micro {TRAIN['n_micro']}: warm-up step {t_warm * 1e3:.1f} ms; "
        f"{TRAIN_TIMED} timed steps median {med * 1e3:.1f} ms (min {min(times) * 1e3:.1f}, "
        f"max {max(times) * 1e3:.1f}), {tok / med:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB allocated, {reserved / 2**30:.2f} GiB reserved")
    log(f"train: losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]} (first loss vs ln {cfg.vocab_size} = "
        f"{math.log(cfg.vocab_size):.4f})")
    log(f"train: launches in {TRAIN_TIMED} steps {counts}; per step K1 "
        f"{want['quantize_pack']} = {TRAIN['n_micro']} microbatches x (forward, replay, "
        f"gradient) tensors {want['per_micro']}, K2 {want['unpack_dequantize']} = "
        f"{TRAIN['n_micro']} x buffers {want['k2_per_micro']}")

    # one more step under torch.profiler: K1's device time per step and
    # the int64 elementwise kernels left (the threefry draws of core/prng.py
    # ran as such kernels; K1 now draws in its own threads)
    i = 1 + TRAIN_TIMED
    prof = profile_train_step(torch, lambda st: step(st, batches[i], key(i)), state, log,
                              **({} if measured is None else {"flops": True}))
    if measured is not None:
        measured["gpt-1.3b train"] = dict(
            model=model, opt=opt, n_micro=TRAIN["n_micro"], batch=batches[i], step_ms=med * 1e3,
            launches={k: counts[k] // TRAIN_TIMED for k in counts}, prof=prof)
    check(prof["threefry_int64"] == 0,
          f"train: {prof['threefry_int64']} int64 bitwise/shift kernels in the profiled step "
          "(a threefry draw outside K1)")
    log(f"train: profiled step: K1 {prof['k1_ms']:.1f} ms in {prof['k1_n']} launches, K2 "
        f"{prof['k2_ms']:.1f} ms in {prof['k2_n']}; int64 elementwise kernels "
        f"{prof['int64_n']} ({prof['int64_ms']:.1f} ms), of which int64 bitwise/shift "
        f"(threefry) {prof['threefry_int64']}")
    if built is not None:
        card_traces(torch, {"train-step[f32]": lambda: step(state, batches[i], key(i))}, built)
    del state, step
    torch.cuda.empty_cache()

    # remat "dots": the first DOTS_TIMED + 1 steps from the same initial
    # state, keeping the layers' 2-D matmul outputs instead of recomputing
    # them: losses bit-equal to "full", the same launches a step (the gathers
    # still replay)
    model_d = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig(remat_policy="dots"))
    step_d = build_train_step(model_d, opt, n_micro=TRAIN["n_micro"], device=dev)
    state_d, losses_d, gnorms_d, times_d, _, counts_d, peak_d = timed_train_steps(
        torch, step_d, init_train_state(model_d, opt, TRAIN["seed"], dev), batches, key, dev,
        timed=DOTS_TIMED)
    n_d = 1 + DOTS_TIMED
    check(losses_d == losses[:n_d] and gnorms_d == gnorms[:n_d],
          f"train: remat 'dots' losses {losses_d} / norms {gnorms_d} differ from 'full' "
          f"{losses[:n_d]} / {gnorms[:n_d]}")
    check(all(counts_d[k] * TRAIN_TIMED == counts[k] * DOTS_TIMED for k in counts),
          f"train: remat 'dots' launches {counts_d} in {DOTS_TIMED} steps, 'full' {counts} in "
          f"{TRAIN_TIMED}")
    med_d = statistics.median(times_d)
    log(f"train: remat 'dots': losses and grad norms bit-equal to 'full' over "
        f"{n_d} steps, launches a step equal; {DOTS_TIMED} timed step(s) median "
        f"{med_d * 1e3:.1f} ms (min {min(times_d) * 1e3:.1f}, max {max(times_d) * 1e3:.1f}), "
        f"{tok / med_d:.1f} tokens/s, peak memory {peak_d / 2**30:.2f} GiB; 'full' "
        f"{med * 1e3:.1f} ms, {peak / 2**30:.2f} GiB")
    del state_d, step_d
    torch.cuda.empty_cache()

    train_prefetch(torch, log, cfg, opt, batches, key, dict(
        losses=losses, gnorms=gnorms, med=med, peak=peak, reserved=reserved, counts=counts),
        dev)

    # quantized-domain state vs the QDQ master, 8-bit moments (Theorem 2)
    opt8 = make_adamw(AdamWConfig(lr=TRAIN["lr"], schedule=sched, moment_bits=8))
    qs = quantize_train_state(init_train_state(model, opt8, TRAIN["seed"], dev), model,
                              prng.PRNGKey(TRAIN["seed"] + 2))
    fs = dequantize_train_state(qs)
    step_q = build_train_step(model, opt8, n_micro=TRAIN["n_micro"], quantized_state=True,
                              device=dev)
    step_f = build_train_step(model, opt8, n_micro=TRAIN["n_micro"], quantize_master=True,
                              device=dev)
    lq, lf = [], []
    for i in range(QSTATE_STEPS):
        run_q = functools.partial(step_q, qs, batches[i], key(i))
        if built is not None and i == QSTATE_STEPS - 1:  # traced for the analysis phase
            qs, mq = card_traces(torch, {"train-step[qstate]": run_q}, built)["train-step[qstate]"]
        else:
            qs, mq = run_q()
        lq.append(float(mq["loss"]))
        fs, mf = step_f(fs, batches[i], key(i))
        lf.append(float(mf["loss"]))
    check(lq == lf and all(map(math.isfinite, lq)),
          f"train: quantized_state losses {lq} != quantize_master losses {lf}")
    log(f"train: quantized_state == quantize_master (8-bit moments), losses {lq} over "
        f"{QSTATE_STEPS} steps")
    del qs, fs, step_q, step_f
    torch.cuda.empty_cache()
    return counts


def stream_overlap(events, k1_name="quantize_pack"):
    """K1's kernels in a chrome trace by CUDA stream, and how much of the
    K1 time on streams other than the compute stream (the stream with the
    most kernels) overlaps kernels running on the compute stream: K1's
    launches, those off the compute stream, their µs, the µs of it that
    some compute-stream kernel overlaps, and the trace's streams."""
    kernels = [e for e in events if e.get("cat") == "kernel"]

    def stream(e):
        return e.get("args", {}).get("stream", e.get("tid"))

    compute = collections.Counter(map(stream, kernels)).most_common(1)[0][0]
    busy = []   # the compute stream's busy intervals, merged
    for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels
                         if stream(e) == compute):
        if busy and t0 <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], t1)
        else:
            busy.append([t0, t1])
    starts = [b[0] for b in busy]
    k1 = [e for e in kernels if k1_name in e["name"]]
    side = [e for e in k1 if stream(e) != compute]
    side_us = over_us = 0.0
    for e in side:
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        side_us += t1 - t0
        i = max(bisect.bisect_right(starts, t0) - 1, 0)
        while i < len(busy) and busy[i][0] < t1:
            over_us += max(0.0, min(t1, busy[i][1]) - max(t0, busy[i][0]))
            i += 1
    return dict(k1_n=len(k1), k1_side=len(side), side_us=side_us, overlap_us=over_us,
                streams=len({stream(e) for e in kernels}))


def train_prefetch(torch, log, cfg, opt, batches, key, full, dev="cuda"):
    """gpt-1.3b's train cell under ``QSDPConfig(prefetch=True)``: the first
    DOTS_TIMED + 1 steps from the same initial state and batches as "full"
    (`full`: its losses, norms, median step, peaks and launches), losses
    and grad norms bit-equal to "full"'s, K1/K2 launches a step equal to the
    prefetch form of the structure's (each pipelined layer's replay decodes
    its carried wire buffer, no K1), the median step and the peaks beside
    "full"'s; then one profiled step: the forward's layer encodes on a
    stream other than the compute stream, as many as the pipeline starts,
    and the share of their time that compute kernels overlap."""
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    from repro_torch.train.step import build_train_step, init_train_state

    t0 = time.perf_counter()
    model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig(prefetch=True))
    check(model.pipelined("layers", cfg.n_layers), "train prefetch: the stack is not pipelined")
    step = build_train_step(model, opt, n_micro=TRAIN["n_micro"], device=dev)
    state, losses, gnorms, times, _, counts, peak = timed_train_steps(
        torch, step, init_train_state(model, opt, TRAIN["seed"], dev), batches, key, dev,
        timed=DOTS_TIMED)
    reserved = torch.cuda.max_memory_reserved() if dev == "cuda" else 0
    n = 1 + DOTS_TIMED
    check(losses == full["losses"][:n] and gnorms == full["gnorms"][:n],
          f"train prefetch: losses {losses} / norms {gnorms} differ from 'full' "
          f"{full['losses'][:n]} / {full['gnorms'][:n]}")
    want = expected_train_launches(model, TRAIN["n_micro"])
    for k in ops.KERNELS:
        check(counts[k] == DOTS_TIMED * want.get(k, 0),
              f"train prefetch: {k} launched {counts[k]} times in {DOTS_TIMED} steps, the "
              f"structure predicts {DOTS_TIMED * want.get(k, 0)}")
    eng = model.engine
    starts_q = sum(eng._is_quantized(s) * s.stack for s in eng.specs.values() if s.stack)
    med = statistics.median(times)
    log(f"train prefetch: losses and grad norms bit-equal to 'full' over {n} steps; launches "
        f"a step K1 {want['quantize_pack']} (forward, replay, gradient {want['per_micro']} a "
        f"microbatch; 'full' {full['counts']['quantize_pack'] // TRAIN_TIMED}), K2 "
        f"{want['unpack_dequantize']} ({want['k2_per_micro']}; 'full' "
        f"{full['counts']['unpack_dequantize'] // TRAIN_TIMED}); {DOTS_TIMED} timed step(s) "
        f"median {med * 1e3:.1f} ms (min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}), "
        f"'full' {full['med'] * 1e3:.1f} ms; peak {peak / 2**30:.2f} GiB allocated, "
        f"{reserved / 2**30:.2f} GiB reserved ('full' {full['peak'] / 2**30:.2f}, "
        f"{full['reserved'] / 2**30:.2f})")
    if dev != "cuda":   # streams exist on the card only: one stream here, nothing to profile
        return
    i = 1 + TRAIN_TIMED
    prof = profile_train_step(torch, lambda st: step(st, batches[i], key(i)), state, log,
                              tag="train prefetch", breakdown=stream_overlap)
    ov = prof["parts"]
    share = ov["overlap_us"] / max(ov["side_us"], 1e-9)
    check(ov["k1_side"] == TRAIN["n_micro"] * starts_q,
          f"train prefetch: {ov['k1_side']} of {ov['k1_n']} K1 kernels ran off the compute "
          f"stream; the pipeline starts {TRAIN['n_micro'] * starts_q} encodes a step")
    log(f"train prefetch: profiled step: {ov['k1_side']} of {ov['k1_n']} K1 launches on the "
        f"side stream ({ov['streams']} streams), {ov['side_us'] / 1e3:.3f} ms of K1 there, "
        f"{ov['overlap_us'] / 1e3:.3f} ms of it under compute-stream kernels "
        f"({100 * share:.1f} %); busy {prof['busy_ms']:.1f} of {prof['wall_ms']:.1f} ms wall; "
        f"run {time.perf_counter() - t0:.1f} s")
    del state, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8b: MoE training
# ---------------------------------------------------------------------------

# olmoe-1b-7b at full width and depth, 16 layers (6.81 G parameters): the
# f32 master, one set of f32 gradients (each layer slice's summed in place
# over the microbatches) and the 8-bit moment codes take 63.5 GiB, and the
# update's temporaries are a layer slice's (one expert stack: 134 M values)
MOE_TRAIN_LAYERS = 16
# card vs CPU, one f32 step of the smoke config from the same state: the
# step tolerances of the CPU tests against the JAX package
# (tests/_torch_train_common.py LOSS_RTOL, GNORM_RTOL)
MOE_SMALL_LOSS_RTOL, MOE_SMALL_GNORM_RTOL = 1e-5, 1e-4


def moe_small_train(torch, log):
    """One step of olmoe-1b-7b's smoke config (f32 compute) on the card and
    on the CPU from the same state, under the router-margin rule: if a token
    of the CPU's routings has a top-k margin below ROUTE_MARGIN the card may
    route it elsewhere, and the loss and grad norm are then not compared
    (what was left out is printed); the routes of the other tokens must
    agree."""
    from repro_torch import configs
    import repro_torch.models.moe as moe_mod
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, make_adamw
    from repro_torch.train.checkpoint import state_from_flat, state_to_flat
    from repro_torch.train.step import build_train_step, init_train_state

    cfg = configs.get_smoke(MOE_ARCH)
    model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig(compute_dtype="float32"))
    opt = make_adamw(AdamWConfig(lr=1e-3, moment_bits=8))
    flat = state_to_flat(init_train_state(model, opt, SMALL_TRAIN["seed"], "cpu"))
    data = SyntheticLM(cfg.vocab_size, SMALL_TRAIN["seq"], SMALL_TRAIN["batch"],
                       seed=SMALL_TRAIN["seed"])
    res = {}
    for dev in ("cuda", "cpu"):
        step = build_train_step(model, opt, n_micro=SMALL_TRAIN["n_micro"], device=dev)
        routes = []
        with hooked(moe_mod, "route", capture_routes(routes)):
            _, m = step(state_from_flat(*flat, device=dev), make_batch(data, 0, dev),
                        prng.PRNGKey(1))
        res[dev] = float(m["loss"]), float(m["grad_norm"]), routes
    (lc, gc, rc), (lp, gp, rp) = res["cuda"], res["cpu"]
    try:
        compared, excluded = route_agreement(torch, rc, rp, cfg.moe_top_k)
    except PhaseError as e:
        raise PhaseError(f"moetrain small: {e}") from None
    check(all(map(math.isfinite, (lc, gc))), f"moetrain small: loss {lc}, grad norm {gc}")
    rl, rg = abs(lc - lp) / abs(lp), abs(gc - gp) / abs(gp)
    if excluded == 0:
        check(rl <= MOE_SMALL_LOSS_RTOL and rg <= MOE_SMALL_GNORM_RTOL,
              f"moetrain small: card loss {lc} / grad norm {gc} vs CPU {lp} / {gp} (rel "
              f"{rl:.2e} / {rg:.2e}, tol {MOE_SMALL_LOSS_RTOL} / {MOE_SMALL_GNORM_RTOL})")
    log(f"moetrain small: {cfg.name} one f32 step card vs CPU: loss {lc} vs {lp} (rel "
        f"{rl:.2e}, tol {MOE_SMALL_LOSS_RTOL}), grad norm {gc} vs {gp} (rel {rg:.2e}, tol "
        f"{MOE_SMALL_GNORM_RTOL}) {'compared' if excluded == 0 else 'NOT compared'}; "
        f"top-{cfg.moe_top_k} experts equal for {compared} token routings of {len(rc)} MoE "
        f"calls (forward and replay), {excluded} left out (CPU router margin < "
        f"{ROUTE_MARGIN:g})")


def moe_layer_stats(torch, store):
    """Hook on ``moe.moe_layer``: each call's aux loss and its assignments
    dropped by capacity (an expert keeps its first c assignments in the
    stable sort, so it drops max(0, count - c))."""
    import repro_torch.models.moe as moe_mod

    def wrap(orig):
        def f(x, w, cfg, no_drop=False, group=None):
            out, aux = orig(x, w, cfg, no_drop, group)
            _, _, tope = moe_mod.route(x, w["router"], cfg)
            c = moe_mod.dispatch_capacity(cfg, x.shape[0], no_drop)
            counts = torch.bincount(tope.reshape(-1), minlength=cfg.n_experts)
            store.append((aux.detach(), torch.clamp(counts - c, min=0).sum(), tope.numel()))
            return out, aux
        return f
    return wrap


def annotated(torch, orig, name):
    def f(*a, **k):
        with torch.profiler.record_function(name):
            return orig(*a, **k)
    return f


def host_mem_total() -> str:
    """The host's MemTotal line of /proc/meminfo ("not readable" elsewhere)."""
    try:
        return Path("/proc/meminfo").read_text().splitlines()[0].split(":", 1)[1].strip()
    except (OSError, IndexError):
        return "not readable"


def state_tensors(st) -> dict:
    """Every tensor of a train state: the parameters and the moments (f32,
    or the wire of 8-bit codes), keyed (part, name)."""
    out = {("parameter", k): getattr(v, "wire", v) for k, v in st.params.items()}
    for which, tree in (("mu", st.opt.mu), ("nu", st.opt.nu)):
        out.update({(which, k): getattr(v, "wire", v) for k, v in tree.items()})
    return out


def equal_to_host(torch, v, h, step=1 << 28) -> bool:
    """torch.equal of a device tensor and a host one, compared on the card
    in ranges of `step` values (no device copy of a whole leaf)."""
    v, h = v.reshape(-1), h.reshape(-1)
    if v.dtype != h.dtype or v.numel() != h.numel():
        return False
    return all(torch.equal(v[a:a + step], h[a:a + step].to(v.device))
               for a in range(0, v.numel(), step))


def step0_twice(torch, log, tag, run0, init):
    """Determinism: step 0 (``run0(state)``, a ``timed_step``) run twice,
    each time from ``init()``, the state made anew from the seed
    (``init_params`` draws from a seeded generator): the loss, the grad
    norm, every updated parameter and every moment (f32 or the codes of
    8-bit ones) bit-equal.  The update runs in place, so run A's result is
    kept as the one host copy and run B's compared with it on the card.
    Prints the host's MemTotal.  Returns run B's (state, loss, grad
    norm)."""
    st, loss_a, gnorm_a, t_a = run0(init())
    host_a = {k: v.to("cpu") for k, v in state_tensors(st).items()}
    del st
    state, loss_b, gnorm_b, t_b = run0(init())
    check(loss_a == loss_b and gnorm_a == gnorm_b,
          f"{tag}: step 0 twice: losses {loss_a} / {loss_b}, grad norms {gnorm_a} / {gnorm_b}")
    for k, v in state_tensors(state).items():
        check(equal_to_host(torch, v, host_a.pop(k)), f"{tag}: step 0 twice: {k[0]} {k[1]} "
              "differs")
    bits = "8-bit" if any(hasattr(v, "wire") for v in state.opt.mu.values()) else "f32"
    log(f"{tag}: step 0 run twice from the same state and key (made anew from the seed): loss "
        f"{loss_a}, grad norm {gnorm_a} and all {len(state.params)} updated parameters and their {bits} "
        f"moments bit-equal ({t_a * 1e3:.1f} / {t_b * 1e3:.1f} ms); host MemTotal "
        f"{host_mem_total()}")
    return state, loss_b, gnorm_b


def update_timer(torch, opt, spans, dev):
    """`opt` with its update between two CUDA events (no synchronization
    added), each step's pair appended to `spans`: the update's span on the
    card.  `opt` itself off the card."""
    if dev != "cuda":
        return opt
    import dataclasses as dc

    def update(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = opt.update(*a, **k)
        e1.record()
        spans.append((e0, e1))
        return out
    return dc.replace(opt, update=update)


def update_share(spans, times, n) -> str:
    """The last `n` updates' spans (ms) beside the steps' times (s)."""
    if not spans:
        return "the update's span: not measured (no card)"
    ms = [e0.elapsed_time(e1) for e0, e1 in spans[-n:]]
    med = statistics.median(ms)
    return (f"the update (norm excluded) {med:.1f} ms a step (min {min(ms):.1f}, max "
            f"{max(ms):.1f}), {100 * med / (1e3 * statistics.median(times)):.1f}% of the step")


def memory_line(torch, dev) -> str:
    """Peak allocated and peak reserved device memory since the last reset,
    of the card's total."""
    if dev != "cuda":
        return "peak memory: not measured (no card)"
    tot = torch.cuda.get_device_properties(0).total_memory / 2**30
    return (f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved, of {tot:.2f}")


def moetrain_phase(torch, log, dev="cuda"):
    """olmoe-1b-7b training at full width and depth (MOE_TRAIN_LAYERS),
    default QSDPConfig (W8 shift gathers, G8 stochastic gradients, full
    remat), AdamW with 8-bit moments, TRAIN's shape and schedule, through
    ``build_train_step``.  Gates: the smoke config card vs CPU
    (``moe_small_train``); step 0 run twice bit-equal (loss, grad norm,
    every updated parameter and moment code); K1/K2 launches of the timed
    steps equal to the structure's; finite losses, the first less the
    load-balance term (read per layer by a hook on moe_layer in a no-grad
    forward of step 0's microbatches) within FIRST_LOSS_ATOL of ln(vocab);
    no int64 threefry kernel in the profiled step; one quantized_state step
    equal to the quantize_master step (Theorem 2).  Prints step times,
    tokens/s, peak memory allocated and reserved, the update's share of the
    step, the per-layer capacity drops and the profiled step's parts."""
    import dataclasses as dc
    from repro_torch import configs
    import repro_torch.models.moe as moe_mod
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.core.quant import QuantizedParam, qparam_decode
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
    from repro_torch.train.step import (TrainState, build_train_step, init_train_state,
                                        quantize_train_state)

    t0 = time.perf_counter()
    if dev == "cuda":
        moe_small_train(torch, log)
    full = configs.get_config(MOE_ARCH)
    cfg = dc.replace(full, n_layers=MOE_TRAIN_LAYERS)
    model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
    sched = cosine_schedule(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    opt = make_adamw(AdamWConfig(lr=TRAIN["lr"], schedule=sched, moment_bits=8))
    data = SyntheticLM(cfg.vocab_size, TRAIN["seq"], TRAIN["batch"], seed=TRAIN["seed"])
    batches = [make_batch(data, i, dev) for i in range(1 + TRAIN_TIMED + 1)]
    nm = TRAIN["n_micro"]

    def key(i):
        return prng.fold_in(prng.PRNGKey(TRAIN["seed"] + 1), i)

    def init():
        return init_train_state(model, opt, TRAIN["seed"], dev)

    n_params = sum(math.prod(s.shape) * (s.stack or 1) for s in model.specs.values())
    spans = []
    step = build_train_step(model, update_timer(torch, opt, spans, dev), n_micro=nm, device=dev)

    # step 0's forward without gradients, microbatch by microbatch under the
    # step's keys: each layer's load-balance term and capacity drops
    stats = []
    state = init()
    with torch.no_grad(), hooked(moe_mod, "moe_layer", moe_layer_stats(torch, stats)):
        for i in range(nm):
            model.loss_fn(state.params, {k: v.reshape(nm, -1, v.shape[-1])[i]
                                         for k, v in batches[0].items()},
                          prng.fold_in(key(0), i))
    del state
    check(len(stats) == nm * cfg.n_layers, f"moetrain: {len(stats)} moe_layer calls")
    aux = [[float(a) for a, _, _ in stats[i * cfg.n_layers:(i + 1) * cfg.n_layers]]
           for i in range(nm)]
    drop = [sum(int(d) for _, d, _ in stats[j::cfg.n_layers]) /
            sum(n for _, _, n in stats[j::cfg.n_layers]) for j in range(cfg.n_layers)]
    del stats

    def sync_step(i, st):
        return timed_step(torch, step, st, batches[i], key(i))

    state, loss_b, gnorm_b = step0_twice(torch, log, "moetrain", lambda st: sync_step(0, st),
                                         init)

    # timed steps from step 1 on (step 0 above was the warm-up)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, gnorms, times = [loss_b], [gnorm_b], []
    for i in range(1, 1 + TRAIN_TIMED):
        state, loss, gnorm, dt = sync_step(i, state)
        losses.append(loss)
        gnorms.append(gnorm)
        times.append(dt)
    counts = dict(ops.LAUNCHES)
    mem = memory_line(torch, dev)
    want = expected_train_launches(model, nm, moments=True)
    check_train_launches(counts, want, "moetrain")
    aux0 = sum(sum(a) for a in aux) / nm
    xent0 = losses[0] - aux0
    check(all(map(math.isfinite, losses + gnorms)), f"moetrain: losses {losses}, norms {gnorms}")
    check(abs(xent0 - math.log(cfg.vocab_size)) <= FIRST_LOSS_ATOL,
          f"moetrain: first loss {losses[0]:.4f} less the load-balance term {aux0:.4f} = "
          f"{xent0:.4f}, ln(vocab) = {math.log(cfg.vocab_size):.4f}")
    balanced = model.ecfg.aux_coef * cfg.moe_top_k
    tok = TRAIN["batch"] * TRAIN["seq"]
    med = statistics.median(times)
    c = moe_mod.dispatch_capacity(model.ecfg, tok // nm, False)
    log(f"moetrain: {cfg.name} at full width, {cfg.n_layers} of {full.n_layers} layers "
        f"({n_params / 1e9:.3f} G params; d_model {cfg.d_model}, {cfg.n_experts} experts "
        f"top-{cfg.moe_top_k}, capacity {c} slots per expert and microbatch), batch "
        f"{TRAIN['batch']} x seq {TRAIN['seq']}, n_micro {nm}, 8-bit moments: "
        f"{TRAIN_TIMED} timed steps median {med * 1e3:.1f} ms (min {min(times) * 1e3:.1f}, "
        f"max {max(times) * 1e3:.1f}), {tok / med:.1f} tokens/s; {mem}; "
        f"{update_share(spans, times, TRAIN_TIMED)}")
    log(f"moetrain: losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]}; first loss less the load-balance term "
        f"{xent0:.4f} (ln {cfg.vocab_size} = {math.log(cfg.vocab_size):.4f})")
    log(f"moetrain: load-balance term per layer (step 0, mean of {nm} microbatches) "
        f"{[round(sum(a[j] for a in aux) / nm, 5) for j in range(cfg.n_layers)]}, sum "
        f"{aux0:.5f}; balanced: {model.ecfg.aux_coef} x {cfg.n_experts} x "
        f"{cfg.moe_top_k}/{cfg.n_experts} = {balanced:.2f} per layer, "
        f"{balanced * cfg.n_layers:.2f} in all")
    log(f"moetrain: top-k assignments dropped by capacity per layer (step 0) "
        f"{[round(x, 5) for x in drop]}")
    log(f"moetrain: launches in {TRAIN_TIMED} steps {counts}; per step K1 "
        f"{want['quantize_pack']} = {nm} microbatches x (forward, replay, gradient) tensors "
        f"{want['per_micro']} + 2 x {want['moment_chunks']} moment encodes (a moment of an "
        f"update chunk each), K2 {want['unpack_dequantize']} = {nm} x buffers "
        f"{want['k2_per_micro']} + {want['moment_chunks']} moment decodes (both moments of a "
        f"chunk in one launch)")

    # one more step under torch.profiler with its parts in named ranges (busy
    # share, K1/K2, no threefry int64 kernel; the ranges add host time)
    i = 1 + TRAIN_TIMED
    profile_by_part(torch, log, "moetrain", model, opt, nm, state, batches[i], key(i), "MLP",
                    dev)
    del state, step
    if dev == "cuda":
        torch.cuda.empty_cache()

    # Theorem 2 in the quantized domain, one step: the wire-code state's step
    # equals the QDQ master's, each from the initial moments (the update
    # re-encodes them in place, so the second step's are made anew)
    qs0 = quantize_train_state(init(), model, prng.PRNGKey(TRAIN["seed"] + 2))
    # the step updates the fp leaves (norms, router) in place: keep them
    fp0 = {k: v.clone() for k, v in qs0.params.items() if not isinstance(v, QuantizedParam)}
    step_q = build_train_step(model, opt, n_micro=nm, quantized_state=True, device=dev)
    qs1, mq = step_q(qs0, batches[0], key(0))
    lq, gq = float(mq["loss"]), float(mq["grad_norm"])
    q1 = {k: (QuantizedParam(v.wire.cpu(), v.cell_shape, v.cfg)
              if isinstance(v, QuantizedParam) else v.cpu()) for k, v in qs1.params.items()}
    m1 = {k: (qs1.opt.mu[k].wire.cpu(), qs1.opt.nu[k].wire.cpu()) for k in q1}
    del qs1, step_q
    p0 = {k: fp0[k] if k in fp0 else qparam_decode(v) for k, v in qs0.params.items()}
    del qs0, fp0
    fs0 = TrainState(params=p0, opt=opt.init(p0))
    del p0
    step_f = build_train_step(model, opt, n_micro=nm, quantize_master=True, device=dev)
    fs1, mf = step_f(fs0, batches[0], key(0))
    del fs0
    lf, gf = float(mf["loss"]), float(mf["grad_norm"])
    check(lq == lf and gq == gf and math.isfinite(lq),
          f"moetrain: quantized_state loss {lq} / norm {gq} != quantize_master {lf} / {gf}")
    for k, v in fs1.params.items():
        q = q1.pop(k)
        got = (qparam_decode(QuantizedParam(q.wire.to(dev), q.cell_shape, q.cfg))
               if isinstance(q, QuantizedParam) else q.to(dev))
        check(torch.equal(got, v), f"moetrain: quantized_state {k} != quantize_master's")
        del got
        mu, nu = m1.pop(k)
        check(equal_to_host(torch, fs1.opt.mu[k].wire, mu)
              and equal_to_host(torch, fs1.opt.nu[k].wire, nu),
              f"moetrain: quantized_state moments of {k} != quantize_master's")
    log(f"moetrain: quantized_state == quantize_master (8-bit moments, {cfg.n_layers} "
        f"layers): loss {lq}, grad norm {gq}, every parameter and moment equal after one step")
    del fs1, step_f
    peak_all = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else float("nan")
    if dev == "cuda":
        torch.cuda.empty_cache()
    log(f"moetrain: phase {time.perf_counter() - t0:.1f} s, peak device memory since the "
        f"timed steps {peak_all:.2f} GiB")
    return counts


# ---------------------------------------------------------------------------
# phase 8c: SSM and hybrid training
# ---------------------------------------------------------------------------

# zamba2-7b trains at full width and depth: its 81 layers (6.63 G
# parameters: 13 groups of 6 Mamba2 layers, each followed by the shared
# block, and a 3-layer tail) hold 61.8 GiB of state: the f32 master, one set
# of gradients and the 8-bit moment codes.  mamba2-370m trains at its full
# 48 layers too (a host-bound step of ~61,000 kernels); its cell runs 24, to
# make room in the run's time
SSM_TRAIN_LAYERS = {"mamba2-370m": 24, "zamba2-7b": None}
# Adam moments as 8-bit codes where the master and the gradients alone fill
# most of the card
SSM_TRAIN_MOMENT_BITS = {"mamba2-370m": None, "zamba2-7b": 8}
# the profiled step: mamba2-370m's as it is ("step"; its by-part profile,
# a host-bound step of ~53,000 kernels, was the first cut of the time
# budget the vlmaudio phase needed); zamba2-7b's none since PR 31 (its by
# part profile, ~25-34 s of the cell, made room for the train phase's
# prefetch run and the dist phase's reshard check; its last breakdown is
# in PERF.md)
SSM_TRAIN_PROFILE = {"mamba2-370m": "step", "zamba2-7b": None}


def train_batches(torch, cfg, n, dev, seq, batch, seed, image=None):
    """n batches of the synthetic corpus (``make_batch``, steps 0..n-1) with
    `cfg`'s modality inputs, the reference's train inputs
    (``configs/inputs.py:26-43``): VLM, the image block `image`
    (``vlm_image_prompt``'s arguments: patch embeddings, ``vision_mask``,
    Qwen2-VL's (t, h, w) positions), its labels -1 (no loss on image
    tokens); audio, the frame stub 0.1 * normal of (batch, seq //
    enc_frames_ratio, d) in bf16, drawn on the host as ``make_prompt_batch``
    draws it.  The modality tensors are one set shared by every batch."""
    from repro_torch.core import prng
    from repro_torch.data import SyntheticLM, make_batch
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    out = [make_batch(data, i, dev) for i in range(n)]
    extra = {}
    if cfg.arch_type == "vlm":
        img = vlm_image_prompt(torch, cfg, None, None, out[0]["tokens"].cpu(), dev, **image)
        extra = {k: img[k] for k in ("vision_embeds", "vision_mask", "positions")}
    elif cfg.arch_type == "audio":
        z = prng.normal(prng.PRNGKey(1), (batch, max(seq // cfg.enc_frames_ratio, 1),
                                          cfg.d_model), dtype=torch.bfloat16)
        extra = {"audio_embeds": (torch.tensor(0.1, dtype=torch.bfloat16) * z).to(dev)}
    for b in out:
        b.update(extra)
        if "vision_mask" in extra:
            b["labels"] = b["labels"].masked_fill(extra["vision_mask"], -1)
    return out


def small_train_step(torch, log, tag, arch, image=None):
    """One step of `arch`'s smoke config (f32 compute) on the card and on
    the CPU from the same state and batch (``train_batches`` at SMALL_TRAIN's
    size, modality inputs included): every gathered weight of the step
    (forward and backward replay; the hybrid's shared block at each
    invocation, the audio encoder's under its own key scope) byte-equal,
    loss and grad norm within the CPU tests' step tolerances."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, make_adamw
    from repro_torch.train.checkpoint import state_from_flat, state_to_flat
    from repro_torch.train.step import build_train_step, init_train_state

    cfg = configs.get_smoke(arch)
    model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig(compute_dtype="float32"))
    opt = make_adamw(AdamWConfig(lr=1e-3))
    flat = state_to_flat(init_train_state(model, opt, SMALL_TRAIN["seed"], "cpu"))
    batch = train_batches(torch, cfg, 1, "cpu", SMALL_TRAIN["seq"], SMALL_TRAIN["batch"],
                          SMALL_TRAIN["seed"], image)[0]
    res = {}
    for dev in ("cuda", "cpu"):
        step = build_train_step(model, opt, n_micro=SMALL_TRAIN["n_micro"], device=dev)
        gathers = {}
        with hooked(model.engine, "_reshape_full", capture_gathers(model, gathers)):
            _, m = step(state_from_flat(*flat, device=dev), batch, prng.PRNGKey(1))
        res[dev] = float(m["loss"]), float(m["grad_norm"]), gathers
    (lc, gc, wc), (lp, gp, wp) = res["cuda"], res["cpu"]
    grouped = {g: sum(len(v) for k, v in wc.items() if k.startswith(g + "/"))
               for g in ("shared", "enc")}
    check(wc == wp, f"{tag} small {arch}: gathered weight bytes differ between card and CPU")
    check(all(map(math.isfinite, (lc, gc))), f"{tag} small {arch}: loss {lc}, norm {gc}")
    rl, rg = abs(lc - lp) / abs(lp), abs(gc - gp) / abs(gp)
    check(rl <= MOE_SMALL_LOSS_RTOL and rg <= MOE_SMALL_GNORM_RTOL,
          f"{tag} small {arch}: card loss {lc} / grad norm {gc} vs CPU {lp} / {gp} (rel "
          f"{rl:.2e} / {rg:.2e}, tol {MOE_SMALL_LOSS_RTOL} / {MOE_SMALL_GNORM_RTOL})")
    log(f"{tag} small: {cfg.name} one f32 step card vs CPU: {sum(map(len, wc.values()))} "
        f"gathers byte-equal ({grouped['shared']} of the shared block's, {grouped['enc']} of "
        f"the encoder's); loss {lc} vs {lp} (rel {rl:.2e}, tol {MOE_SMALL_LOSS_RTOL}), grad "
        f"norm {gc} vs {gp} (rel {rg:.2e}, tol {MOE_SMALL_GNORM_RTOL})")


def train_cell(torch, log, tag, arch, layers, moment_bits, profile, dev="cuda", image=None):
    """`arch` at full width, cut to `layers` layers where not None, through
    ``build_train_step``: default QSDPConfig, AdamW + cosine (8-bit moments
    where `moment_bits`), TRAIN's batch, sequence, microbatches and schedule
    (``train_batches``: the family's modality inputs, the VLM's image block
    `image`).  Gates: step 0 twice bit-equal; K1/K2 launches of 3 timed
    steps equal to the structure's; finite losses, the first within
    FIRST_LOSS_ATOL of ln(vocab) + d s^2 / 2; no int64 threefry kernel in a
    profiled step.  Prints step times, tokens/s, peak memory, launches per
    step, for the SSM families the SSD decay mask's largest chunk exponent
    per step, and the cell's seconds.  `profile`: "step" profiles one more
    step, "by part" also one by part, None none.  Returns the timed steps'
    launches."""
    import dataclasses as dc
    from repro_torch import configs
    import repro_torch.models.mamba as mamba_mod
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
    from repro_torch.train.step import build_train_step, init_train_state

    tag = f"{tag} {arch}"
    t0 = time.perf_counter()
    full = configs.get_config(arch)
    cfg = full if layers is None else dc.replace(full, n_layers=layers)
    model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
    sched = cosine_schedule(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    opt = make_adamw(AdamWConfig(lr=TRAIN["lr"], schedule=sched, moment_bits=moment_bits))
    batches = train_batches(torch, cfg, 1 + TRAIN_TIMED + 1, dev, TRAIN["seq"], TRAIN["batch"],
                            TRAIN["seed"], image)
    nm = TRAIN["n_micro"]

    def key(i):
        return prng.fold_in(prng.PRNGKey(TRAIN["seed"] + 1), i)

    n_params = sum(math.prod(s.shape) * (s.stack or 1) for s in model.specs.values())
    spans = []
    step = build_train_step(model, update_timer(torch, opt, spans, dev), n_micro=nm, device=dev)

    # the SSM families: each step's largest chunk exponent sum |dt a| of the
    # SSD decay mask (exp overflows past 88.7), read from device scalars
    # after the step
    mamba = cfg.arch_type in ("ssm", "hybrid")
    exps, chunk_exp = [], []

    def record(orig):
        def f(da_cs):
            with torch.no_grad():
                exps.append((da_cs[:, :, 0, :] - da_cs[:, :, -1, :]).amax())
            return orig(da_cs)
        return f

    def sync_step(i, st):
        out = timed_step(torch, step, st, batches[i], key(i))
        if mamba:
            chunk_exp.append(float(torch.stack(exps).max()))
            exps.clear()
        return out

    with hooked(mamba_mod, "segsum_decay", record):
        state, loss0, gnorm0 = step0_twice(
            torch, log, tag, lambda st: sync_step(0, st),
            lambda: init_train_state(model, opt, TRAIN["seed"], dev))

        # timed steps from step 1 on (step 0 above was the warm-up)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        losses, gnorms, times = [loss0], [gnorm0], []
        for i in range(1, 1 + TRAIN_TIMED):
            state, loss, gnorm, dt = sync_step(i, state)
            losses.append(loss)
            gnorms.append(gnorm)
            times.append(dt)
        counts = dict(ops.LAUNCHES)
        mem = memory_line(torch, dev)
    want = expected_train_launches(model, nm, moments=moment_bits is not None)
    check_train_launches(counts, want, tag)
    check(all(map(math.isfinite, losses + gnorms)), f"{tag}: losses {losses}, norms {gnorms}")
    # random logits of variance d * s^2 (unit-RMS final norm, head rows of
    # std s): E[loss] = ln(vocab) + d s^2 / 2, 0.73 above ln(vocab) at
    # zamba2's d_model 3,584, 1.64 at qwen2-vl's 8,192
    s_head = model.specs["lm_head" if "lm_head" in model.specs else "embed"].init_scale
    first = math.log(cfg.vocab_size) + cfg.d_model * s_head ** 2 / 2
    check(abs(losses[0] - first) <= FIRST_LOSS_ATOL,
          f"{tag}: first loss {losses[0]:.4f}, ln(vocab) + d s^2 / 2 = {first:.4f}")
    tok = TRAIN["batch"] * TRAIN["seq"]
    med = statistics.median(times)
    inv = shared_invocations(cfg)
    shape = (f"{cfg.n_layers} of {full.n_layers} layers" if layers is not None
             else f"{cfg.n_layers} layers") + (f", {inv} shared-block invocations" if inv else "")
    if cfg.arch_type == "audio":
        shape += f" and {cfg.n_enc_layers} encoder layers"
    log(f"{tag}: {cfg.name} at full width, {shape} ({n_params / 1e9:.3f} G params), batch "
        f"{TRAIN['batch']} x seq {TRAIN['seq']}, n_micro {nm}, "
        f"{'8-bit' if moment_bits else 'f32'} moments: {TRAIN_TIMED} timed steps median "
        f"{med * 1e3:.1f} ms (min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}), "
        f"{tok / med:.1f} tokens/s; {mem}; {update_share(spans, times, TRAIN_TIMED)}"
        if dev == "cuda" else f"{tag}: {cfg.name} ({shape}) on {dev}")
    log(f"{tag}: losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in gnorms]}; first loss {losses[0]:.4f} (ln {cfg.vocab_size} = "
        f"{math.log(cfg.vocab_size):.4f}, + d s^2 / 2 = {first:.4f})")
    if mamba:
        log(f"{tag}: largest chunk exponent sum |dt a| of the SSD decay mask per step (step 0 "
            f"twice, then the timed steps) {[round(x, 2) for x in chunk_exp]}: exp overflows "
            f"past 88.7, where the reference's mask (exp, then where) has a NaN gradient; the "
            f"port's masks inside the exponent")
    log(f"{tag}: launches in {TRAIN_TIMED} steps {counts}; per step K1 "
        f"{want['quantize_pack']} = {nm} microbatches x (forward, replay, gradient) tensors "
        f"{want['per_micro']} + 2 x {want['moment_chunks']} moment encodes (a moment of an "
        f"update chunk each), K2 {want['unpack_dequantize']} = {nm} x buffers "
        f"{want['k2_per_micro']} + {want['moment_chunks']} moment decodes (both moments of a "
        f"chunk in one launch)")

    # one more step under torch.profiler (busy share, K1/K2, no threefry
    # int64 kernel): as it is ("step"), or with its parts in named ranges
    # ("by part": host time added, so its busy share is not the step's)
    i = 1 + TRAIN_TIMED
    if profile == "step":
        prof = profile_train_step(torch, lambda st: step(st, batches[i], key(i)), state, log,
                                  tag=tag)
        check(prof["threefry_int64"] == 0,
              f"{tag}: {prof['threefry_int64']} int64 bitwise/shift kernels in the profiled "
              "step")
        log(f"{tag}: profiled step: busy {prof['busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms "
            f"wall ({100 * prof['busy_ms'] / max(prof['wall_ms'], 1e-9):.1f}%) in "
            f"{prof.get('kernels', 0)} kernels; K1 {prof['k1_ms']:.1f} ms in {prof['k1_n']} "
            f"launches, K2 {prof['k2_ms']:.1f} ms in {prof['k2_n']}; int64 bitwise/shift "
            f"kernels {prof['threefry_int64']}")
    elif profile == "by part":
        profile_by_part(torch, log, tag, model, opt, nm, state, batches[i], key(i),
                        "shared MLP" if cfg.arch_type == "hybrid" else "MLP", dev)
    del state, step
    if dev == "cuda":
        torch.cuda.empty_cache()
    log(f"{tag}: cell {time.perf_counter() - t0:.1f} s")
    return counts


def profile_by_part(torch, log, tag, model, opt, nm, state, batch, key, mlp, dev):
    """One train step of `model` (`nm` microbatches of `batch` under `key`)
    under torch.profiler with its parts in named ranges (RANGES: gathers,
    attention, cross-attention, the MoE layer's dispatch/combine, the MLP as
    `mlp`, the Mamba2 mixer, SSD scan and conv, logits/xent, optimizer);
    logs the device busy share (the ranges add host time), K1/K2 and the
    device ms and kernels of each part (``step_breakdown``; a MoE model's
    expert products apart) and gates on no int64 threefry kernel."""
    import dataclasses as dc
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.layers as L
    import repro_torch.models.mamba as mamba_mod
    import repro_torch.models.moe as moe_mod
    from repro_torch.train.step import build_train_step

    rng = {v: k for k, v in RANGES.items()}
    n_experts = model.cfg.n_experts if model.cfg.is_moe else None
    step_p = build_train_step(model, dc.replace(opt, update=annotated(
        torch, opt.update, rng["optimizer"])), n_micro=nm, device=dev)
    with hooked(model.engine, "gather_layer",
                lambda o: annotated(torch, o, rng["gathers"])), \
            hooked(attn_mod, "self_attention",
                   lambda o: annotated(torch, o, rng["attention"])), \
            hooked(attn_mod, "cross_attention",
                   lambda o: annotated(torch, o, rng["cross-attention"])), \
            hooked(moe_mod, "moe_layer",
                   lambda o: annotated(torch, o, rng["dispatch/combine"])), \
            hooked(L, "swiglu_mlp", lambda o: annotated(torch, o, rng[mlp])), \
            hooked(mamba_mod, "mamba2_block",
                   lambda o: annotated(torch, o, rng["mixer elementwise"])), \
            hooked(mamba_mod, "ssd_chunked", lambda o: annotated(torch, o, rng["SSD scan"])), \
            hooked(mamba_mod, "_causal_conv", lambda o: annotated(torch, o, rng["conv"])), \
            hooked(L, "vocab_parallel_xent",
                   lambda o: annotated(torch, o, rng["logits/xent"])):
        # the ops' input types only where the breakdown reads them (a MoE
        # model's expert products): they double the trace's parse time
        prof = profile_train_step(torch, lambda st: step_p(st, batch, key), state, log,
                                  tag=f"{tag} by part",
                                  breakdown=lambda ev: step_breakdown(ev, n_experts),
                                  record_shapes=n_experts is not None)
    check(prof["threefry_int64"] == 0,
          f"{tag}: {prof['threefry_int64']} int64 bitwise/shift kernels in the profiled step")
    log(f"{tag}: profiled step: busy {prof['busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms "
        f"wall ({100 * prof['busy_ms'] / max(prof['wall_ms'], 1e-9):.1f}%, ranges on) in "
        f"{prof.get('kernels', 0)} kernels; K1 {prof['k1_ms']:.1f} ms in {prof['k1_n']} "
        f"launches, K2 {prof['k2_ms']:.1f} ms in {prof['k2_n']}; int64 bitwise/shift "
        f"kernels {prof['threefry_int64']}")
    parts = dict(prof["parts"] or {})
    matched, other = parts.pop("_matched", None), parts.pop("_other", [])
    log(f"{tag}: profiled step by part (device ms, kernels): "
        + ", ".join(f"{p} {ms:.1f} in {n}" for p, (ms, n) in
                    sorted(parts.items(), key=lambda kv: -kv[1][0]))
        + f"; backward nodes placed by their forward op's range {matched}; most of other: "
        + "; ".join(f"{ms:.1f} ms {name[:60]}" for name, ms in other))
    return prof


def ssmtrain_phase(torch, log, dev="cuda", archs=SSM_ARCHS):
    """The SSM and hybrid families trained: each smoke config one f32 step
    card vs CPU (``small_train_step``), then each of `archs` through
    ``train_cell`` (SSM_TRAIN_*).  Returns the timed steps' launches,
    summed."""
    t0 = time.perf_counter()
    if dev == "cuda":
        for arch in archs:
            small_train_step(torch, log, "ssmtrain", arch)
    counts = {}
    for arch in archs:
        for k, v in train_cell(torch, log, "ssmtrain", arch, SSM_TRAIN_LAYERS[arch],
                               SSM_TRAIN_MOMENT_BITS[arch], SSM_TRAIN_PROFILE[arch],
                               dev).items():
            counts[k] = counts.get(k, 0) + v
    log(f"ssmtrain: phase {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 8d: VLM and audio training
# ---------------------------------------------------------------------------

# qwen2-vl-72b trains at full width cut to 2 of 80 layers (3.00 G
# parameters: 2 x 877.7 M and the 1,245.7 M-value tied embedding), with
# 8-bit moments: the f32 master, two sets of f32 gradients during the
# second microbatch's backward and the moment codes take ~14 bytes a
# parameter, and the cross-entropy's f32 copies of the embedding and of the
# (4,096 x 152,064) logits, or the update's f32 temporaries on the
# embedding, ~20 GB more.  3 layers (3.88 G) ran out of the card's 79.18
# GiB in the update of the first timed step: 59.67 GiB allocated and 15.06
# GiB reserved but free, in blocks too small for a 4.64 GiB temporary.
# seamless-m4t-large-v2 at full width and depth (24 encoder and 24 decoder
# layers, 2.04 G parameters), f32 moments
MM_TRAIN_LAYERS = {"qwen2-vl-72b": 2, "seamless-m4t-large-v2": None}
MM_TRAIN_MOMENT_BITS = {"qwen2-vl-72b": 8, "seamless-m4t-large-v2": None}
# the profiled steps: qwen2-vl-72b's, and one by part (device-bound: the f32
# logits and cross-entropy lead).  seamless-m4t-large-v2's step is
# host-bound (41.0 % busy in 77,815 kernels, NVIDIA H100 80GB HBM3,
# 700.00 W); its profile, a trace of that size, was a cut of the time
# budget, like mamba2-370m's by-part step (ROADMAP, chip_smoke budget)
MM_TRAIN_PROFILE = {"qwen2-vl-72b": "by part", "seamless-m4t-large-v2": None}
# the image block of each row of the VLM train batch: a 16 x 32 grid of
# patch embeddings (random bf16, scale 0.02) at positions 64-575, with
# Qwen2-VL's (t, h, w) positions; the text after it continues from 64 + 32
# in all three streams; no loss on its 512 tokens (labels -1)
MM_TRAIN_IMAGE = dict(start=64, rows=16, cols=32, scale=0.02, seed=6)


def mmtrain_phase(torch, log, dev="cuda", archs=MM_ARCHS):
    """The VLM and audio families trained: each smoke config one f32 step
    card vs CPU (``small_train_step``; qwen2-vl's batch with an image
    block), then each of `archs` through ``train_cell`` (MM_TRAIN_*): the
    VLM's batches carry MM_TRAIN_IMAGE, the audio model's the frame stub of
    seq // 2 = 1,024 frames.  Prints the phase's seconds and peak device
    memory.  Returns the timed steps' launches, summed."""
    t0 = time.perf_counter()
    counts = {}
    with phase_peak(torch, dev) as peak:
        if dev == "cuda":
            for arch in archs:
                small_train_step(torch, log, "mmtrain", arch, image=MM_SMALL_IMAGE)
            torch.cuda.empty_cache()
        for arch in archs:
            for k, v in train_cell(torch, log, "mmtrain", arch, MM_TRAIN_LAYERS[arch],
                                   MM_TRAIN_MOMENT_BITS[arch], MM_TRAIN_PROFILE[arch], dev,
                                   image=MM_TRAIN_IMAGE).items():
                counts[k] = counts.get(k, 0) + v
        log(f"mmtrain: phase {time.perf_counter() - t0:.1f} s, peak device memory "
            f"{peak():.2f} GiB")
    return counts


# ---------------------------------------------------------------------------
# phase 9: the paper's experiments
# ---------------------------------------------------------------------------

# steps per training run of each table (half the JAX package's suite
# defaults, benchmarks/run.py: 240, 160, 160, 160) and the theory table's
# seeds; then Table 1 at gpt-125m (full width and depth), batch 8 x seq
# 512: a cut of the paper's pretraining to full_steps steps.  Cuts made for
# the run's time: full_steps 100 -> 50 (the mmtrain phase; at 30 the loss
# of the last 5 steps still stands above step 0's, ~11.10 / 11.06 against
# 10.98, as the warm-up's rising learning rate first lifts it) and the
# bench model's steps halved (the analysis phase); theory_seeds 8 -> 4
# would save little (its runs batch the seeds as a row of keys: 4 seeds
# took 59.1 s, 8 took 44.8 s on another machine).  No gate's band changes:
# at the halved steps every gate passed on the CPU with margin (Table 2's
# rows 0.23 apart, Table 3's adaptive 0.055 below uniform, 3/3 Figure 7/8
# checkpoints).
EXP = dict(table1=120, table2=80, table3=80, fig78=80, theory_seeds=8,
           full_steps=50, full_batch=8, full_seq=512)
EXP_RESULTS = "results/torch_bench"


def expected_run_launches(qsdp, cfg, steps: int) -> dict:
    """K1/K2 launches of `steps` train steps of `cfg` under `qsdp` (one
    microbatch), by the code's structure (``expected_train_launches``)."""
    from repro_torch.core.qsdp import MeshSpec
    from repro_torch.models.transformer import Model
    want = expected_train_launches(Model(cfg, MeshSpec(("data", "model"), (1, 1)), qsdp), 1)
    return {k: steps * want[k] for k in ("quantize_pack", "unpack_dequantize")}


# one Theorem 2 run (kappa 4, shift weights, Corollary 3's gradient
# quantizer) on the card against the CPU: the same draws and roundings, f(x)
# summed in another order
THEORY_RTOL = 1e-12


def theory_on_card(torch, log, dev):
    """The theory runs' randomness on `dev` byte for byte against the CPU
    twin (which the CPU tests hold to ``jax.random`` under x64): 64-bit
    bits, f64 and f32 uniforms, the f64 lattice quantizers; then one
    ``run_qsgd`` trajectory on both."""
    from repro_torch.core import prng, quant
    from repro_torch.core.theory import make_quadratic, run_qsgd, theorem2_params

    rows = prng.key_rows([prng.PRNGKey(s) for s in range(8)])
    rows_d = (rows[0].to(dev), rows[1].to(dev))
    for key, key_d in ((prng.PRNGKey(3), prng.PRNGKey(3)), (rows, rows_d)):
        for shape in ((), (64,), (33, 64)):
            pairs = [(prng.bits(key_d, shape, dev, 64), prng.bits(key, shape, "cpu", 64))]
            for dt in (torch.float64, torch.float32):
                pairs.append((prng.uniform(key_d, shape, dev, -0.5, 0.5, dt),
                              prng.uniform(key, shape, "cpu", -0.5, 0.5, dt)))
            for got, want in pairs:
                check(torch.equal(got.cpu(), want), f"theory draws {shape}: the card's "
                      f"differ from the CPU twin's in {(got.cpu() != want).sum().item()} places")
    x = prng.normal(prng.PRNGKey(4), (8, 1024), "cpu", torch.float64) * 10
    for delta in (0.37, 1e-3):
        for name, fn in (("q_shift", quant.q_shift), ("q_coinflip", quant.q_coinflip)):
            got, want = fn(x.to(dev), delta, rows_d).cpu(), fn(x, delta, rows)
            check(torch.equal(got, want), f"theory {name} delta={delta}: the card's values "
                  f"differ from the CPU's in {(got != want).sum().item()} places")
    obj = make_quadratic(prng.PRNGKey(0), n=64, kappa=4.0, device="cpu")
    params = theorem2_params(obj.alpha, obj.beta, 0.5, 1e-3, 0.0, float(obj.f(torch.zeros(64))))
    runs = [run_qsgd(obj, torch.zeros(64), params, prng.PRNGKey(1), grad_q_delta=0.05,
                     device=d)[1].cpu() for d in (dev, "cpu")]
    rel = ((runs[0] - runs[1]).abs() / runs[1].abs()).max().item()
    check(rel <= THEORY_RTOL, f"theory: run_qsgd on the card vs the CPU, rel diff {rel:.3e}")
    log(f"experiments: theory draws on the card byte-equal to the CPU twin (64-bit bits, f64 "
        f"and f32 uniforms, one key and a row of 8); q_shift/q_coinflip f64 byte-equal; "
        f"run_qsgd (kappa 4, shift + gradient quantizer, T {params.T}) within {rel:.2e} "
        f"relative of the CPU at every step (tol {THEORY_RTOL})")


def experiments_phase(torch, log, dev="cuda", enforce=True):
    """The JAX package's paper suite through the port's twins
    (``repro_torch.experiments``) at the reference's sizes, then Table 1 at
    gpt-125m.  Every experiment's gates (``enforce``: a failed one fails
    the phase; the CPU rehearsal, at a few steps, only reports them) and
    K1/K2 launches against the structure's count per train step.  Returns
    (the launches, {gate: passed})."""
    from repro_torch import configs
    from repro_torch.core.qsdp import QSDPConfig
    from repro_torch.experiments import (fig78_compression_error, table1_recovery,
                                         table2_bits_grid, table3_learned_levels,
                                         theory_convergence)
    from repro_torch.experiments._trainer import BENCH_MODEL, qsdp_wg, train_run
    from repro_torch.kernels import ops

    out_dir = str(REPO / EXP_RESULTS)
    dv = ["--device", dev]
    w8g8 = qsdp_wg(8, 8)
    grid = [qsdp_wg(w, g) for w in (8, 4) for g in (8, 4)]
    suite = [  # name, main, argv, the runs' QSDP policies, steps per run
        ("theory_convergence", theory_convergence.main,
         ["--seeds", str(EXP["theory_seeds"])], [], 0),
        ("table1_recovery", table1_recovery.main, ["--steps", str(EXP["table1"])],
         [QSDPConfig.baseline(), w8g8,
          qsdp_wg(8, 8, weight_mode="nearest", grad_mode="nearest", bucket_size=65536)],
         EXP["table1"]),
        ("table2_bits_grid", table2_bits_grid.main, ["--steps", str(EXP["table2"])], grid,
         EXP["table2"]),
        ("table3_learned_levels", table3_learned_levels.main, ["--steps", str(EXP["table3"])],
         [qsdp_wg(4, 8), qsdp_wg(4, 8, bucket_size=256)], EXP["table3"]),
        ("fig78_compression_error", fig78_compression_error.main,
         ["--steps", str(EXP["fig78"])], [w8g8], EXP["fig78"]),
    ]
    theory_on_card(torch, log, dev)
    gates, counts = {}, {k: 0 for k in ops.KERNELS}
    for name, main, argv, policies, steps in suite:
        ops.reset_launches()
        t = time.perf_counter()
        rc = main(argv + dv, out_dir=out_dir)
        dt = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
        want = {k: 0 for k in ops.KERNELS}
        for q in policies:
            for k, v in expected_run_launches(q, BENCH_MODEL, steps).items():
                want[k] += v
        check(got == want, f"experiments {name}: launches {got}, the structure predicts {want}")
        gates[name] = rc == 0
        n_steps = steps * len(policies)
        log(f"experiments {name}: {'PASS' if rc == 0 else 'FAIL'} in {dt:.1f} s"
            + (f" ({n_steps} train steps, {n_steps / dt:.2f} steps/s)" if n_steps else "")
            + f"; launches K1 {got['quantize_pack']}, K2 {got['unpack_dequantize']}")
        for k in counts:
            counts[k] += got[k]
    per = expected_run_launches(w8g8, BENCH_MODEL, 1)
    log(f"experiments: {BENCH_MODEL.name} W8G8 train step: K1 {per['quantize_pack']}, K2 "
        f"{per['unpack_dequantize']} launches (structure), held by every run above")

    # Table 1 at full width and depth
    cfg = configs.get_config("gpt-125m")
    full = {}
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for tag, q in (("baseline-fsdp", QSDPConfig.baseline()), ("qsdp-w8g8", w8g8)):
        ops.reset_launches()
        r = train_run(q, steps=EXP["full_steps"], batch=EXP["full_batch"], seq=EXP["full_seq"],
                      tag=tag, model_cfg=cfg, device=dev)
        got = dict(ops.LAUNCHES)
        want = expected_run_launches(q, cfg, EXP["full_steps"])
        check(all(got[k] == want[k] for k in want) and sum(got.values()) == sum(want.values()),
              f"experiments {cfg.name} {tag}: launches {got}, the structure predicts {want}")
        for k in counts:
            counts[k] += got[k]
        full[tag] = r
        losses = [l for _, l in r.losses]
        check(all(map(math.isfinite, losses)), f"experiments {cfg.name} {tag}: losses {losses}")
        gates[f"{cfg.name} {tag} learns"] = r.final_loss < losses[0]
        log(f"experiments: {cfg.name} {tag:14s} first loss {losses[0]:.4f} final_loss="
            f"{r.final_loss:.4f} ppl={r.ppl:.2f} ({r.seconds:.1f} s, {r.steps_per_s:.2f} "
            f"steps/s, {EXP['full_batch'] * EXP['full_seq'] * r.steps_per_s:.0f} tokens/s); "
            f"launches per step K1 {want['quantize_pack'] // EXP['full_steps']}, K2 "
            f"{want['unpack_dequantize'] // EXP['full_steps']}")
    base, qq = full["baseline-fsdp"].final_loss, full["qsdp-w8g8"].final_loss
    gates[f"{cfg.name} recovery"] = table1_recovery.recovery_gates(base, qq, cfg.vocab_size)[0]
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    log(f"experiments: Table 1 at {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}), batch {EXP['full_batch']} x seq {EXP['full_seq']}, "
        f"{EXP['full_steps']} steps (cut: the paper pretrains to convergence): "
        f"|{qq:.4f} - {base:.4f}| = {abs(qq - base):.4f} <= 8% of baseline "
        f"({table1_recovery.RECOVERY_BAND * base:.4f}): "
        f"{'PASS' if gates[f'{cfg.name} recovery'] else 'FAIL'}; peak memory "
        f"{peak / 2**30:.2f} GiB")
    # where a step's time goes: one profiled W8G8 step of each model
    for c, batch, seq in ((BENCH_MODEL, 8, 128),
                          (cfg, EXP["full_batch"], EXP["full_seq"])):
        prof = profile_experiment_step(torch, log, c, w8g8, batch, seq, dev)
        log(f"experiments: {c.name} W8G8 profiled step: {prof['kernels']} kernels, device busy "
            f"{prof['busy_ms']:.1f} of {prof['wall_ms']:.1f} ms wall "
            f"({100 * prof['busy_ms'] / max(prof['wall_ms'], 1e-9):.1f} %); K1 "
            f"{prof['k1_ms']:.2f} ms in {prof['k1_n']}, K2 {prof['k2_ms']:.2f} ms in "
            f"{prof['k2_n']}")
    failed = sorted(k for k, ok in gates.items() if not ok)
    log(f"experiments: gates {len(gates) - len(failed)}/{len(gates)} pass"
        + (f"; FAILED: {failed}" if failed else ""))
    check(not (enforce and failed), f"experiments: gates failed: {failed}")
    return counts, gates


# ---------------------------------------------------------------------------
# phase 10: the deployment-plan autotuner, both launchers' --plan, the examples
# ---------------------------------------------------------------------------

# the h100 preset's fit: one gpt-1.3b layer at full width, gathered and
# reduce-scattered (forward + backward of QSDPEngine.gather_layer) per
# tensor and coalesced; median of TUNE_FIT_REPS after TUNE_FIT_WARM
TUNE_FIT_ARCH = "gpt-1.3b"
TUNE_FIT_REPS = 20
TUNE_FIT_WARM = 3
# the preset's coalesce decision may go either way when the two measured
# times are this close (relative to the faster)
TUNE_TIE = 0.05
# the autotuner at gpt-125m, full width and depth (its default arch)
TUNE = dict(arch="gpt-125m", batch=8, seq=1024, measure_top=3, steps=3)
# train --plan vs the equivalent flags; serve --plan vs the equivalent flags
TUNE_TRAIN = dict(steps=3, batch=8, seq=1024)
TUNE_SERVE = dict(batch=4, prompt_len=128, gen=16)
TUNE_OUT = "results/torch_tune"
# examples/train_gpt_qsdp at full width: its steps
EXAMPLE_TRAIN_STEPS = 20
# learned_levels' errors on the card vs the CPU (a few f32 sums in
# another order)
LEVELS_RTOL = 1e-4


def layer_gather_seconds(torch, engs, prefix, names, dev, reps=TUNE_FIT_REPS,
                         warm=TUNE_FIT_WARM) -> dict:
    """Median seconds of one layer's gather and gradient reduce-scatter
    under each engine of `engs` ({policy: engine}): forward and backward of
    ``gather_layer`` on the same random shards, between two
    synchronizations, the policies timed in turns (A B, then B A) so that
    the host's drift falls on each alike."""
    from repro_torch.core import prng
    gen = torch.Generator(device=dev).manual_seed(11)
    first = next(iter(engs.values()))
    leaves = {n[len(prefix):]: (torch.randn(first.specs[n].rest_shape(first.ms)[1:],
                                            generator=gen, device=dev) * 0.02).requires_grad_()
              for n in names}
    key = prng.PRNGKey(3)
    outs = first.gather_layer(prefix, leaves, key)
    cts = {k: torch.randn(v.shape, generator=gen, device=dev).to(v.dtype)
           for k, v in outs.items()}
    del outs
    times = {k: [] for k in engs}
    for i in range(warm + reps):
        for k in (list(engs) if i % 2 == 0 else list(engs)[::-1]):
            for leaf in leaves.values():
                leaf.grad = None
            if dev == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            outs = engs[k].gather_layer(prefix, leaves, prng.fold_in(key, i))
            torch.autograd.backward([outs[n] for n in sorted(outs)],
                                    [cts[n] for n in sorted(outs)])
            if dev == "cuda":
                torch.cuda.synchronize()
            if i >= warm:
                times[k].append(time.perf_counter() - t)
            del outs
    return {k: statistics.median(v) for k, v in times.items()}


def fit_cost_params(torch, log, dev="cuda", arch=TUNE_FIT_ARCH, reps=TUNE_FIT_REPS):
    """Fit the cost model's t_launch and ser_bw on one layer of `arch`
    through the model's own equations at wire 0 (one rank):
        t_pt = L_pt * t_launch,   t_co = L_co * t_launch + buf / ser_bw
    with L and buf those of ``layer_gather_cost`` + ``layer_rs_cost`` (the
    gather and its reduce-scatter).  Gate: the committed ``h100`` preset's
    ``plan_layer_policies`` coalesces the layer group iff the coalesced form
    measured faster (either, within TUNE_TIE)."""
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    from repro_torch.tune.cost_model import (HW_PRESETS, layer_gather_cost, layer_groups,
                                             layer_rs_cost, plan_layer_policies)
    cfg = configs.get_config(arch)
    ms = MeshSpec(("data", "model"), (1, 1))
    eng = {co: Model(cfg, ms, QSDPConfig(coalesce=co)).engine for co in (False, True)}
    group, names, _ = next(g for g in layer_groups(eng[True]) if g[2] > 1)
    t = layer_gather_seconds(torch, eng, f"{group}/", names, dev, reps=reps)
    pt = [f(eng[True], names, False) for f in (layer_gather_cost, layer_rs_cost)]
    co = [f(eng[True], names, True) for f in (layer_gather_cost, layer_rs_cost)]
    check(all(c.wire_bytes == 0 for c in pt + co), "tune: wire bytes at one rank must be 0")
    l_pt, l_co = sum(c.launches for c in pt), sum(c.launches for c in co)
    buf = sum(c.ser_bytes for c in co)
    t_launch = t[False] / l_pt
    check(t[True] > l_co * t_launch, f"tune: the coalesced layer ({t[True] * 1e3:.3f} ms) took "
          f"no longer than its {l_co} launches at the per-tensor fit's t_launch "
          f"({t_launch * 1e6:.2f} us): ser_bw has no finite fit")
    ser_bw = buf / (t[True] - l_co * t_launch)
    preset = HW_PRESETS["h100"]
    policies, thresh = plan_layer_policies(eng[True], preset)
    planned = next(p.coalesce for p in policies if p.group == group)
    faster = t[True] < t[False]
    tie = abs(t[True] - t[False]) <= TUNE_TIE * min(t.values())
    log(f"tune: {cfg.name} '{group}' layer (gather + gradient reduce-scatter, median of {reps}): "
        f"per-tensor t_pt {t[False] * 1e3:.4f} ms in L_pt {l_pt} launches, coalesced t_co "
        f"{t[True] * 1e3:.4f} ms in L_co {l_co} over buf {buf} B (gather "
        f"{co[0].ser_bytes} + reduce-scatter {co[1].ser_bytes})")
    log(f"tune: fitted t_launch_s={t_launch:.6e} ser_bw={ser_bw:.6e} B/s; the h100 preset "
        f"t_launch_s={preset.t_launch_s:.6e} ser_bw={preset.ser_bw:.6e} B/s: plan coalesces "
        f"'{group}' {planned} (coalesce_max_bytes={thresh}), measured "
        f"{'coalesced' if faster else 'per-tensor'} faster by "
        f"{abs(t[True] - t[False]) / min(t.values()) * 100:.2f} %")
    check(planned == faster or tie,
          f"tune: the h100 preset {'coalesces' if planned else 'does not coalesce'} "
          f"{cfg.name}'s '{group}' group, but the {'coalesced' if faster else 'per-tensor'} "
          f"form measured faster ({t[True] * 1e3:.4f} vs {t[False] * 1e3:.4f} ms)")


def tune_autotune(torch, log, dev, out, arch=TUNE["arch"], smoke=False, batch=TUNE["batch"],
                  seq=TUNE["seq"], measure_top=TUNE["measure_top"], steps=TUNE["steps"],
                  hw="h100", measured=None):
    """``tune.autotune.main`` on the card; each measured candidate's K1/K2
    launches per step against ``expected_train_launches`` for its policy,
    and the plan's layer policies against the engine its qsdp section
    builds.  Returns (the plan, the launches).  With `measured` (a dict)
    the first candidate's second step (untimed) is profiled for the
    roofline phase and kept there under "<arch> tune"."""
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    from repro_torch.tune import autotune
    from repro_torch.tune import measure as measure_mod
    from repro_torch.tune.cost_model import layer_groups
    from repro_torch.tune.plan import DeploymentPlan

    runs, counts = [], {k: 0 for k in ops.KERNELS}
    cell = {}

    def wrap(orig):
        def f(mcfg, ms, qcfg, batch, **kw):
            ops.reset_launches()
            profile = measured is not None and not runs
            with (hooked(measure_mod, "build_train_step",
                         lambda build: profiled_second_step(torch, log, build, cell))
                  if profile else contextlib.nullcontext()):
                r = orig(mcfg, ms, qcfg, batch, **kw)
            runs.append((mcfg, ms, qcfg, kw, dict(ops.LAUNCHES), r))
            if profile:
                n = 2 + kw["steps"]
                measured[f"{arch} tune"] = dict(
                    cell, step_ms=r["step_ms_median"],
                    launches={k: v // n for k, v in runs[-1][4].items()})
            return r
        return f

    argv = ["--arch", arch, "--data-par", "1", "--model-par", "1", "--hw", hw, "--batch",
            str(batch), "--seq", str(seq), "--measure-top", str(measure_top), "--steps",
            str(steps), "--out", out, "--device", dev] + (["--smoke"] if smoke else [])
    t = time.perf_counter()
    with hooked(autotune, "measure_train_step", wrap):
        rc = autotune.main(argv)
    check(rc == 0, f"tune: autotune exited {rc}")
    check(len(runs) >= min(measure_top, 2), f"tune: {len(runs)} candidates measured")
    for mcfg, ms, qcfg, kw, got, r in runs:
        n = 2 + kw["steps"]  # two untimed steps, then the timed ones
        want = expected_train_launches(Model(mcfg, ms, qcfg), kw["n_micro"])
        for k in ops.KERNELS:
            check(got[k] == n * want.get(k, 0),
                  f"tune: candidate coalesce={qcfg.coalesce} coalesce_max_bytes="
                  f"{qcfg.coalesce_max_bytes}: {k} launched {got[k]} times in {n} steps, the "
                  f"structure predicts {n * want.get(k, 0)}")
        check(math.isfinite(r["loss_final"]), f"tune: a measured loss is {r['loss_final']}")
        for k in counts:
            counts[k] += got[k]
    plan = DeploymentPlan.load(out)
    cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    check(plan.arch == cfg.name and plan.mesh_shape == (1, 1) and plan.hw == hw,
          f"tune: plan for {plan.arch} {plan.mesh_shape} {plan.hw}")
    eng = Model(cfg, MeshSpec(("data", "model"), (1, 1)), plan.to_qsdp_config()).engine
    groups = {g: ns for g, ns, _ in layer_groups(eng)}
    for lp in plan.layers:
        ns = tuple(groups[lp.group])
        check(eng.layer_coalesced(ns) == lp.coalesce
              and eng.layer_wire_bytes(ns) == lp.wire_buffer_bytes,
              f"tune: the plan's policy for '{lp.group}' ({lp}) is not what its qsdp section "
              f"builds (coalesced {eng.layer_coalesced(ns)}, buffer "
              f"{eng.layer_wire_bytes(ns)} B)")
    log(f"tune: autotune {cfg.name} (batch {batch} x seq {seq}, {hw}) in "
        f"{time.perf_counter() - t:.1f} s: {plan.predicted['candidates_evaluated']} "
        f"candidates, crossover {plan.predicted['crossover_buffer_bytes']} B; plan qsdp "
        f"coalesce_max_bytes={plan.qsdp['coalesce_max_bytes']}, layers "
        f"{[(lp.group, lp.coalesce) for lp in plan.layers]}")
    for label, m in plan.measured.items():
        log(f"tune: {label:32s} predicted {m['predicted_ms']:10.4f} ms, measured "
            f"{m['step_ms_median']:10.4f} ms (steps {m['step_ms_all']}, first step "
            f"{m['compile_s']:.3f} s)")
    for mcfg, ms, qcfg, kw, got, r in runs:
        per = {k: got[k] // (2 + kw["steps"]) for k in ("quantize_pack", "unpack_dequantize")}
        log(f"tune: coalesce={qcfg.coalesce} coalesce_max_bytes={qcfg.coalesce_max_bytes}: "
            f"K1 {per['quantize_pack']}, K2 {per['unpack_dequantize']} launches a step "
            "(= the structure's)")
    return plan, counts


def tune_launchers(torch, log, dev, plan_path, plan, arch=TUNE["arch"], smoke=False,
                   train=TUNE_TRAIN, serve=TUNE_SERVE):
    """``launch/train.py --plan`` bit-equal to the equivalent flags (losses
    and config), ``launch/serve.py --plan`` tokens equal to the equivalent
    flags; launches of each run against the structure's.  Returns the
    launches."""
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.models.transformer import Model
    from repro_torch.serve import engine as seng

    cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    ms = MeshSpec(("data", "model"), (1, 1))
    q = plan.qsdp
    counts = {k: 0 for k in ops.KERNELS}
    out_dir = REPO / TUNE_OUT
    out_dir.mkdir(parents=True, exist_ok=True)
    base = ["--arch", arch, "--device", dev] + (["--smoke"] if smoke else [])
    equiv = (["--wbits", str(q["weight_bits"]), "--gbits", str(q["grad_bits"]), "--bucket",
              str(q["bucket_size"]), "--min-quant-size", str(q["min_quant_size"])]
             + ([] if q["coalesce"] else ["--no-coalesce"])
             + (["--prefetch"] if q.get("prefetch") else [])
             + ([] if q["coalesce_max_bytes"] is None
                else ["--coalesce-max-bytes", str(q["coalesce_max_bytes"])]))
    targs = base + ["--steps", str(train["steps"]), "--batch", str(train["batch"]), "--seq",
                    str(train["seq"]), "--log-every", "1"]
    qsdp_plan = ltrain.build_qsdp(ltrain.parse_args(targs + ["--plan", plan_path]))
    qsdp_flags = ltrain.build_qsdp(ltrain.parse_args(targs + equiv))
    check(qsdp_plan == qsdp_flags, f"tune: train --plan builds {qsdp_plan}, the equivalent "
          f"flags {equiv} build {qsdp_flags}")
    logs = {}
    for tag, extra in (("plan", ["--plan", plan_path]), ("flags", equiv)):
        path = out_dir / f"train_{tag}.json"
        ops.reset_launches()
        check(ltrain.main(targs + extra + ["--out-json", str(path)]) == 0,
              f"tune: train --{tag} failed")
        got = dict(ops.LAUNCHES)
        want = expected_train_launches(Model(cfg, ms, qsdp_plan), 1)
        for k in ops.KERNELS:
            check(got[k] == train["steps"] * want.get(k, 0),
                  f"tune: train ({tag}) {k} launched {got[k]} times, the structure predicts "
                  f"{train['steps'] * want.get(k, 0)}")
        for k in counts:
            counts[k] += got[k]
        logs[tag] = [e["loss"] for e in json.loads(path.read_text())["log"]]
    check(logs["plan"] == logs["flags"] and all(map(math.isfinite, logs["plan"])),
          f"tune: train --plan losses {logs['plan']} != equivalent flags' {logs['flags']}")
    log(f"tune: launch/train.py --plan == {' '.join(equiv)}: {cfg.name} losses "
        f"{logs['plan']} over {train['steps']} steps (batch {train['batch']} x seq "
        f"{train['seq']}), bit-equal")

    toks = {}
    sargs = base + ["--batch", str(serve["batch"]), "--prompt-len", str(serve["prompt_len"]),
                    "--gen", str(serve["gen"])]
    # the serve launcher's only policy flag is --wbits: the plan's policy
    # differs from the flags' in the per-layer coalesce threshold and
    # prefetch alone, which move launches, never values (no serving path
    # runs the prefetch pipeline)
    wb = ["--wbits", str(q["weight_bits"])]
    serve_qsdp = {"plan": plan.to_qsdp_config(), "flags": QSDPConfig(weight_bits=q["weight_bits"])}
    check(dataclasses.replace(serve_qsdp["plan"], coalesce_max_bytes=None, coalesce=True,
                              prefetch=False)
          == serve_qsdp["flags"], f"tune: the plan's policy {serve_qsdp['plan']} differs from "
          f"{' '.join(wb)}'s in more than the coalesce threshold and prefetch")
    for tag, extra in (("plan", ["--plan", plan_path]), ("flags", wb)):
        outs = []

        def wrap(orig):
            def f(self, *a, **k):
                o = orig(self, *a, **k)
                outs.append(o.cpu())
                return o
            return f

        ops.reset_launches()
        with hooked(seng.ServeEngine, "generate", wrap):
            check(lserve.main(sargs + extra) == 0, f"tune: serve --{tag} failed")
        got = dict(ops.LAUNCHES)
        want = expected_launches(Model(cfg, ms, serve_qsdp[tag]), serve["gen"], rowquant=False)
        for k in ops.KERNELS:
            check(got[k] == want.get(k, 0), f"tune: serve ({tag}) {k} launched {got[k]} times, "
                  f"the structure predicts {want.get(k, 0)}")
        for k in counts:
            counts[k] += got[k]
        check(len(outs) == 1, f"tune: serve ({tag}) called generate {len(outs)} times")
        toks[tag] = outs[0]
    check(toks["plan"].shape == (serve["batch"], serve["gen"])
          and torch.equal(toks["plan"], toks["flags"]),
          f"tune: serve --plan tokens differ from {' '.join(wb)}'s")
    log(f"tune: launch/serve.py --plan == {' '.join(wb)}: {cfg.name} batch {serve['batch']} x "
        f"prompt {serve['prompt_len']} x gen {serve['gen']}, tokens equal (first row "
        f"{toks['plan'][0].tolist()})")
    return counts


def tune_examples(torch, log, dev, train_steps=EXAMPLE_TRAIN_STEPS, full_width=True):
    """The examples' one-rank twins on the card: learned_levels (yi-6b's
    smoke config; every tensor's learned levels beat the uniform grid, and
    its errors agree with the CPU's on the same weights), quickstart
    (gpt-125m smoke: finite losses, tokens of the vocabulary) and
    train_gpt_qsdp (`full_width`: gpt-125m at full width and depth; the
    last logged loss below the first).  Returns the launches."""
    from repro_torch.examples import learned_levels, quickstart, train_gpt_qsdp
    from repro_torch.kernels import ops
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model

    counts = {k: 0 for k in ops.KERNELS}
    dv = ["--device", dev]
    t = time.perf_counter()
    ops.reset_launches()
    rows = learned_levels.main(dv)
    model = Model(configs.get_smoke("yi-6b"), MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
    cpu_rows = learned_levels.level_errors(
        {k: v.cpu() for k, v in model.init_params(0, dev).items()})
    check(rows and [r["name"] for r in rows] == [r["name"] for r in cpu_rows],
          "tune: learned_levels rows")
    rel = max(abs(r[k] - c[k]) / c[k] for r, c in zip(rows, cpu_rows)
              for k in ("uniform", "learned"))
    check(all(r["learned"] < r["uniform"] for r in rows) and rel <= LEVELS_RTOL,
          f"tune: learned_levels: learned {[r['learned'] for r in rows]} vs uniform "
          f"{[r['uniform'] for r in rows]}, card vs CPU {rel:.2e} (tol {LEVELS_RTOL})")
    log(f"tune: examples/learned_levels (yi-6b smoke, {len(rows)} tensors): learned "
        f"{min(r['learned'] for r in rows):.4f}-{max(r['learned'] for r in rows):.4f} < "
        f"uniform {min(r['uniform'] for r in rows):.4f}-{max(r['uniform'] for r in rows):.4f}; "
        f"card vs CPU within {rel:.2e} relative")
    losses, out = quickstart.main(dv)
    vocab = configs.get_smoke("gpt-125m").vocab_size
    check(all(map(math.isfinite, losses)) and tuple(out.shape) == (8, 8)
          and 0 <= int(out.min()) and int(out.max()) < vocab,
          f"tune: quickstart losses {losses}, tokens {tuple(out.shape)}")
    log(f"tune: examples/quickstart: losses {[round(x, 4) for x in losses]}, generated "
        f"{out[0].tolist()}")
    log_ = train_gpt_qsdp.main(["--steps", str(train_steps)] + (["--full-width"] if full_width
                                                               else []) + dv)
    check(len(log_) >= 2 and all(math.isfinite(e["loss"]) for e in log_)
          and log_[-1]["loss"] < log_[0]["loss"],
          f"tune: train_gpt_qsdp losses {[e['loss'] for e in log_]}")
    log(f"tune: examples/train_gpt_qsdp{' --full-width' if full_width else ''} "
        f"--steps {train_steps}: loss {log_[0]['loss']:.4f} -> {log_[-1]['loss']:.4f} "
        f"({log_[-1]['t']:.1f} s)")
    got = dict(ops.LAUNCHES)
    check(got["quantize_pack"] > 0 and got["unpack_dequantize"] > 0,
          f"tune: examples launched {got}")
    for k in counts:
        counts[k] += got[k]
    log(f"tune: examples in {time.perf_counter() - t:.1f} s, launches {got}")
    return counts


def tune_phase(torch, log, dev="cuda", measured=None):
    """The autotuner on one card: fit the h100 preset's constants and gate
    its coalesce decision, autotune gpt-125m at full width and depth
    (measured shortlist), drive both launchers with the plan, run the
    examples.  Returns the launches of the autotuner's measured steps, the
    launchers' and the examples' runs.  `measured`: as for
    ``tune_autotune``."""
    t = time.perf_counter()
    fit_cost_params(torch, log, dev)
    out_dir = REPO / TUNE_OUT
    out_dir.mkdir(parents=True, exist_ok=True)
    plan_path = str(out_dir / "plan_gpt125m_h100.json")
    plan, counts = tune_autotune(torch, log, dev, plan_path, measured=measured)
    for part in (tune_launchers(torch, log, dev, plan_path, plan),
                 tune_examples(torch, log, dev)):
        for k in counts:
            counts[k] += part[k]
    log(f"tune: phase {time.perf_counter() - t:.1f} s; launches {counts}")
    return counts


def profiled_second_step(torch, log, build, store):
    """A ``build_train_step`` whose step profiles its second call (the
    measurement's untimed warm step) for the roofline phase: the model, the
    optimizer, the microbatches, the batch and ``profile_train_step``'s
    numbers (with `flops`) go into `store`."""
    def build_profiled(model, opt, **kw):
        step = build(model, opt, **kw)
        calls = []

        def run(state, batch, key):
            calls.append(1)
            if len(calls) != 2:
                return step(state, batch, key)
            out = []
            prof = profile_train_step(torch, lambda st: out.append(step(st, batch, key)), state,
                                      log, tag=f"roofline {model.cfg.name}", flops=True)
            store.update(model=model, opt=opt, n_micro=kw.get("n_micro", 1), batch=batch,
                         prof=prof)
            return out[0]
        return run
    return build_profiled


# ---------------------------------------------------------------------------
# phase 11: the roofline of the profiled train steps, counted on meta
# ---------------------------------------------------------------------------

# the dry run's pair run on the card's host, so that its torch's meta path is
# exercised
ROOFLINE_PAIR = ("gpt-1.3b", "decode_32k")
ROOFLINE_FLOPS_RTOL = 0.01  # counted vs the profiler's own product FLOPs
ROOFLINE_PEAK_RTOL = 0.10   # counted vs measured peak device memory
# the products the counter counts as the profiler names them
PROFILER_PRODUCTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def count_cell(torch, m):
    """A measured train cell's step counted on the meta device: the same
    model, optimizer, microbatches and batch shapes (``launch.dryrun``'s
    counter, the step run once at its microbatches)."""
    from repro_torch.launch import dryrun
    batch = {k: torch.empty_like(v, device="meta") for k, v in m["batch"].items()}
    step = dryrun.train_step(m["model"], m["opt"], batch, m["n_micro"])
    c = dryrun.count(step, m["n_micro"])
    c["collectives"] = dryrun.collectives(m["model"], "train", c)
    return c


def roofline_phase(torch, log, measured, card, dev="cuda"):
    """Each measured train step (``measured``: the train phase's gpt-1.3b
    cell, the tune phase's gpt-125m step) counted on meta and held against
    its profiled run: the counted K1/K2 launches equal the structure's and
    the real step's, the counted product FLOPs the profiler's within 1 %,
    the device's busy time at least the larger of the dtype-aware compute
    floor and the optimistic memory term, the counted peak of live bytes
    within 10 % of the measured peak.  Then the dry run's ROOFLINE_PAIR on
    this host.  Returns the records."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.roofline import HW_H100, compute_floor, roofline
    t = time.perf_counter()
    check(measured, "roofline: no profiled train step to hold the counts against (the train "
          "and tune phases take them)")
    out = {}
    for tag, m in measured.items():
        tc = time.perf_counter()
        c = count_cell(torch, m)
        tc = time.perf_counter() - tc
        model, prof = m["model"], m["prof"]
        cfg = model.cfg
        tokens = sum(v.shape[0] * v.shape[1] for k, v in m["batch"].items() if k == "tokens")
        rep = roofline(cfg.name, tag, dryrun.MESH, c, dryrun.N_CHIPS,
                       6.0 * cfg.n_active_params() * tokens, HW_H100)
        floor = compute_floor(c["flops_by_dtype"])
        larger = max(floor, rep.t_memory_min)
        want = expected_train_launches(model, m["n_micro"])
        for k in ("quantize_pack", "unpack_dequantize"):
            check(c["launches"].get(k, 0) == want[k] == m["launches"][k],
                  f"roofline {tag}: {k} counted {c['launches'].get(k, 0)} launches on meta, the "
                  f"structure predicts {want[k]}, the card's step launched {m['launches'][k]}")
        check(all(c["launches"].get(k, 0) == m["launches"].get(k, 0) for k in ops.KERNELS),
              f"roofline {tag}: counted launches {c['launches']}, the card's {m['launches']}")
        counted_mm = sum(v for k, v in c["flops_by_op"].items()
                         if "aten::" + k in PROFILER_PRODUCTS)
        err = abs(counted_mm - prof["mm_flops"]) / max(prof["mm_flops"], 1)
        check(err <= ROOFLINE_FLOPS_RTOL,
              f"roofline {tag}: counted product FLOPs {counted_mm:.6e}, the profiler's "
              f"{prof['mm_flops']:.6e} ({100 * err:.3f} % apart)")
        busy = prof["busy_ms"] / 1e3
        check(busy >= larger, f"roofline {tag}: the card was busy {busy * 1e3:.3f} ms, below the "
              f"counted floor {larger * 1e3:.3f} ms (a counting fault)")
        want_peak = prof["mem_before"] + c["peak_live_bytes"] - c["base_bytes"]
        perr = abs(want_peak - prof["mem_peak"]) / prof["mem_peak"]
        check(perr <= ROOFLINE_PEAK_RTOL,
              f"roofline {tag}: counted peak {want_peak / 2**30:.3f} GiB (the {prof['mem_before'] / 2**30:.3f} "
              f"GiB allocated before the step + {(c['peak_live_bytes'] - c['base_bytes']) / 2**30:.3f} "
              f"counted), measured {prof['mem_peak'] / 2**30:.3f} GiB ({100 * perr:.2f} % apart)")
        log(f"roofline {tag} ({card}): counted on meta in {tc:.1f} s: flops {c['flops']:.6e} "
            f"{c['flops_by_dtype']}, traffic {c['traffic_bytes']:.6e} B, traffic_min "
            f"{c['traffic_min_bytes']:.6e} B, peak_live {c['peak_live_bytes'] / 2**30:.3f} GiB "
            f"(state and batch {c['base_bytes'] / 2**30:.3f}), launches {c['launches']}")
        log(f"roofline {tag}: at the published peaks (bf16 {HW_H100.peak_flops / 1e12:.0f} "
            f"TFLOP/s, HBM {HW_H100.hbm_bw / 1e12:.2f} TB/s): t_compute "
            f"{rep.t_compute * 1e3:.3f} ms, t_memory {rep.t_memory * 1e3:.3f} ms, t_memory_min "
            f"{rep.t_memory_min * 1e3:.3f} ms, t_collective {rep.t_collective * 1e3:.3f} ms -> "
            f"{rep.bottleneck}, useful {rep.useful_flops_ratio:.4f}; dtype-aware compute floor "
            f"{floor * 1e3:.3f} ms (f32 products at 67 TFLOP/s)")
        log(f"roofline {tag}: measured step {m['step_ms']:.1f} ms, profiled step busy "
            f"{prof['busy_ms']:.1f} ms of {prof['wall_ms']:.1f} wall: busy / larger floor "
            f"{busy / larger:.3f}; product FLOPs counted {counted_mm:.6e}, profiler "
            f"{prof['mm_flops']:.6e} ({100 * err:.3f} % apart; it also recorded "
            f"{prof['mm_unlaunched']:.6e} in product ops that launched no kernel); peak counted "
            f"{want_peak / 2**30:.3f} GiB, measured {prof['mem_peak'] / 2**30:.3f} GiB "
            f"({100 * perr:.2f} % apart); launches {m['launches']}")
        out[tag] = dict(rep.to_dict(), floor_s=floor, busy_s=busy, step_ms=m["step_ms"])
    tp = time.perf_counter()
    r = dryrun.run_one(*ROOFLINE_PAIR, verbose=False)
    check(r.get("ok"), f"roofline: the dry run's {ROOFLINE_PAIR} pair failed")
    log(f"roofline: dry run {ROOFLINE_PAIR[0]} x {ROOFLINE_PAIR[1]} on this host's torch "
        f"{torch.__version__}: ok in {time.perf_counter() - tp:.1f} s, t_compute "
        f"{r['t_compute'] * 1e3:.3f} ms, t_memory_min {r['t_memory_min'] * 1e3:.3f} ms -> "
        f"{r['bottleneck']}, launches {r['launches']}, state {r['memory']['args'] / 2**30:.2f} GiB")
    log(f"roofline: phase {time.perf_counter() - t:.1f} s")
    out[ROOFLINE_PAIR] = r
    return out


# ---------------------------------------------------------------------------
# phase 12: qlint's trace audit on the card (the reference's jaxpr audit)
# ---------------------------------------------------------------------------

# the programs the speculative and train phases trace on the card, and the
# analysis phase traces again on meta at the same configurations
ANALYSIS_TAGS = ("train-step[f32]", "train-step[qstate]", "decode_fn", "prefill_chunk_fn",
                 "verify_fn")
ANALYSIS_BASELINE = "src/repro_torch/analysis/qlint_baseline.json"


def card_traces(torch, programs: dict, built: dict, dev="cuda") -> dict:
    """Run each of `programs` ({tag: run}) once on the card under the trace
    audit's dispatch mode (``analysis.trace_audit.trace``): the kernel
    launches the trace recorded must equal the wrappers' count
    (``kernels.ops.LAUNCHES``) over the run.  Keeps each program's findings
    and launches in ``built["card"]`` and their seconds in
    ``built["seconds"]``; returns {tag: the program's result}."""
    from repro_torch.analysis import trace_audit
    from repro_torch.kernels import ops

    out = {}
    for tag, fn in programs.items():
        before = dict(ops.LAUNCHES)
        t = time.perf_counter()
        traced = trace_audit.trace(fn, tag, bit_identity=tag in trace_audit.SERVE_TAGS)
        if dev == "cuda":
            torch.cuda.synchronize()
        built["seconds"] = built.get("seconds", 0.0) + time.perf_counter() - t
        delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.KERNELS
                 if ops.LAUNCHES[k] != before[k]}
        check(traced.launches == delta, f"analysis {tag}: the trace recorded launches "
              f"{traced.launches}, the wrappers counted {delta}")
        out[tag] = traced.result
        built.setdefault("card", {})[tag] = dataclasses.replace(traced, result=None)
    return out


def analysis_meta_programs() -> dict:
    """The card's traced programs on meta at the card's configurations:
    gpt-1.3b at full width and depth served as the speculative phase serves
    it (CONT with SPEC's draft: paged pool, sampling, chunk bucket 64, the
    fixed-shape route) and trained as the train phase trains it (TRAIN's
    batch, sequence and microbatches; AdamW with f32 moments, and with 8-bit
    moments for the quantized-domain step)."""
    from repro_torch import configs
    from repro_torch.analysis import trace_audit
    from repro_torch.core.qsdp import QSDPConfig
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw

    gen_max = max(g for *_, g in CONT_PLAN)
    progs = trace_audit.meta_serve_programs(
        configs.get_config(CONT_ARCH), bucket=CONT["chunk"], batch=CONT["slots"],
        prompt_len=CONT["ring"] - gen_max, gen=gen_max, seed=CONT["seed"], sampling=True,
        kv_block_size=CONT["block"], kv_pool_blocks=CONT["pool_blocks"], **SPEC)
    sched = cosine_schedule(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])
    for tag, bits in (("train-step[f32]", None), ("train-step[qstate]", 8)):
        opt = make_adamw(AdamWConfig(lr=TRAIN["lr"], schedule=sched, moment_bits=bits))
        progs[tag] = trace_audit.meta_train_program(
            configs.get_config("gpt-1.3b"), QSDPConfig(), opt, TRAIN["n_micro"], TRAIN["batch"],
            TRAIN["seq"], quantized_state=bits is not None)
    return progs


def analysis_phase(torch, log, built: dict) -> None:
    """qlint's trace audit (``repro_torch.analysis.trace_audit``) on the
    card and on meta: the speculative and train phases traced gpt-1.3b's
    decode step, chunked-prefill launch, verify launch, f32 train step and
    quantized-domain train step on the card over real launches
    (:func:`card_traces`, the traces' launches equal to the wrappers'
    counts); this phase traces the same programs on the meta device at the
    same configurations.  Gates: per program the findings on the card equal
    those on meta and so do the kernel launches; no finding is new against
    the port's qlint baseline."""
    from repro_torch.analysis import trace_audit
    from repro_torch.analysis.findings import load_baseline, partition_findings

    t = time.perf_counter()
    card = built.get("card", {})
    check(set(card) == set(ANALYSIS_TAGS), f"analysis: the card traced {sorted(card)}, not "
          f"{list(ANALYSIS_TAGS)} (the phase reads the speculative and train phases' traces)")
    meta = trace_audit.trace_programs(analysis_meta_programs())
    t_meta = time.perf_counter() - t
    for tag in ANALYSIS_TAGS:
        got = sorted(f.ident() for f in card[tag].findings)
        want = sorted(f.ident() for f in meta[tag].findings)
        check(got == want, f"analysis {tag}: findings on the card {got} != on meta {want}")
        check(card[tag].launches == meta[tag].launches,
              f"analysis {tag}: launches on the card {card[tag].launches} != on meta "
              f"{meta[tag].launches}")
        log(f"analysis {tag}: card == meta: findings {[s for _, s in got] or 'none'}; "
            f"launches {card[tag].launches}")
    findings = [f for tag in ANALYSIS_TAGS for f in card[tag].findings]
    new, suppressed, _ = partition_findings(findings, load_baseline(str(REPO / ANALYSIS_BASELINE)))
    check(not new, f"analysis: findings new against {ANALYSIS_BASELINE}: {[str(f) for f in new]}")
    log(f"analysis: {len(findings)} finding(s) on the card, all in the baseline "
        f"({[f.ident() for f in suppressed]}); card traces {built.get('seconds', 0.0):.1f} s "
        f"(in the speculative and train phases), meta twin {t_meta:.1f} s; phase "
        f"{time.perf_counter() - t:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: data-parallel QSDP over torch.distributed
# ---------------------------------------------------------------------------

DIST_ARCH = "gpt-1.3b"
# the P-rank wire work, emulated in one process: a gpt-1.3b layer's table
# holds 7 P entries, inside one K2 launch's 64 up to P = 9
DIST_PS = (2, 4, 8)
# the entry point under torchrun: gpt-125m, 3 steps of the launcher's
# default batch (16 x 256)
DIST_LAUNCH = ["--arch", "gpt-125m", "--steps", "3", "--log-every", "1"]
DIST_NOTE = ("NCCL at more than one rank (P > 1 or M > 1) has not run on a card; it waits "
             "for a four-chip cell.")
# torch.distributed's ops by the counter's names, as an event name of the
# profiler may spell them
DIST_OP_TOKENS = {"all_gather": ("all_gather", "allgather"),
                  "all_to_all": ("all_to_all", "alltoall"),
                  "reduce_scatter": ("reduce_scatter", "reducescatter"),
                  "all_reduce": ("all_reduce", "allreduce")}


def dist_events(prof) -> dict:
    """{(device, event name): count} of the profiled events whose name
    names NCCL or gloo (torch's records of the collectives and the NCCL
    kernels)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if "nccl" in name.lower() or "gloo" in name.lower():
            key = (str(e.device_type()).split(".")[-1], name)
            out[key] = out.get(key, 0) + 1
    return out


def device_digest(torch, t, chunk=1 << 26) -> tuple[int, int]:
    """Two position-weighted sums (mod 2^64) of a tensor's 32-bit words (its
    bytes where its size is not a multiple of 4), computed on its device a
    chunk at a time: any one changed word changes both (the weights are
    odd), so two runs' states compare without a host copy."""
    w = t.detach().reshape(-1).view(torch.uint8)
    w = w.view(torch.int32) if w.numel() % 4 == 0 else w
    s1 = s2 = 0
    for a in range(0, w.numel(), chunk):
        x = w[a:a + chunk].to(torch.int64)
        i = torch.arange(a, a + x.numel(), device=x.device, dtype=torch.int64)
        s1 += int((x * (i * 2654435761 + 1)).sum())
        s2 += int((x * (i * 40503 + 2246822519) + i).sum())
    return s1 % 2**64, s2 % 2**64


def dist_setup(dev):
    """The dist phase's gpt-1.3b train set-up: (config, mesh, optimizer,
    batch, key), TRAIN's batch, sequence and schedule."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
    cfg = configs.get_config(DIST_ARCH)
    opt = make_adamw(AdamWConfig(lr=TRAIN["lr"], schedule=cosine_schedule(
        TRAIN["lr"], TRAIN["warmup"], TRAIN["total"])))
    data = SyntheticLM(cfg.vocab_size, TRAIN["seq"], TRAIN["batch"], seed=TRAIN["seed"])
    return (cfg, MeshSpec(("data", "model"), (1, 1)), opt, make_batch(data, 0, dev),
            prng.fold_in(prng.PRNGKey(TRAIN["seed"] + 1), 0))


def dist_step(torch, groups, dev, profile=False):
    """One gpt-1.3b train step from the state made anew from the seed,
    through `groups` (the data and model groups; (None, None): in place),
    its launches and calls into torch.distributed counted from zero; with
    `profile`, under the profiler (host activity: torch's records of the
    collectives).  Returns the state, the run's record and the model."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.qsdp import QSDPConfig
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    from repro_torch.train.step import build_train_step, init_train_state
    cfg, ms, opt, batch, key = dist_setup(dev)
    model = Model(cfg, ms, QSDPConfig(), *groups)
    step = build_train_step(model, opt, n_micro=TRAIN["n_micro"], device=dev)
    state = init_train_state(model, opt, TRAIN["seed"], dev)
    ops.reset_launches()
    coll.reset_comm()
    events = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        with tprofile(activities=[ProfilerActivity.CPU]) as prof:
            state, loss, gnorm, dt = timed_step(torch, step, state, batch, key)
        events = dist_events(prof)
    else:
        state, loss, gnorm, dt = timed_step(torch, step, state, batch, key)
    return state, dict(loss=loss, gnorm=gnorm, dt=dt, launches=dict(ops.LAUNCHES),
                       comm=dict(coll.COMM), comm_bytes=dict(coll.COMM_BYTES),
                       events=events), model


def dist_nccl_step(torch, log, dev="cuda", profile=True, during=None):
    """(a): one train step of gpt-1.3b at full width and depth through the
    groups of the one-rank (data, model) grid (``init_distributed``: NCCL on
    the card, gloo on the CPU), formed through a FileStore in a temporary
    directory, and the same step with no group, each from the state made
    anew from the seed: loss, grad
    norm, every updated parameter and moment bit-equal (device digests);
    K1/K2 launches equal to the structure's in both; the calls into
    torch.distributed by op equal to ``expected_train_comm`` (and none
    without the group).  With `profile`, a first step through the group
    runs under the profiler (`during()` runs after it, e.g. waiting for the
    launcher runs started beside it): torch's records of the collectives
    as many as the counter's calls; the timed steps follow it.  Returns the
    group step's launches (the main path's)."""
    import os
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.kernels import ops

    cfg, ms, _, _, _ = dist_setup(dev)
    with tempfile.TemporaryDirectory() as tmp:
        group, model_group, coords, gdev = init_distributed(dev, ms, store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        check(coords == (0, 0), f"dist: the one-rank grid put rank 0 at {coords}")
        groups = (group, model_group)
        backend = dist.get_backend()
        try:
            prof = None
            if profile:
                st, prof, _ = dist_step(torch, groups, gdev, profile=True)
                del st
            if during is not None:
                during()
            st, n, model = dist_step(torch, (None, None), gdev)
            want_dig = {k: device_digest(torch, v) for k, v in state_tensors(st).items()}
            del st
            st, g, _ = dist_step(torch, groups, gdev)
            got_dig = {k: device_digest(torch, v) for k, v in state_tensors(st).items()}
            n_leaves = len(st.params)
            del st
        finally:
            dist.destroy_process_group()
    check(g["loss"] == n["loss"] and g["gnorm"] == n["gnorm"],
          f"dist: {backend} step loss {g['loss']} / norm {g['gnorm']}, group=None "
          f"{n['loss']} / {n['gnorm']}")
    bad = sorted(k for k in want_dig if got_dig[k] != want_dig[k])
    check(not bad and set(got_dig) == set(want_dig),
          f"dist: {bad} differ between the one-rank {backend} group's step and group=None's")
    want = expected_train_launches(model, TRAIN["n_micro"])
    for r in (g, n) + ((prof,) if prof else ()):
        for k in ops.KERNELS:
            check(r["launches"][k] == want.get(k, 0),
                  f"dist: {k} launched {r['launches'][k]} times, the structure predicts "
                  f"{want.get(k, 0)}")
    want_comm = expected_train_comm(model, TRAIN["n_micro"])
    for r in (g,) + ((prof,) if prof else ()):
        check(r["comm"] == want_comm and not any(r["comm_bytes"].values()),
              f"dist: calls into torch.distributed {r['comm']} (bytes {r['comm_bytes']}), the "
              f"structure predicts {want_comm} (and no byte from another rank)")
    check(not any(n["comm"].values()), f"dist: group=None called torch.distributed {n['comm']}")
    log(f"dist: {DIST_ARCH} at full width and depth, batch {TRAIN['batch']} x seq "
        f"{TRAIN['seq']}, n_micro {TRAIN['n_micro']}: one step through the one-rank (data, "
        f"model) grid of {backend} groups bit-equal to group=None (loss {g['loss']}, grad "
        f"norm {g['gnorm']}, the "
        f"digests of all {n_leaves} parameters and both moments); {g['dt'] * 1e3:.1f} ms "
        f"through the group, {n['dt'] * 1e3:.1f} ms in place (each a first step from the "
        f"seed's state); launches {g['launches']}; calls into torch.distributed "
        f"{g['comm']} == the structure's")
    if prof:
        for (devtype, name), c in sorted(prof["events"].items()):
            log(f"dist: profiler event {devtype} {name!r} x {c}")
        for op, c in want_comm.items():
            toks = DIST_OP_TOKENS[op]
            seen = {k: v for k, v in prof["events"].items()
                    if any(t in k[1].lower() for t in toks)}
            check(c == 0 and not seen or c in seen.values(),
                  f"dist: the profiler's {op} records {seen}, the counter's calls {c}")
    return g["launches"]


def dist_launch_start(torch, dev="cuda", extra=()):
    """(b), started: the train launcher ``--data-par 1 --model-par 1`` under
    ``torch.distributed.run --standalone --nproc_per_node 1`` and without
    it, side by side in processes of their own (the same environment, one
    intra-op thread), each logging to a JSON file.  Returns [(process, json
    path, stderr path)] for torchrun and for the plain launcher."""
    import os
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    flags = [*DIST_LAUNCH, *extra, "--data-par", "1", "--model-par", "1"] + (
        ["--device", dev] if dev != "cuda" else [])
    out = []
    for tag, head in (("torchrun", ["-m", "torch.distributed.run", "--standalone",
                                    "--nproc_per_node", "1"]), ("plain", [])):
        js, err = os.path.join(tmp, f"{tag}.json"), os.path.join(tmp, f"{tag}.err")
        with open(err, "w") as f:
            out.append((subprocess.Popen(
                [sys.executable, *head, "-m", "repro_torch.launch.train", *flags,
                 "--out-json", js], stdout=subprocess.DEVNULL, stderr=f, env=env, cwd=REPO),
                js, err))
    return out


def dist_launch_check(torch, log, started):
    """(b): the torchrun run's losses bit-equal to the plain launcher's."""
    import os
    t = time.perf_counter()
    losses = []
    for proc, js, err in started:
        try:
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(rc == 0, f"dist: {proc.args[1:5]} exited {rc}: {Path(err).read_text()[-2000:]}")
        losses.append([e["loss"] for e in json.loads(Path(js).read_text())["log"]])
        os.remove(js)
        os.remove(err)
    os.rmdir(os.path.dirname(started[0][1]))
    lt, lp = losses
    check(lt == lp and len(lt) == 3, f"dist: torchrun losses {lt}, the plain launcher's {lp}")
    log(f"dist: torchrun --nproc_per_node 1 -m repro_torch.launch.train {' '.join(DIST_LAUNCH)} "
        f"--data-par 1 --model-par 1: losses {lt} bit-equal to the launcher's without "
        f"torchrun (both "
        f"processes done {time.perf_counter() - t:.1f} s after the phase's first wait)")


def dist_layout(eng, names, p, grad=False):
    """The wire layout of one gather (or, `grad`, one reduce-scatter) of
    `names` at the (P, M) mesh under `eng`'s policy, M the engine's model
    axis: the engine's segments with the tp-local shard size of P ranks."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.qsdp import MeshSpec
    ms = MeshSpec(("data", "model"), (p, eng.ms.model_size))
    c = eng.cfg
    return coll.WireLayout(tuple(
        coll.WireSegment(eng.specs[n].n_local(ms),
                         (c.gcfg() if eng._is_grad_quantized(eng.specs[n]) else None) if grad
                         else (c.wcfg() if eng._is_quantized(eng.specs[n]) else None),
                         c.grad_wire_dtype if grad else c.weight_wire_dtype)
        for n in names))


@contextlib.contextmanager
def plain_kernels(ops, ref):
    """K1 and K2's wrappers swapped for their plain versions (on any
    device) while the block runs."""
    def k1(orig):
        def f(x, key, levels, bits, mode="nearest", rand_bits=32, out=None):
            check(out is None, "plain K1 swap: out= is not taken")
            return ref.quantize_pack_key_ref(x, key, levels, bits, mode, rand_bits)
        return f
    with hooked(ops, "quantize_pack", k1), \
            hooked(ops, "unpack_dequantize_wire",
                   lambda orig: lambda bufs, table, dts: ref.unpack_dequantize_wire_ref(
                       bufs, table, dts)):
        yield


def dist_wire(torch, log, dev="cuda", decode_row=None, addcmul_ms=None):
    """(c): the wire work of P ranks for one gpt-1.3b layer and its
    gradient, the ranks emulated in this process, at each P of DIST_PS.
    Each rank encodes its own shard of every weight under the shared key
    (K1, W8 shift); the gathered buffer is the ranks' buffers end to end
    (what ``all_gather_into_tensor`` delivers), decoded by one K2 launch over
    the P-row table (``decode_gathered_wire``).  Each rank builds its P
    destination rows of the gradient (K1, G8 stochastic, ``split(key,
    P)``), and each destination dequant-sums the P rows it receives
    (``decode_rs_rows``).  Gate: the buffers, the decoded weights and the
    summed chunks byte-equal to the same functions with K1 and K2's plain
    versions.  With `decode_row` and `addcmul_ms` (the kernel phase's), the
    gathered layer's K2 decode is timed against its bound and beside
    ``torch.addcmul``: the rows returned (off the one-rank main path)."""
    from repro_torch import configs
    from repro_torch.core import collectives as coll
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.kernels import cost, ops, ref
    from repro_torch.models.transformer import Model

    eng = Model(configs.get_config(DIST_ARCH), MeshSpec(("data", "model"), (1, 1)),
                QSDPConfig()).engine
    names = tuple(sorted(n for n in eng.specs if n.startswith("layers/")))
    rows = []
    for p in DIST_PS:
        lay, rs_lay = dist_layout(eng, names, p), dist_layout(eng, names, p, grad=True)
        keys = [prng.fold_in(prng.PRNGKey(31), i) if s.cfg is not None else None
                for i, s in enumerate(lay.segments)]
        rkeys = [prng.fold_in(prng.PRNGKey(32), i) if s.cfg is not None else None
                 for i, s in enumerate(rs_lay.segments)]
        out_dts = [eng.compute_dtype if s.cfg is not None else torch.float32
                   for s in lay.segments]
        gen = torch.Generator(device=dev).manual_seed(100 + p)
        xs = [[torch.randn(s.n, generator=gen, device=dev) * 0.02 for s in lay.segments]
              for _ in range(p)]
        gs = [[torch.randn(p * s.n, generator=gen, device=dev) * 1e-3 for s in rs_lay.segments]
              for _ in range(p)]

        def work():
            gbuf = torch.cat([coll.encode_wire(x, lay, keys) for x in xs])
            dec = coll.decode_gathered_wire(gbuf, lay, p, out_dts)
            sent = [coll.encode_rs_rows(g, rs_lay, rkeys, p) for g in gs]
            summed = [coll.decode_rs_rows(torch.stack([r[d] for r in sent]), rs_lay)
                      for d in range(p)]
            return gbuf, dec, summed

        got = work()
        with plain_kernels(ops, ref):
            want = work()
        check(torch.equal(got[0], want[0]), f"dist P={p}: gathered buffers differ")
        for a, b in zip(got[1] + sum(got[2], []), want[1] + sum(want[2], []), strict=True):
            check(a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
                  f"dist P={p}: decoded values differ from the plain versions'")
        gbuf = got[0]
        del xs, gs, got, want
        table, dts = coll.wire_table(lay, p, out_dts)
        n_launch = -(-len(table) // ops.WIRE_MAX_SEGS)
        what = f"{DIST_ARCH} gathered layer, P = {p} ({len(table)} entries), bf16 out"
        line = (f"dist: P = {p}: {p} ranks' encodes of a {DIST_ARCH} layer ({len(names)} "
                f"tensors, {gbuf.numel()} gathered bytes), its decode in {n_launch} K2 "
                f"launch(es) over a table of {len(table)} entries (of {ops.WIRE_MAX_SEGS} a "
                f"launch), and the gradient's {p} x {p} destination rows dequant-summed: "
                "byte-equal to the plain versions")
        if decode_row is not None:
            row = decode_row(what, sum(t.nb for t in table),
                             lambda: ops.unpack_dequantize_wire(gbuf, table, dts),
                             lambda: ref.unpack_dequantize_wire_ref(gbuf, table, dts),
                             wire_addcmul(torch, addcmul_ms, gbuf, table, dts),
                             cost.unpack_dequantize_wire(table, [d.itemsize for d in dts]))
            rows.append(dict(row, p=p, table=len(table), launches=n_launch, main_path=False))
            b_ms, b_by = row["bound"]
            line += (f"; K2 {row['ms']:.4f} ms (kernel alone {row['kernel_ms']:.4f}, "
                     f"{100 * b_ms / row['kernel_ms']:.0f}% of its bound {b_ms:.4f} ms by "
                     f"{b_by}; plain {row['plain_ms']:.4f}; torch.addcmul "
                     f"{row['library_ms']:.4f}, kernel {row['library_kernel_ms']:.4f})")
        else:
            rows.append(dict(p=p, table=len(table), launches=n_launch, main_path=False))
        log(line)
        del gbuf
    return rows


# (f) checkpoint resharding: a quantized gpt-125m state saved at (1, 1),
# loaded at each of these (P, M) layouts block by block
RESHARD_ARCH = "gpt-125m"
RESHARD_LAYOUTS = ((2, 2), (1, 2), (2, 1))


def dist_reshard(torch, log, dev="cuda"):
    """(f): gpt-125m at full width and depth, its state quantized
    (``quantize_train_state``: 8-bit wire codes for every master-eligible
    parameter, the norms f32) and saved at (1, 1); then every (d, m) block
    of each layout of RESHARD_LAYOUTS loaded with ``dequantize=True`` on the
    card (K2 decodes) and on the CPU (K2's plain version): each block
    byte-equal to the CPU's; the blocks of a layout laid end to end, read
    back through ``from_rest``, equal to the whole state decoded on the card
    at (1, 1).  Returns the seconds."""
    import tempfile
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig, from_rest
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, make_adamw
    from repro_torch.optim.optimizers import OptState
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.step import TrainState, init_train_state, quantize_train_state

    t0 = time.perf_counter()
    cfg = configs.get_config(RESHARD_ARCH)
    one = MeshSpec(("data", "model"), (1, 1))
    model = Model(cfg, one, QSDPConfig())
    st = init_train_state(model, make_adamw(AdamWConfig()), TRAIN["seed"], dev)
    st = quantize_train_state(TrainState(params=st.params, opt=OptState(step=0, mu=(), nu=())),
                              model, prng.PRNGKey(TRAIN["seed"] + 2))
    n_q = sum(hasattr(v, "wire") for v in st.params.values())
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, st, meta=dict(arch=cfg.name))
        del st
        whole = load_checkpoint(d, dev, dequantize=True).params
        logical = {k: from_rest(v, model.specs[k], one) for k, v in whole.items()}
        n_blocks = 0
        for p, m in RESHARD_LAYOUTS:
            tgt = Model(cfg, MeshSpec(("data", "model"), (1, m)), QSDPConfig(), model_rank=0)
            ms = MeshSpec(("data", "model"), (p, m))
            blocks = {}
            for di in range(p):
                for mi in range(m):
                    kw = dict(mesh_sizes=(m, p), rank=di, model_rank=mi, model=tgt,
                              dequantize=True)
                    card = load_checkpoint(d, dev, **kw).params
                    host = load_checkpoint(d, "cpu", **kw).params
                    for k, v in card.items():
                        check(torch.equal(v.cpu(), host[k]),
                              f"dist reshard: {k} block ({di}, {mi}) of ({p}, {m}) differs "
                              "between the card and the CPU")
                        blocks.setdefault(k, {})[di, mi] = v
                    n_blocks += 1
            for k, b in blocks.items():
                rest = torch.cat([torch.cat([b[di, mi] for di in range(p)], dim=-2)
                                  for mi in range(m)], dim=-3)
                check(torch.equal(from_rest(rest, tgt.specs[k], ms), logical[k]),
                      f"dist reshard: {k}'s ({p}, {m}) blocks do not lay out the whole state")
            del blocks
    secs = time.perf_counter() - t0
    log(f"dist reshard: {cfg.name} quantized state ({n_q} leaves as 8-bit codes) saved at "
        f"(1, 1), loaded at (P, M) = {', '.join(map(str, RESHARD_LAYOUTS))} with "
        f"dequantize=True: {n_blocks} blocks byte-equal card vs CPU, each layout's blocks the "
        f"whole decoded state; {secs:.1f} s")
    return secs


def dist_phase(torch, log, dev="cuda", profile=True, wire=True, launch_extra=()):
    """Phase 13 (module docstring): (b) started first; (a)'s profiled step
    runs beside it, then (d) while (b) finishes, (a)'s timed steps after (b)
    is done; then (f), and with `wire` (when the kernel phase did not run
    them, timed), (c) and (e).  Returns (the main path's launches, the
    P-rank rows, the blocks' rows)."""
    t = time.perf_counter()
    started = dist_launch_start(torch, dev, launch_extra)
    blocks = []

    def during():
        blocks.extend(tp_blocks(torch, log, dev))
        dist_launch_check(torch, log, started)

    try:
        launches = dist_nccl_step(torch, log, dev, profile=profile, during=during)
    finally:
        for proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    dist_reshard(torch, log, dev)
    rows = dist_wire(torch, log, dev) if wire else []
    if wire:
        tp_wire(torch, log, dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
    print(DIST_NOTE, flush=True)
    log(f"dist: phase {time.perf_counter() - t:.1f} s")
    return launches, rows, blocks


# (e) the tp-local wire work: gpt-1.3b's layer at these (P, M)
TP_MESHES = ((1, 2), (1, 4), (1, 8), (2, 2))
# (d) the blocks rank by rank: (arch, M, blocks), the blocks' input (B, S),
# and the largest |sum of the M shares - the whole block| over the whole
# block's largest |value|: in bf16 each of the M shares rounds to bf16 and
# so does each of the M - 1 adds of the sum, each by at most 2^-9 of its
# value (the whole block rounds once): at M = 4 at most 7 * 2^-9 < 2^-6; in
# f32 the products add in another order
TP_BLOCKS = (("gpt-1.3b", 2, ("attention", "mlp")), ("gpt-1.3b", 4, ("attention", "mlp")),
             ("qwen2.5-3b", 4, ("attention",)))
TP_BLOCK_BS = (1, 512)
TP_BLOCK_TOL = {"bfloat16": 2.0 ** -6, "float32": 1e-5}
TP_BLOCK_NAMES = {"attention": ("wq", "wk", "wv", "wo", "bq", "bk", "bv"),
                  "mlp": ("w_gate", "w_up", "w_down")}


def tp_wire(torch, log, dev="cuda", timing=None):
    """(e): the tp-local wire work of one gpt-1.3b layer at each (P, M) of
    TP_MESHES, one model rank's view emulated in this process: each of the P
    data ranks encodes its tp-local shard of every tensor (K1, W8 shift,
    under the engine's per-tensor keys) and the P buffers laid end to end
    are decoded by one K2 launch (bf16), byte-equal to the same functions on
    K1/K2's plain versions.  With `timing` (the kernel phase's ``(k1_row,
    decode_row, addcmul_ms)``), K1 on one rank's MLP shard and the K2 decode
    are timed against their bounds, K2 beside ``torch.addcmul``.  Returns
    (K1 rows, K2 rows), off the one-rank main path."""
    from repro_torch import configs
    from repro_torch.core import collectives as coll
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.kernels import cost, ops, ref
    from repro_torch.models.transformer import Model

    k1_rows, k2_rows = [], []
    for p, m in TP_MESHES:
        eng = Model(configs.get_config(DIST_ARCH), MeshSpec(("data", "model"), (1, m)),
                    QSDPConfig(), model_rank=0).engine
        names = tuple(sorted(n for n in eng.specs if n.startswith("layers/")))
        lay = dist_layout(eng, names, p)
        keys = [prng.fold_in(prng.PRNGKey(33), i) if s.cfg is not None else None
                for i, s in enumerate(lay.segments)]
        out_dts = [eng.compute_dtype if s.cfg is not None else torch.float32
                   for s in lay.segments]
        gen = torch.Generator(device=dev).manual_seed(200 + 10 * p + m)
        xs = [[torch.randn(s.n, generator=gen, device=dev) * 0.02 for s in lay.segments]
              for _ in range(p)]

        def work():
            gbuf = torch.cat([coll.encode_wire(x, lay, keys) for x in xs])
            return gbuf, coll.decode_gathered_wire(gbuf, lay, p, out_dts)

        got = work()
        with plain_kernels(ops, ref):
            want = work()
        check(torch.equal(got[0], want[0]), f"tp (P, M) = ({p}, {m}): gathered buffers differ")
        for a, b in zip(got[1], want[1], strict=True):
            check(a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
                  f"tp (P, M) = ({p}, {m}): decoded values differ from the plain versions'")
        gbuf = got[0]
        table, dts = coll.wire_table(lay, p, out_dts)
        n_launch = -(-len(table) // ops.WIRE_MAX_SEGS)
        mlp = lay.segments[names.index("layers/w_gate")].n
        line = (f"tp: (P, M) = ({p}, {m}): {DIST_ARCH} layer, tp-local shards of {mlp} "
                f"values (MLP weight) a rank, {gbuf.numel()} gathered bytes decoded in "
                f"{n_launch} K2 launch(es) over {len(table)} entries: byte-equal to the plain "
                "versions")
        if timing is not None:
            k1_row, decode_row, addcmul_ms = timing
            x = xs[0][names.index("layers/w_gate")].reshape(-1, 1024)
            _, r1 = k1_row(f"{DIST_ARCH} MLP weight tp-local shard, (P, M) = ({p}, {m})", x,
                           keys[names.index("layers/w_gate")], "shift")
            k1_rows.append(dict(r1, p=p, m=m, main_path=False))
            r2 = decode_row(f"{DIST_ARCH} gathered tp-local layer, (P, M) = ({p}, {m}) "
                            f"({len(table)} entries), bf16 out", sum(t.nb for t in table),
                            lambda: ops.unpack_dequantize_wire(gbuf, table, dts),
                            lambda: ref.unpack_dequantize_wire_ref(gbuf, table, dts),
                            wire_addcmul(torch, addcmul_ms, gbuf, table, dts),
                            cost.unpack_dequantize_wire(table, [d.itemsize for d in dts]))
            k2_rows.append(dict(r2, p=p, m=m, table=len(table), launches=n_launch,
                                main_path=False))
            for what, r in (("K1", r1), ("K2", r2)):
                b_ms, b_by = r["bound"]
                line += (f"; {what} {r['ms']:.4f} ms (kernel alone {r['kernel_ms']:.4f}, "
                         f"{100 * b_ms / r['kernel_ms']:.0f}% of its bound {b_ms:.4f} ms by "
                         f"{b_by}; plain {r['plain_ms']:.4f}")
                line += (f"; torch.addcmul {r['library_ms']:.4f}, kernel "
                         f"{r['library_kernel_ms']:.4f})" if what == "K2" else ")")
        else:
            k2_rows.append(dict(p=p, m=m, table=len(table), launches=n_launch,
                                main_path=False))
        log(line)
        del xs, got, want, gbuf
    return k1_rows, k2_rows


def tp_blocks(torch, log, dev="cuda"):
    """(d): tensor parallelism's blocks rank by rank (module docstring).
    The whole weights are drawn at their logical shapes; model rank r holds
    its rest-layout block at (1, M) and gathers it through the engine of a
    (1, M) model computing rank r alone (``model_rank=r``: every model-axis
    sum the identity), so its share is its heads' (or columns') part of the
    block's output; the M shares are summed in rank order, as the model
    group's sum adds them.  The one-rank block runs on the whole weights
    assembled (``from_rest``) from the same decoded shards.  Returns one
    row a (dtype, arch, M, block): the error over the block's largest
    value and the tolerance."""
    import dataclasses as dc_

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig, from_rest, rank_block, to_rest
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import Model

    t0 = time.perf_counter()
    rows = []
    b, sq = TP_BLOCK_BS
    ops.reset_launches()
    with torch.no_grad():
        for dtype in ("bfloat16", "float32"):
            for arch, m, blocks in TP_BLOCKS:
                cfg = configs.get_config(arch)
                qc = QSDPConfig(compute_dtype=dtype)
                ms = MeshSpec(("data", "model"), (1, m))
                ranks = [Model(cfg, ms, qc, model_rank=r) for r in range(m)]
                whole = Model(cfg, MeshSpec(("data", "model"), (1, 1)), qc)
                dt = ranks[0].compute_dtype
                gen = torch.Generator(device=dev).manual_seed(300 + m)
                x = torch.randn((b, sq, cfg.d_model), generator=gen, device=dev).to(dt)
                pos = torch.arange(sq, device=dev)
                cos, sin = L.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
                for block in blocks:
                    names = [n for n in TP_BLOCK_NAMES[block] if f"layers/{n}" in whole.specs]
                    specs = {n: dc_.replace(ranks[0].specs[f"layers/{n}"], stack=None)
                             for n in names}
                    full = {n: torch.randn(sp.shape, generator=gen, device=dev)
                            / math.sqrt(sp.shape[0]) for n, sp in specs.items()}
                    key = prng.fold_in(prng.PRNGKey(34), m)
                    shares, decoded = [], []
                    for r, mdl in enumerate(ranks):
                        w = mdl.engine.gather_layer("layers/", {
                            n: rank_block(to_rest(full[n], specs[n], ms), 0, 1, r, m)
                            for n in names}, key)
                        decoded.append(w)
                        if block == "attention":
                            shares.append(attn_mod.self_attention(x, w, mdl.acfg, cos, sin, pos,
                                                                  rank=r)[0])
                        else:
                            shares.append(L.swiglu_mlp(x, w["w_gate"], w["w_up"], w["w_down"]))
                    got = functools.reduce(torch.add, shares)
                    wfull = {}
                    for n, sp in specs.items():
                        n_loc = sp.n_local(ms)
                        rest = torch.stack([torch.nn.functional.pad(
                            d[n].reshape(-1), (0, n_loc - d[n].numel())) for d in decoded])
                        wfull[n] = from_rest(rest[:, None], sp, ms)
                    if block == "attention":
                        want = attn_mod.self_attention(x, wfull, whole.acfg, cos, sin, pos)[0]
                    else:
                        want = L.swiglu_mlp(x, wfull["w_gate"], wfull["w_up"], wfull["w_down"])
                    err = ((got.float() - want.float()).abs().max()
                           / want.float().abs().max()).item()
                    tol = TP_BLOCK_TOL[dtype]
                    kv = (f", KV {ranks[0].acfg.kv_mode}" if block == "attention" else "")
                    check(got.dtype == want.dtype == dt and math.isfinite(err) and err <= tol,
                          f"tp blocks: {arch} {block} at M = {m} ({dtype}{kv}): the ranks' "
                          f"sum is {err:.3e} of the whole block's largest value from it "
                          f"(tolerance {tol:.3e})")
                    rows.append(dict(arch=arch, m=m, block=block, dtype=dtype, err=err,
                                     tol=tol))
                    log(f"tp blocks: {arch} {block} at full width (d_model {cfg.d_model}), M = "
                        f"{m}{kv}, {dtype}, B x S = {b} x {sq}: the {m} model ranks' shares "
                        f"summed in rank order are {err:.3e} of the whole block's largest "
                        f"value from it (tolerance {tol:.3e})")
                    del shares, decoded, got, want, wfull, full
    if dev == "cuda":
        torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    check(counts["quantize_pack"] > 0 and counts["unpack_dequantize"] > 0,
          f"tp blocks: the gathers launched {counts}")
    log(f"tp blocks: {time.perf_counter() - t0:.1f} s; the ranks' gathers launched {counts}")
    return rows


def profile_experiment_step(torch, log, cfg, qsdp, batch, seq, dev):
    """One train step of `cfg` under `qsdp` as ``train_run`` takes it (after
    a warm-up step) under torch.profiler: ``profile_train_step``'s
    numbers."""
    from repro_torch.core import prng
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.experiments._trainer import MESH11, init_params_like_reference
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
    from repro_torch.train.step import TrainState, build_train_step

    model = Model(cfg, MESH11, qsdp)
    opt = make_adamw(AdamWConfig(lr=2e-3, schedule=cosine_schedule(2e-3, 20, 100)))
    params = init_params_like_reference(model, 0, dev)
    step = build_train_step(model, opt, n_micro=1, device=dev)
    b = make_batch(SyntheticLM(cfg.vocab_size, seq, batch, seed=0, branching=4), 0, dev)
    state, _ = step(TrainState(params=params, opt=opt.init(params)), b, prng.PRNGKey(1))
    return profile_train_step(torch, lambda st: step(st, b, prng.PRNGKey(2)), state, log,
                              tag=f"experiments {cfg.name}")


def busy_share(events):
    """(device busy us, kernel events) of a chrome trace's kernel events,
    overlapping kernels counted once."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy, end = 0.0, None
    for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy, kernels


def profile_train_step(torch, run_step, state, log, tag="train", breakdown=None,
                       record_shapes=False, flops=False):
    """torch.profiler over one step (`tag`: train, or continuous /
    speculative for a scheduler step): device busy share and kernel time by
    name (the trace is read from a temporary file and not kept: a train step
    holds ~10^4-10^5 kernels).  Returns K1's, K2's and K3's device time and
    launches, random_bits' launches and the int64 elementwise kernels of the
    step; with `breakdown` (a function of the trace's events) also what it
    returns, under "parts"; `record_shapes` records the ops' input types
    and dims for it.  With `flops` (the roofline phase's measurement) the
    profiler also sums its own FLOPs of the matrix products (``with_flops``,
    under "mm_flops"), and the step's device memory is read: allocated
    before it ("mem_before") and its peak after a reset ("mem_peak")."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    if flops:
        torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes or flops, with_flops=flops) as prof:
        t = time.perf_counter()
        run_step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    mem_peak = torch.cuda.max_memory_allocated() if flops else None
    mm_flops = mm_unlaunched = None
    t_read = time.perf_counter()
    if flops:
        # the profiler's raw events, not a trace file or its parsed events:
        # with input shapes both take ~10x as long (33.5 s for the gpt-1.3b
        # step).  A kernel names the op that launched it by its correlation
        # id; a product op that launched none is one the checkpoint's early
        # stop abandoned in its replay (the profiler records the op, and its
        # FLOPs, before it runs)
        cuda = torch.autograd.DeviceType.CUDA
        events, launched, products = [], set(), []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                launched.add(e.linked_correlation_id())
                name = e.name()
                if not name.startswith(("Memcpy", "Memset")):
                    events.append(dict(cat="kernel", name=name, ts=e.start_ns() / 1e3,
                                       dur=e.duration_ns() / 1e3))
            elif e.name() in PROFILER_PRODUCTS:
                products.append((e.correlation_id(), e.flops()))
        mm_flops = sum(f for c, f in products if c in launched)
        mm_unlaunched = sum(f for c, f in products if c not in launched)
    else:
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "trace.json"
            prof.export_chrome_trace(str(path))
            trace = json.loads(path.read_text())
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
    t_read = time.perf_counter() - t_read
    busy, kernels = busy_share(events)
    check(kernels, f"profile {tag}: the trace holds no kernel events")
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e["name"], [0.0, 0])
        d[0] += e["dur"]
        d[1] += 1
    log(f"profile {tag} (one step, profiler on): wall {wall_ms:.1f} ms, {len(kernels)} "
        f"kernels, device busy {busy / 1e3:.1f} ms ({100 * busy / 1e3 / wall_ms:.1f}% of wall)"
        + (f"; events read in {t_read:.1f} s" if flops else ""))
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"profile {tag}:   {us / 1e3:9.3f} ms  x{n:6d}  {name[:80]}")

    def total(pred):
        hits = [v for k, v in by_name.items() if pred(k)]
        return sum(v[0] for v in hits) / 1e3, sum(v[1] for v in hits)

    def int64_elementwise(k):
        return "elementwise" in k and "long" in k

    def bitwise(k):
        k = k.lower()
        return "bitwise" in k or "shift" in k

    k1_ms, k1_n = total(lambda k: "quantize_pack" in k)
    k2_ms, k2_n = total(lambda k: "unpack_dequantize" in k)
    k3_ms, k3_n = total(lambda k: "rowquant" in k)
    int64_ms, int64_n = total(int64_elementwise)
    _, threefry = total(lambda k: int64_elementwise(k) and bitwise(k))
    return dict(wall_ms=wall_ms, busy_ms=busy / 1e3, kernels=len(kernels), k1_ms=k1_ms,
                k1_n=k1_n, k2_ms=k2_ms, k2_n=k2_n, k3_ms=k3_ms, k3_n=k3_n,
                int64_ms=int64_ms, int64_n=int64_n,
                threefry_int64=threefry, rb_n=total(lambda k: "random_bits" in k)[1],
                parts=breakdown(events) if breakdown is not None else None,
                mm_flops=mm_flops, mm_unlaunched=mm_unlaunched, mem_before=mem_before,
                mem_peak=mem_peak)


# record_function ranges the moetrain, ssmtrain and mmtrain phases put
# around the parts of a step: a layer's gathers, attention, the decoder's
# cross-attention, the MoE layer, the Mamba2 mixer and, inside it, the SSD
# scan and the causal convs, the shared block's MLP or a layer's, the
# logits/cross-entropy and the optimizer update
RANGES = {"chip_smoke::gathers": "gathers", "chip_smoke::self_attention": "attention",
          "chip_smoke::cross_attention": "cross-attention",
          "chip_smoke::moe_layer": "dispatch/combine", "chip_smoke::xent": "logits/xent",
          "chip_smoke::optimizer": "optimizer", "chip_smoke::mamba2_block": "mixer elementwise",
          "chip_smoke::ssd_chunked": "SSD scan", "chip_smoke::causal_conv": "conv",
          "chip_smoke::swiglu_mlp": "shared MLP", "chip_smoke::mlp": "MLP"}
_EVAL = "autograd::engine::evaluate_function:"
# backward nodes of the port's own autograd Functions, by name
NODE_PARTS = {"_GatherLayer": "gathers", "_GatherOne": "gathers",
              "_CausalConv": "conv", "_Softplus": "mixer elementwise",
              **{f: "dispatch/combine" for f in ("_Expand", "_Reduce", "_ToSlots",
                                                 "_FromSlots", "_Permute", "_Softmax")}}


def _is_gemm(kname):
    k = kname.lower()
    return any(w in k for w in ("gemm", "gemv", "nvjet", "cutlass"))


def step_breakdown(events, n_experts=None):
    """Device ms and kernels of a profiled train step by part.  Each
    kernel goes to the ops open on its launching thread when it was
    launched: K1 and K2 by name; with `n_experts` (a MoE model), "expert
    products" are the bf16 batched GEMMs (aten::bmm on bf16 inputs, or batch
    = n_experts where the trace has no input types); otherwise the innermost
    RANGES range open, or, for a backward node, the range its forward op ran
    in (matched by the autograd sequence number): "gathers" (the wire
    concatenations, the reduce-scatter's sums and casts), "attention" (its
    products are f32), "dispatch/combine" (everything of moe_layer but the
    expert products: router, sort, index moves, SwiGLU's elementwise), "SSD
    scan" (the chunked scan's products and elementwise), "conv", the Mamba2
    mixer's GEMMs as "projections" and the rest of it as "mixer
    elementwise" (gates, head norm, softplus), "shared MLP", "logits/xent",
    "optimizer"; the rest (embedding, norms, residual adds, gradient
    accumulation and norm) is "other".  A backward node of the port's own
    Functions goes by its name (NODE_PARTS).  Also returns, under
    "_matched", how many backward nodes found their forward op's range, and
    under "_other", the five kernels that take most of "other"."""
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    spans, queries = {}, {}
    for e in events:
        if e.get("cat") in ("cpu_op", "user_annotation") and "dur" in e:
            spans.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"],
                                                   e.get("args", {})))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    for j, e in enumerate(kernels):
        r = launch.get(e.get("args", {}).get("correlation"))
        if r is not None:
            queries.setdefault(r["tid"], []).append((r["ts"], ("k", j)))
    # forward ops (run on their own thread: "Fwd thread id" 0; ops inside a
    # backward node carry their node's) and the range they ran in, keyed by
    # (thread, sequence number); a backward node names its forward op's
    # sequence number and the profiler's own id of that thread, which is
    # mapped to the thread whose forward ops share the most sequence numbers
    fwd_seqs, bwd_seqs = {}, {}
    for tid, v in spans.items():
        for r in v:
            seq = r[3].get("Sequence number")
            if seq is None:
                continue
            if r[2].startswith(_EVAL):
                bwd_seqs.setdefault(r[3].get("Fwd thread id"), set()).add(seq)
            elif not r[3].get("Fwd thread id"):
                fwd_seqs.setdefault(tid, set()).add(seq)
                queries.setdefault(tid, []).append((r[0], ("s", (tid, seq))))
    fwd_tid = {f: max(fwd_seqs, key=lambda t: len(fwd_seqs[t] & seqs), default=None)
               for f, seqs in bwd_seqs.items()}

    def node(args):
        return fwd_tid.get(args.get("Fwd thread id")), args.get("Sequence number")
    stacks, by_seq = [[] for _ in kernels], {}

    def label(stack):
        for r in reversed(stack):
            if r[2] in RANGES:
                return RANGES[r[2]]
        return None

    # one sweep per thread: a thread's ranges nest, so the open ones form a
    # chain, innermost last
    for tid, qs in queries.items():
        v = sorted(spans.get(tid, []), key=lambda r: (r[0], -r[1]))
        i, open_ = 0, []
        for t, (kind, j) in sorted(qs, key=lambda q: q[0]):
            while i < len(v) and v[i][0] <= t:
                while open_ and open_[-1][1] < v[i][0]:
                    open_.pop()
                open_.append(v[i])
                i += 1
            while open_ and open_[-1][1] < t:
                open_.pop()
            if kind == "k":
                stacks[j] = list(open_)
            elif label(open_) is not None:
                by_seq[j] = label(open_)

    def part(kname, stack):
        if "quantize_pack" in kname:
            return "K1"
        if "unpack_dequantize" in kname:
            return "K2"
        ops = [r for r in stack if r[2].startswith("aten::")]
        if n_experts is not None and ops and ops[-1][2] in ("aten::bmm", "aten::baddbmm"):
            args = ops[-1][3]
            types = args.get("Input type") or []
            dims = args.get("Input Dims") or [[]]
            if (any("BFloat16" in str(x) for x in types[:2]) if types
                    else bool(dims[0]) and dims[0][0] == n_experts):
                return "expert products"
        own = label(stack)
        if own is not None:
            return own
        for r in reversed(stack):
            if r[2].startswith(_EVAL):
                fn = r[2][len(_EVAL):].strip()
                for name, p in NODE_PARTS.items():
                    if fn.startswith(name + "Backward"):
                        return p
                if node(r[3]) in by_seq:
                    return by_seq[node(r[3])]
        return "other"

    out, other = {}, {}
    for e, stack in zip(kernels, stacks):
        p = part(e["name"], stack)
        if p == "mixer elementwise" and _is_gemm(e["name"]):
            p = "projections"
        d = out.setdefault(p, [0.0, 0])
        d[0] += e["dur"] / 1e3
        d[1] += 1
        if p == "other":
            other[e["name"]] = other.get(e["name"], 0.0) + e["dur"] / 1e3
    nodes = [r for v in spans.values() for r in v if r[2].startswith(_EVAL)]
    out["_matched"] = (sum(node(r[3]) in by_seq for r in nodes), len(nodes), len(by_seq))
    out["_other"] = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    return out


if __name__ == "__main__":
    raise SystemExit(main())
