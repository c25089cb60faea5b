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
              (bf16 and f32 out) and over segments off 16-byte alignment.
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
7. train   -- gpt-1.3b at full width and depth, default QSDPConfig (W8
              shift weights, G8 stochastic gradients, bucket 1024,
              coalesced, bf16 compute, full remat), AdamW + cosine, batch 4
              x seq 2048, 2 microbatches, SyntheticLM seed 0, through
              ``build_train_step``: one warm-up step, 3 timed steps (launch
              counts checked against the code's structure), one step under
              torch.profiler (K1's device time, no threefry int64 kernels
              left); then quantized_state vs quantize_master (8-bit
              moments) for 2 steps, losses equal.
8. experiments -- first the theory runs' draws (64-bit bits, f64 and f32
              uniforms), the f64 lattice quantizers and one ``run_qsgd``
              trajectory on the card against the CPU twin; then the
              paper's experiments through ``repro_torch.experiments``
              at the JAX package's suite sizes (its ``benchmarks/run.py``):
              the Theorem 2 / Corollary 3 table (3 kappas x 5 variants x 8
              seeds), Table 1 (240 steps), Table 2 (2x2 grid, 160), Tables
              3/6 (compression at 3/4/5 bits, W4 training, 160) and Figures
              7/8 (160), on the 2-layer bench GPT at batch 8 x seq 128;
              then Table 1 at gpt-125m's full width and depth (baseline vs
              W8G8, batch 8 x seq 512, 100 steps).  Every experiment's
              PASS/FAIL gates at the reference's bands, gpt-125m's losses
              finite and falling and its W8G8 within 8 % of the baseline,
              and K1/K2 launches equal to the structure's per train step;
              one profiled W8G8 step of each model.

Prints the kernel table as one JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# 32-bit integer operations K1 spends per value on its stochastic draw: the
# threefry-2x32 block (20 rounds of add, rotate, xor; 5 key injections of 2
# adds) plus the counter, the final xor and the mantissa fill
K1_DRAW_INT_OPS = 75

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


def bound(nbytes, flops=0.0, flop_rate=F32_FLOP_PER_S, int_ops=0.0):
    """(least ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over their peak rates (f32 and INT32 run on
    separate lanes, so the larger of those two counts)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = max(flops / flop_rate, int_ops / INT32_OP_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

GPT13_NB = {"attn (wq/wk/wv/wo)": 4096, "mlp (w_gate/w_up/w_down)": 16384,
            "embed": 100608}
K3_SHAPES = {"w_gate/w_up": (4, 2048, 8192, 8), "w_down": (4, 8192, 2048, 2)}
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


def layer_decode_rows(torch, log, gen, decode_row, addcmul_ms, dev="cuda"):
    """K2 over whole wire buffers, as the gathers decode them.  Timed: one
    gpt-1.3b layer's real buffer (its 7 quantized matmul weights and 2 fp
    norms, encoded by K1 under the engine's layout) decoded in one launch, in
    bf16 and in f32, byte-equal to the plain version; the library call is
    ``torch.addcmul`` over the layer's codes gathered into one tensor.
    Checked only: segments off 16-byte alignment, in two rows."""
    from repro_torch import configs
    from repro_torch.core import collectives as coll
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.models.transformer import Model

    eng = Model(configs.get_config("gpt-1.3b"), MeshSpec(("data", "model"), (1, 1)),
                QSDPConfig()).engine
    layout = eng.layout(tuple(sorted(n for n in eng.specs if n.startswith("layers/"))))

    def encode(layout, seed):
        xs = [torch.randn(seg.n, generator=gen, device=dev) * 0.02 for seg in layout.segments]
        keys = [prng.fold_in(prng.PRNGKey(seed), i) if seg.cfg is not None else None
                for i, seg in enumerate(layout.segments)]
        return coll.encode_wire(xs, layout, keys)

    buf = encode(layout, 20)
    out = []
    for dt in (torch.bfloat16, torch.float32):
        table, dts = coll.wire_table(layout, 1, [dt] * len(layout.segments))
        nb, n = sum(t.nb for t in table), sum(t.nb * t.bucket for t in table)
        want = ref.unpack_dequantize_wire_ref(buf, table, dts)
        # the library's operands: the layer's codes as one (nb, 1024) tensor
        # and its f32 scale/zero as (nb, 1)
        check(all(t.meta_dtype == torch.float32 and t.bits == 8 for t in table),
              "layer codes are not W8 with f32 scale/zero")
        meta = [buf[t.scale:t.zero + 4 * t.nb].clone().view(torch.float32).view(2, t.nb, 1)
                for t in table]
        lib = (torch.cat([buf[t.codes:t.scale].view(t.nb, t.bucket) for t in table]),
               torch.cat([m[0] for m in meta]), torch.cat([m[1] for m in meta]))
        out.append(decode_row(
            f"whole layer ({len(table)} tensors), {dt_name(dt)} out", nb,
            lambda: ops.unpack_dequantize_wire(buf, table, dts),
            lambda: ref.unpack_dequantize_wire_ref(buf, table, dts),
            addcmul_ms(*lib, torch.cat(want)),
            sum(t.zero + 4 * t.nb - t.codes for t in table) + dt.itemsize * n, n))
        del want, meta, lib
    # odd nb moves the next segment 8 bytes off 16 at 8 bits; bf16 scale/zero
    # and an odd bf16 fp payload leave even 4-byte alignment behind
    odd = coll.WireLayout((
        coll.WireSegment(5 * 1024 - 3, QuantConfig(bits=8, meta_dtype="bfloat16")),
        coll.WireSegment(77, None, "bfloat16"),
        coll.WireSegment(3 * 1024, QuantConfig(bits=4, meta_dtype="bfloat16")),
        coll.WireSegment(7 * 1024 + 1, QuantConfig(bits=2)),
        coll.WireSegment(2000, QuantConfig(bits=3, bucket_size=100)),
        coll.WireSegment(33 * 1024, QuantConfig(bits=8))))
    rows = torch.cat([encode(odd, 21), encode(odd, 22)])
    for dt in (torch.bfloat16, torch.float32):
        table, dts = coll.wire_table(odd, 2, [dt] * len(odd.segments))
        check(any((rows.data_ptr() + t.codes) % 16 for t in table),
              "unaligned case: every segment is 16-byte aligned")
        for g, w in zip(ops.unpack_dequantize_wire(rows, table, dts),
                        ref.unpack_dequantize_wire_ref(rows, table, dts), strict=True):
            check(torch.equal(g.view(torch.uint8), w.view(torch.uint8)),
                  f"K2 unaligned segments, {dt_name(dt)} out: values differ")
    log(f"K2 over wire buffers: a whole gpt-1.3b layer byte-equal to plain in one launch; "
        f"segments off 16-byte alignment (bits 2/3/4/8, bf16 and f32 scale/zero, 2 rows, "
        f"{len(table)} table entries) byte-equal, bf16 and f32 out")
    return out


def kernel_phase(torch, log, dev="cuda"):
    from repro_torch.core import prng
    from repro_torch.kernels import ops, ref

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

    def decode_row(what, nb, call, plain, library, nbytes, n):
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
                    bound=bound(nbytes, flops=2 * n),
                    max_abs_err=max((g.float() - w.float()).abs().max().item()
                                    for g, w in zip(got, want)))

    def k1_row(what, x, key, mode, rand_bits=32, bits=8):
        """K1 in its key form against its plain version (threefry twin +
        quantize_pack_ref) at one shape and width: byte-equal, then timed."""
        nb, n = x.shape[0], x.numel()
        levels = (1 << bits) - 1

        def call():
            return ops.quantize_pack(x, key, levels, bits, mode, rand_bits)

        def plain():
            return ref.quantize_pack_key_ref(x, key, levels, bits, mode, rand_bits)

        q, qr = call(), plain()
        for g, w, part in zip(q, qr, ("codes", "scale", "zero")):
            check(torch.equal(g, w), f"K1 {what} {mode}: {part} differ in "
                  f"{(g != w).sum().item()} places")
        return q, dict(
            shape=what, nb=nb, mode=mode,
            ms=cuda_ms(torch, call, flush=flush), kernel_ms=kernel_ms(torch, call, flush=flush),
            plain_ms=cuda_ms(torch, plain, reps=3, flush=flush),
            bound=bound(4 * n + q[0].numel() + 8 * nb, flops=5 * n,
                        int_ops=K1_DRAW_INT_OPS * n if mode == "stochastic" else 0),
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
        n = nb * 1024
        for dt in (torch.bfloat16, torch.float32):
            k2.append(decode_row(
                f"{what}, {dt_name(dt)} out", nb, lambda: ops.unpack_dequantize(*q, 8, dt),
                lambda: ref.unpack_dequantize_ref(*q, 8, dt),
                addcmul_ms(*q, ref.unpack_dequantize_ref(*q, 8, dt)),
                n + 8 * nb + dt.itemsize * n, n))
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
                n * bits // 8 + 8 * (n // 4096) + dt.itemsize * n, n))
        del q
    del x
    # the gradient path's mode at the embedding shape: K1 stochastic, one
    # threefry draw per value (Def. 12)
    x = torch.randn((GPT13_NB["embed"], 1024), generator=gen, device=dev) * 1e-3
    k1.append(k1_row("embed grad", x, prng.fold_in(prng.PRNGKey(12), 0x5D), "stochastic")[1])
    del x
    k2 += layer_decode_rows(torch, log, gen, decode_row, addcmul_ms, dev)
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
        n = nb * bucket
        k2.append(decode_row(
            f"{what}, bf16 out", nb, lambda: ops.unpack_dequantize(*q, bits, torch.bfloat16),
            lambda: ref.unpack_dequantize_ref(*q, bits, torch.bfloat16),
            addcmul_ms(ref.unpack_codes(q[0], bits), q[1], q[2], want),
            q[0].numel() + 8 * nb + 2 * n, n))
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
    levels, n = (1 << COLD_BITS) - 1, COLD_NB * COLD_BUCKET
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
        bound=bound(4 * n + n * COLD_BITS // 8 + 8 * COLD_NB, flops=5 * n),
        max_abs_err=max((a.float() - b.float()).abs().max().item() for a, b in zip(q, qr))))
    r = k1[-1]
    log(f"K1 {r['shape']} nb={COLD_NB}: byte-equal to plain; {r['ms']:.4f} ms, kernel "
        f"{r['kernel_ms']:.4f} (plain {r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} by "
        f"{r['bound'][1]})")
    k2.append(decode_row(
        "cold KV block, W4 bucket 128, bf16 out", COLD_NB,
        lambda: ops.unpack_dequantize(*q, COLD_BITS, torch.bfloat16),
        lambda: ref.unpack_dequantize_ref(*q, COLD_BITS, torch.bfloat16), None,
        n * COLD_BITS // 8 + 8 * COLD_NB + 2 * n, n))
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
        sum(b.numel() for b in bufs) + 2 * 4 * n1, 4 * n1))
    log_decode_row("K2", k2[-1], log)
    del qs, bufs, want

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
        bound=bound(4 * rows_n * vocab + 8 * rows_n, int_ops=K1_DRAW_INT_OPS * rows_n * vocab),
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
    n = nb * 1024
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
        bound=bound(4 * n + 4 * n + n + 8 * nb, flops=6 * n),
        max_abs_err=max((a.float() - b.float()).abs().max().item() for a, b in zip(q, qr)))]
    rows["dequantize_buckets"] = [
        decode_row(f"embed, {dt_name(dt)} out", nb, lambda: ops.dequantize_buckets(*q, dt),
                   lambda: ref.dequantize_buckets_ref(*q, dt),
                   addcmul_ms(*q, ref.dequantize_buckets_ref(*q, dt)),
                   n + 8 * nb + dt.itemsize * n, n)
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
        nbytes = 2 * m * k + k * n + 8 * k * n_seg + 2 * m * n
        k3.append(dict(
            shape=what, m=m, k=k, n=n, n_seg=n_seg,
            ms=cuda_ms(torch, lambda: ops.rowquant_matmul(xb, codes, s, z), flush=flush),
            plain_ms=cuda_ms(torch, lambda: ref.rowquant_matmul_ref(xb, codes, s, z),
                             reps=3, flush=flush),
            library_ms=cuda_ms(torch, lambda: torch.matmul(xb, wd), flush=flush),
            kernel_ms=kernel_ms(torch, lambda: ops.rowquant_matmul(xb, codes, s, z), flush=flush),
            library_kernel_ms=kernel_ms(torch, lambda: torch.matmul(xb, wd), flush=flush),
            bound=bound(nbytes, flops=2 * m * k * n + 4 * m * k * n_seg),
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
                    default="build,kernels,small,serve,continuous,speculative,train,experiments",
                    help="comma-separated subset of build,kernels,small,serve,continuous,"
                         "speculative,train,experiments")
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

    def log(msg):
        print(f"[chip_smoke] {msg}", flush=True)

    t0 = time.time()
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
        if "kernels" in phases:
            rows = kernel_phase(torch, log)
            paths.append(buckets_path(torch, log))
        if "small" in phases:
            small_phase(torch, log)
            small_train_phase(torch, log)
        if "serve" in phases:
            paths.append(serve_phase(torch, log, profile=args.profile))
        if "continuous" in phases:
            paths.append(continuous_phase(torch, log))
        if "speculative" in phases:
            paths.append(speculative_phase(torch, log))
        if "train" in phases:
            paths.append(train_phase(torch, log))
        if "experiments" in phases:
            paths.append(experiments_phase(torch, log)[0])
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


def small_phase(torch, log):
    """gpt-1.3b smoke (f32 compute) on the card and on the CPU from the same
    weights: gathered weight bytes equal (K1/K2 are bit-exact), the live
    lanes' logits within SMALL_LOGIT_ATOL, same greedy tokens."""
    import repro_torch.models.layers as L
    from repro_torch.core.qsdp import QSDPConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.serve import build_serve_setup, make_prompt_batch

    qcfg = QSDPConfig(compute_dtype="float32")
    res = {}
    params = None
    for dev in ("cuda", "cpu"):
        setup = build_serve_setup("gpt-1.3b", smoke=True, qsdp=qcfg, device=dev,
                                  params=params, **SMALL)
        params = {k: v.cpu() for k, v in setup.params.items()}
        tokens, _ = SyntheticLM(setup.cfg.vocab_size, SMALL["prompt_len"], SMALL["batch"],
                                seed=SMALL["seed"]).sample(0)
        prompt = make_prompt_batch(setup.cfg, setup.spec, setup.ms, tokens, setup.device)
        logits, gathers = [], {}
        with hooked(L, "vocab_parallel_logits", capture_logits(logits)), \
                hooked(setup.model.engine, "_reshape_full",
                       capture_gathers(setup.model, gathers)):
            out = setup.engine.generate(setup.params, prompt, n_tokens=SMALL["gen"])
        res[dev] = (out.cpu(), [t.cpu() for t in logits], gathers)
    (tc, lc, gc), (tp, lp, gp) = res["cuda"], res["cpu"]
    check(gc == gp, "small: gathered weight bytes differ between card and CPU")
    # the card's launches run at LANE_BLOCK lanes: its logits carry dead lanes
    err = max((a[:len(b)] - b).abs().max().item() for a, b in zip(lc, lp))
    check(math.isfinite(err) and err <= SMALL_LOGIT_ATOL,
          f"small: logits differ by {err:.3e} > {SMALL_LOGIT_ATOL}")
    check(torch.equal(tc, tp), f"small: tokens differ: {tc.tolist()} vs {tp.tolist()}")
    log(f"small: gpt-1.3b smoke on card == CPU: {sum(map(len, gc.values()))} gathers "
        f"byte-equal, logits max |diff| {err:.3e}, tokens {tc.tolist()}")


# ---------------------------------------------------------------------------
# phase 4: gpt-1.3b serving, dense then rowquant
# ---------------------------------------------------------------------------

SERVE = dict(batch=4, prompt_len=128, gen=16, seed=0)
SERVE_REPS = 3  # timed generate() runs per path


def k2_buffers(eng, quantized, skip=()) -> tuple[int, int]:
    """K2 launches that decode the gathered (or reduce-scattered) wire
    buffers of one pass over the parameters, one launch per
    ``ops.WIRE_MAX_SEGS`` tensors that `quantized` says are quantized in a
    buffer (one rank: one row per buffer): (tensors outside a stack, each
    gathered alone; layers of the stacks, each one buffer of its tensors not
    named in `skip`)."""
    from repro_torch.kernels import ops
    alone = sum(1 for s in eng.specs.values() if s.stack is None and quantized(s))
    layers = {}
    for n, s in eng.specs.items():
        if s.stack is not None and n.split("/")[-1] not in skip and quantized(s):
            n_q, stack = layers.get(n.rsplit("/", 1)[0], (0, s.stack))
            layers[n.rsplit("/", 1)[0]] = (n_q + 1, stack)
    return alone, sum(-(-n_q // ops.WIRE_MAX_SEGS) * stack for n_q, stack in layers.values())


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
# reference's solo form), shared by the continuous and speculative phases:
# both build gpt-1.3b from seed CONT["seed"] and serve it under one key
_SOLO: dict = {}


def solo_runs(torch, setup, reqs, key) -> dict:
    """{rid: tokens} of each request served alone on a batch-of-1 engine of
    the setup's spec (speculation off): ``generate(fold_step_keys=False,
    prefill_chunk=...)`` with the request's sampling parameters."""
    from repro_torch.serve import ServeEngine, make_sample_params
    solo = ServeEngine(setup.model, dataclasses.replace(setup.spec, batch_global=1,
                                                        draft_bits=0, draft_depth=0),
                       setup.device)
    for r in reqs:
        if r.rid not in _SOLO:
            prompt = {"tokens": torch.tensor([list(r.prompt)], dtype=torch.int64)}
            _SOLO[r.rid] = solo.generate(
                setup.params, prompt, r.max_new_tokens, key=key, fold_step_keys=False,
                sample=make_sample_params(r.temperature, r.top_k, r.seed),
                prefill_chunk=CONT["chunk"], prefill_buckets=CONT["buckets"])[0].tolist()
    return {r.rid: _SOLO[r.rid] for r in reqs}


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
    out["route"] = route_invariance(torch, log, dev, rnd, acfg)
    return out


def route_invariance(torch, log, dev, rnd, acfg):
    """The fixed-shape route's gate: every launch of the decode path runs at
    LANE_BLOCK lanes (decode and verify: M = LANE_BLOCK rows; chunks: M =
    LANE_BLOCK x the top bucket), so a request's rows must come out with the
    same bits whatever the other lanes hold and whichever lane it rides:
    alone in lane 0 with the others dead (zeros; a batch-of-1 engine, M = 1
    or one lane's chunk), or in lane 2 beside live lanes (the pool).  Checked
    for every GEMM weight shape of the layer, the f32 logits, decode
    attention (ring) and chunk attention (paged, the continuous cell's)."""
    import repro_torch.models.layers as L
    from repro_torch.models.attention import chunk_attend, decode_attend
    from repro_torch.models.decode import LANE_BLOCK
    lb, lq, ring = LANE_BLOCK, CONT["chunk"], CONT["ring"]

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
    for what, (k, n) in {"wq/wk/wv/wo": (2048, 2048), "w_gate/w_up": (2048, 8192),
                         "w_down": (8192, 2048)}.items():
        w = rnd(k, n) * 0.02
        for rows in (1, lq):
            gate(f"x @ {what} bf16 at M = {lb * rows}", lambda x, w=w: x @ w,
                 [rnd(rows, k)], [rnd(lb * rows, k)], rows)
    head, fnorm = rnd(50304, 2048, dt=torch.float32) * 0.02, torch.ones(2048, device=dev)
    gate(f"final norm + f32 logits at M = {lb}",
         lambda x: L.vocab_parallel_logits(L.rms_norm(x, fnorm), head),
         [rnd(1, 2048)], [rnd(lb, 2048)])
    pos = torch.full((lb,), 300, device=dev)
    gate(f"decode attention (ring {ring}) at B = {lb}",
         lambda q, c: decode_attend(q, c, c, acfg, pos, ring),
         [rnd(1, 32, 64), rnd(1, ring, 32, 64)], [rnd(lb, 32, 64), rnd(lb, ring, 32, 64)])
    bs = CONT["block"]
    bt = torch.arange(lb * (ring // bs), device=dev).reshape(lb, ring // bs)
    cpos = (torch.arange(lq, device=dev) + 200)[None].expand(lb, lq)
    gate(f"chunk attention (paged, block {bs}) at B = {lb} x {lq}",
         lambda q, c: chunk_attend(q, c, c, acfg, cpos, ring, bt, bs),
         [rnd(1, lq, 32, 64), rnd(1, ring, 32, 64)], [rnd(lb, lq, 32, 64), rnd(lb, ring, 32, 64)])
    log(f"continuous: fixed-shape route: a request's rows bit-equal in lane 0 beside dead "
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


def continuous_phase(torch, log, dev="cuda", profile=True):
    """gpt-1.3b at full width and depth through ``make_scheduler`` ->
    ``ContinuousScheduler.run``: CONT's configuration, CONT_PLAN's requests,
    every launch on the fixed-shape route.  Run 1 (profiling one pooled
    decode step of sampled lanes: no int64 bitwise or shift kernel may
    appear) and run 2 (counts zeroed just before, read just after, against
    the code's structure; timed) must give every request the same tokens;
    every request that attached no rehydrated block (every greedy one) must
    equal its solo run on a batch-of-1 engine (``generate(fold_step_keys=
    False, prefill_chunk=64)``, the reference's solo form); the pool's
    invariants hold, blocks were demoted and rehydrated, and none is left in
    use.  On the card also ``row_invariance`` and ``fixed_shape_cost``."""
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.kernels import ops
    from repro_torch.serve import make_scheduler

    setup = continuous_setup(torch, dev)
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
            steps, prof, wall

    with torch.inference_mode():
        s1, out1, cold1, _, prof, _ = run(profile)
        ops.reset_launches()
        s2, out2, cold2, steps, _, wall = run(False)
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
    check(min(counts[k] for k in want) > 0, f"continuous: a kernel never launched: {counts}")
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
    log(f"continuous: gpt-1.3b, {len(reqs)} requests on {CONT['slots']} slots, ring "
        f"{CONT['ring']}, block {CONT['block']}, chunk {CONT['chunk']} (buckets {s2.buckets}): "
        f"{st['tokens_generated']} tokens in {wall:.3f} s = "
        f"{st['tokens_generated'] / wall:.2f} tokens/s; TTFT p50 {pct(ttft, 50):.3f} s, "
        f"p95 {pct(ttft, 95):.3f} s")
    log(f"continuous: step ms: decode only median {1e3 * pct(dec, 50):.2f} (p95 "
        f"{1e3 * pct(dec, 95):.2f}, {len(dec)} steps); with a chunk launch median "
        f"{1e3 * pct(mix, 50):.2f} (p95 {1e3 * pct(mix, 95):.2f}, {len(mix)} steps); "
        f"occupancy {st['mean_occupancy']:.3f} of {CONT['slots']}; {st['prefill_chunks']} "
        f"chunk launches, {st['decode_launches']} decode steps")
    log(f"continuous: prefix hit rate {st['prefix_hit_rate']:.3f} ({st['prefix_hits']} hits), "
        f"demotions {st['demotions']}, rehydrations {st['rehydrations']}, cold blocks at the "
        f"end {st['cold_blocks']} = {st['cold_bytes']} bytes "
        f"({st['cold_compression']:.2f}x smaller than hot), cow forks {st['cow_forks']}")
    log(f"continuous: launches {counts} = structure {want}")
    if profile:
        log(f"continuous: profiled step: random_bits {prof['rb_n']}, K1 {prof['k1_n']}, K2 "
            f"{prof['k2_n']}; int64 elementwise kernels {prof['int64_n']}, of which bitwise/"
            f"shift {prof['threefry_int64']}")
    if dev == "cuda":
        row_invariance(torch, log, dev)
        fixed_shape_cost(torch, log, setup, key)
    del setup, s1, s2
    if dev == "cuda":
        torch.cuda.empty_cache()
    return counts


def continuous_setup(torch, dev, **kw):
    """gpt-1.3b at CONT's configuration on the fixed-shape route; `kw` adds
    DecodeSpec fields (the speculative phase's draft)."""
    from repro_torch.serve import build_serve_setup
    gen_max = max(g for *_, g in CONT_PLAN)
    setup = build_serve_setup("gpt-1.3b", smoke=False, batch=CONT["slots"],
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


def speculative_phase(torch, log, dev="cuda"):
    """gpt-1.3b at full width and depth through ``make_scheduler`` with
    ``DecodeSpec(draft_bits=4, draft_depth=4)``: CONT's configuration and
    CONT_PLAN's requests, as the continuous phase.  Gates: every request
    that attached no rehydrated block, greedy and sampled, commits the
    tokens of its non-speculative batch-of-1 solo run; at least one drafted
    token is accepted; the launches of K1/K2/K3/random_bits (counts zeroed
    just before the run, read just after) are those the code's structure
    derives from the run's statistics; the pool's invariants hold and no
    block is left in use.  Prints tokens/s, TTFT, the draft and verify
    launches' times, the acceptance rate and the draft overhead."""
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.kernels import ops
    from repro_torch.serve import make_scheduler

    setup = continuous_setup(torch, dev, **SPEC)
    reqs = continuous_requests(setup.cfg.vocab_size)
    key = prng.PRNGKey(CONT["seed"])

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    times = {"draft": [], "verify": []}

    def timed(tag):
        """A launch's host time to its tokens on the host: the call, then a
        sync (the scheduler reads the tokens right after)."""
        def wrap(orig):
            def step_fn():
                fn = orig()

                def f(*a, **k):
                    t = time.perf_counter()
                    out = fn(*a, **k)
                    sync()
                    times[tag].append(time.perf_counter() - t)
                    return out
                return f
            return step_fn
        return wrap

    sched = make_scheduler(setup, gather_key=key, prefill_chunk=CONT["chunk"],
                           prefill_buckets=CONT["buckets"], prefill_interleave=CONT["interleave"],
                           kv_quant_bits=CONT["quant_bits"], kv_quant_horizon=CONT["horizon"])
    hooks, cold = track_cold(sched)
    hooks += [(sched.draft_engine, "decode_step", timed("draft")),
              (sched.engine, "verify_step", timed("verify"))]
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
    check(min(counts[k] for k in want) > 0, f"speculative: a kernel never launched: {counts}")
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
    log(f"speculative: gpt-1.3b, draft {SPEC['draft_bits']}-bit x depth {SPEC['draft_depth']}, "
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
        profile_speculative_step(torch, log, sched, reqs)
    del setup, sched
    if dev == "cuda":
        torch.cuda.empty_cache()
    return counts


def profile_speculative_step(torch, log, sched, reqs):
    """After the timed run: 4 more greedy requests (64-token prompts, one
    chunk launch for all of them), then one step of draft and verify
    launches under torch.profiler (device busy share, kernel time by name),
    then the queue drained.  No int64 bitwise or shift kernel may appear,
    and the step must run K3 and K2."""
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
    check(prof["k3_n"] > 0 and prof["k2_n"] > 0, f"speculative: the profiled step ran K3 "
          f"{prof['k3_n']} and K2 {prof['k2_n']} times")
    log(f"speculative: profiled step: K1 {prof['k1_n']} ({prof['k1_ms']:.3f} ms), K2 "
        f"{prof['k2_n']} ({prof['k2_ms']:.3f} ms), K3 {prof['k3_n']} ({prof['k3_ms']:.3f} ms); "
        f"int64 elementwise kernels {prof['int64_n']}, of which bitwise/shift "
        f"{prof['threefry_int64']}")


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
# phase 7: gpt-1.3b training
# ---------------------------------------------------------------------------

TRAIN = dict(batch=4, seq=2048, n_micro=2, seed=0, lr=6e-4, warmup=10, total=100)
TRAIN_TIMED = 3   # timed steps after one warm-up step
QSTATE_STEPS = 2  # quantized_state vs quantize_master
# random init at 0.02: the first loss is close to ln(vocab)
FIRST_LOSS_ATOL = 0.5


def expected_train_launches(model, n_micro: int) -> dict:
    """K1/K2 launches of one train step by the code's structure.  Per
    microbatch: the forward gathers every quantized tensor once (embed at
    the top, each layer inside its checkpoint), the backward re-gathers
    every layer's quantized tensors once more (the checkpoint replays the
    gather), and every gradient-quantized tensor is reduce-scattered once.
    K1 encodes each quantized tensor of a gather or reduce-scatter; K2
    decodes each buffer that holds one, in one launch (the final norm's
    buffers hold fp payloads only)."""
    eng = model.engine
    fwd = sum(s.stack or 1 for s in eng.specs.values() if eng._is_quantized(s))
    replay = sum(s.stack for n, s in eng.specs.items()
                 if n.startswith("layers/") and eng._is_quantized(s))
    grads = sum(s.stack or 1 for s in eng.specs.values() if eng._is_grad_quantized(s))
    alone, layers = k2_buffers(eng, eng._is_quantized)
    k2 = (alone + layers, layers, sum(k2_buffers(eng, eng._is_grad_quantized)))
    return {"quantize_pack": n_micro * (fwd + replay + grads),
            "unpack_dequantize": n_micro * sum(k2),
            "per_micro": (fwd, replay, grads), "k2_per_micro": k2}


def train_phase(torch, log, dev="cuda"):
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.kernels import ops
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

    def run(i, st):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, m = step(st, batches[i], key(i))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # synchronizes
        torch.cuda.synchronize()
        return st, loss, gnorm, time.perf_counter() - t

    state, loss0, gnorm0, t_warm = run(0, state)
    losses, gnorms, times = [loss0], [gnorm0], []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for i in range(1, 1 + TRAIN_TIMED):
        state, loss, gnorm, dt = run(i, state)
        losses.append(loss)
        gnorms.append(gnorm)
        times.append(dt)
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = expected_train_launches(model, TRAIN["n_micro"])
    for k in ops.KERNELS:
        n_want = TRAIN_TIMED * want.get(k, 0)
        check(counts[k] == n_want, f"train: {k} launched {counts[k]} times in "
              f"{TRAIN_TIMED} steps, the code's structure predicts {n_want}")
    check(all(map(math.isfinite, losses + gnorms)), f"train: losses {losses}, norms {gnorms}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= FIRST_LOSS_ATOL,
          f"train: first loss {losses[0]:.4f}, ln(vocab) = {math.log(cfg.vocab_size):.4f}")
    tok = TRAIN["batch"] * TRAIN["seq"]
    med = statistics.median(times)
    log(f"train: gpt-1.3b ({n_params / 1e9:.3f} G params), batch {TRAIN['batch']} x seq "
        f"{TRAIN['seq']}, n_micro {TRAIN['n_micro']}: warm-up step {t_warm * 1e3:.1f} ms; "
        f"{TRAIN_TIMED} timed steps median {med * 1e3:.1f} ms (min {min(times) * 1e3:.1f}, "
        f"max {max(times) * 1e3:.1f}), {tok / med:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
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
    prof = profile_train_step(torch, lambda st: step(st, batches[i], key(i)), state, log)
    check(prof["threefry_int64"] == 0,
          f"train: {prof['threefry_int64']} int64 bitwise/shift kernels in the profiled step "
          "(a threefry draw outside K1)")
    log(f"train: profiled step: K1 {prof['k1_ms']:.1f} ms in {prof['k1_n']} launches, K2 "
        f"{prof['k2_ms']:.1f} ms in {prof['k2_n']}; int64 elementwise kernels "
        f"{prof['int64_n']} ({prof['int64_ms']:.1f} ms), of which int64 bitwise/shift "
        f"(threefry) {prof['threefry_int64']}")
    del state, step
    torch.cuda.empty_cache()

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
        qs, mq = step_q(qs, batches[i], key(i))
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


# ---------------------------------------------------------------------------
# phase 8: the paper's experiments
# ---------------------------------------------------------------------------

# the JAX package's suite defaults (benchmarks/run.py): steps per training
# run of each table, and the theory table's seeds; then Table 1 at gpt-125m
# (full width and depth), batch 8 x seq 512: a cut of the paper's
# pretraining to full_steps steps.  Cuts, were the phase too long for a
# call, in this order: full_steps, then theory_seeds 8 -> 4, then the
# bench model's steps; no gate's band changes.
EXP = dict(table1=240, table2=160, table3=160, fig78=160, theory_seeds=8,
           full_steps=100, full_batch=8, full_seq=512)
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


def profile_train_step(torch, run_step, state, log, tag="train"):
    """torch.profiler over one step (`tag`: train, or continuous /
    speculative for a scheduler step): device busy share and kernel time by
    name (the trace is read from a temporary file and not kept: a train step
    holds ~10^4-10^5 kernels).  Returns K1's, K2's and K3's device time and
    launches, random_bits' launches and the int64 elementwise kernels of the
    step."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run_step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
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
    log(f"profile {tag} (one step, profiler on): wall {wall_ms:.1f} ms, {len(kernels)} "
        f"kernels, device busy {busy / 1e3:.1f} ms ({100 * busy / 1e3 / wall_ms:.1f}% of wall)")
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
                threefry_int64=threefry, rb_n=total(lambda k: "random_bits" in k)[1])


if __name__ == "__main__":
    raise SystemExit(main())
