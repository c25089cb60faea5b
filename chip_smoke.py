#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, each of which makes the script exit non-zero when it fails:

1. build   -- nvcc builds every kernel source of the port, in parallel.
2. kernels -- each CUDA kernel (K1 quantize->pack drawing its threefry
              bits from the key, K2 unpack->dequantize, K3 rowquant matmul,
              K4 unpacked quantize, K5 unpacked dequantize) against its
              plain PyTorch version on the card at the gpt-1.3b shapes of
              its path: K1/K2/K4/K5 byte-equal, K3 within tolerance; K2
              also over a whole gpt-1.3b layer's wire buffer in one launch
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
5. train   -- gpt-1.3b at full width and depth, default QSDPConfig (W8
              shift weights, G8 stochastic gradients, bucket 1024,
              coalesced, bf16 compute, full remat), AdamW + cosine, batch 4
              x seq 2048, 2 microbatches, SyntheticLM seed 0, through
              ``build_train_step``: one warm-up step, 3 timed steps (launch
              counts checked against the code's structure), one step under
              torch.profiler (K1's device time, no threefry int64 kernels
              left); then quantized_state vs quantize_master (8-bit
              moments) for 2 steps, losses equal.

Prints the kernel table as one JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
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

    def k1_row(what, x, key, mode, rand_bits=32):
        """K1 in its key form against its plain version (threefry twin +
        quantize_pack_ref) at one shape, W8: byte-equal, then timed."""
        nb, n = x.shape[0], x.numel()
        q = ops.quantize_pack(x, key, 255, 8, mode, rand_bits)
        qr = ref.quantize_pack_key_ref(x, key, 255, 8, mode, rand_bits)
        for g, w, part in zip(q, qr, ("codes", "scale", "zero")):
            check(torch.equal(g, w), f"K1 {what} {mode}: {part} differ in "
                  f"{(g != w).sum().item()} places")
        return q, dict(
            shape=what, nb=nb, mode=mode,
            ms=cuda_ms(torch, lambda: ops.quantize_pack(x, key, 255, 8, mode, rand_bits),
                       flush=flush),
            kernel_ms=kernel_ms(torch, lambda: ops.quantize_pack(x, key, 255, 8, mode, rand_bits),
                                flush=flush),
            plain_ms=cuda_ms(torch, lambda: ref.quantize_pack_key_ref(x, key, 255, 8, mode,
                                                                      rand_bits),
                             reps=3, flush=flush),
            bound=bound(4 * n + n + 8 * nb, flops=5 * n,
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
        f"bound {r['bound'][0]:.4f} by {r['bound'][1]})")
    for r in rows["dequantize_buckets"]:
        log_decode_row("K5 dequantize_buckets", r, log)
    del x, rand, q, qr

    # K3: tolerance against plain, both x dtypes; times in bf16 (main path)
    # beside torch.matmul on the dense bf16 weight
    k3 = []
    for what, (m, k, n, n_seg) in K3_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        nb = k * n // 1024
        codes, s, z = ops.quantize_pack(w.reshape(nb, 1024), prng.PRNGKey(k), 255, 8, "shift")
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
        wd = ref.unpack_dequantize_ref(codes.reshape(nb, 1024), s.reshape(nb, 1),
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
            max_abs_err=err))
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
        big = max(rows[name], key=lambda r: r["bound"][0])
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
    ap.add_argument("--phases", default="build,kernels,small,serve,train",
                    help="comma-separated subset of build,kernels,small,serve,train")
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
        if "train" in phases:
            paths.append(train_phase(torch, log))
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
    """Temporarily replace obj.attr by wrap(original)."""
    orig = getattr(obj, attr)
    setattr(obj, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


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
    weights: gathered weight bytes equal (K1/K2 are bit-exact), logits
    within SMALL_LOGIT_ATOL, same greedy tokens."""
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
    err = max((a - b).abs().max().item() for a, b in zip(lc, lp))
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
# phase 5: gpt-1.3b training
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


def profile_train_step(torch, run_step, state, log):
    """torch.profiler over one train step: device busy share and kernel time
    by name (the trace is read from a temporary file and not kept: a step
    holds ~10^4-10^5 kernels).  Returns K1's and K2's device time and
    launches and the int64 elementwise kernels of the step."""
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
    check(kernels, "profile train: the trace holds no kernel events")
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e["name"], [0.0, 0])
        d[0] += e["dur"]
        d[1] += 1
    log(f"profile train (one step, profiler on): wall {wall_ms:.1f} ms, {len(kernels)} "
        f"kernels, device busy {busy / 1e3:.1f} ms ({100 * busy / 1e3 / wall_ms:.1f}% of wall)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"profile train:   {us / 1e3:9.3f} ms  x{n:6d}  {name[:80]}")

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
    int64_ms, int64_n = total(int64_elementwise)
    _, threefry = total(lambda k: int64_elementwise(k) and bitwise(k))
    return dict(wall_ms=wall_ms, busy_ms=busy / 1e3, kernels=len(kernels), k1_ms=k1_ms,
                k1_n=k1_n, k2_ms=k2_ms, k2_n=k2_n, int64_ms=int64_ms, int64_n=int64_n,
                threefry_int64=threefry)


if __name__ == "__main__":
    raise SystemExit(main())
