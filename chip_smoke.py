#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, each of which makes the script exit non-zero when it fails:

1. build   -- nvcc builds every kernel source of the port, in parallel.
2. kernels -- each CUDA kernel (K1 quantize->pack, K2 unpack->dequantize,
              K3 rowquant matmul) against its plain PyTorch version on the
              card at the gpt-1.3b serve shapes: K1/K2 byte-equal, K3 within
              tolerance; times by CUDA events on cold L2.
3. small   -- the gpt-1.3b smoke config served on the card and on the CPU
              (plain versions, which the CPU tests hold to the JAX package):
              gathered wire bytes equal, f32-compute logits within tolerance.
4. serve   -- gpt-1.3b at full width and depth, batch 4, prompt 128, gen 16,
              greedy, seed 0, through ``build_serve_setup`` ->
              ``ServeEngine.generate``: dense, then rowquant MLP.  Launch
              counts per kernel are checked against the counts the code's
              structure predicts, and the two runs' first decode-step
              logits must agree.

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
    (untimed) L2 flush, by CUDA events; one warm-up launch first."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def bound(nbytes, flops=0.0, flop_rate=F32_FLOP_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

GPT13_NB = {"attn (wq/wk/wv/wo)": 4096, "mlp (w_gate/w_up/w_down)": 16384,
            "embed": 100608}
K3_SHAPES = {"w_gate/w_up": (4, 2048, 8192, 8), "w_down": (4, 8192, 2048, 2)}


def kernel_phase(torch, log):
    from repro_torch.core import prng
    from repro_torch.kernels import ops, ref

    dev = "cuda"
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def key_uniform(nb, cols, lo, hi, seed):
        return prng.uniform(prng.PRNGKey(seed), (nb, cols), dev, lo, hi)

    # K1 + K2 correctness: bits x modes at the MLP shape, byte-equal
    nb = GPT13_NB["mlp (w_gate/w_up/w_down)"]
    x = torch.randn((nb, 1024), generator=gen, device=dev) * 0.02
    for bits in (2, 4, 8):
        for mode in ("nearest", "stochastic", "shift"):
            if mode == "stochastic":
                rand = key_uniform(nb, 1024, 0.0, 1.0, bits)
            elif mode == "shift":
                rand = key_uniform(nb, 1, -0.5, 0.5, bits)
            else:
                rand = torch.zeros((nb, 1), device=dev)
            levels = (1 << bits) - 1
            got = ops.quantize_pack(x, rand, levels, bits, mode)
            want = ref.quantize_pack_ref(x, rand, levels, bits, mode)
            for g, w, what in zip(got, want, ("codes", "scale", "zero")):
                check(torch.equal(g, w), f"K1 bits={bits} mode={mode}: {what} differ "
                      f"in {(g != w).sum().item()} places")
            for dt in (torch.float32, torch.bfloat16):
                d = ops.unpack_dequantize(*got, bits, dt)
                dw = ref.unpack_dequantize_ref(*got, bits, dt)
                check(torch.equal(d.view(torch.uint8), dw.view(torch.uint8)),
                      f"K2 bits={bits} mode={mode} {dt}: values differ")
    log("K1 quantize_pack: byte-equal to plain, bits {2,4,8} x {nearest,stochastic,shift}, "
        f"nb={nb} x 1024")
    log("K2 unpack_dequantize: byte-equal to plain, same cases, f32 and bf16 out")

    # K1/K2 times at every main-path shape (W8, shift, f32 out)
    k1, k2 = [], []
    for what, nb in GPT13_NB.items():
        x = torch.randn((nb, 1024), generator=gen, device=dev) * 0.02
        rand = key_uniform(nb, 1, -0.5, 0.5, nb)
        q = ops.quantize_pack(x, rand, 255, 8, "shift")
        qr = ref.quantize_pack_ref(x, rand, 255, 8, "shift")
        check(all(torch.equal(a, b) for a, b in zip(q, qr)), f"K1 {what}: differs")
        d = ops.unpack_dequantize(*q, 8)
        dr = ref.unpack_dequantize_ref(*q, 8)
        check(torch.equal(d, dr), f"K2 {what}: differs")
        n = nb * 1024
        k1.append(dict(
            shape=what, nb=nb,
            ms=cuda_ms(torch, lambda: ops.quantize_pack(x, rand, 255, 8, "shift"), flush=flush),
            plain_ms=cuda_ms(torch, lambda: ref.quantize_pack_ref(x, rand, 255, 8, "shift"),
                             reps=3, flush=flush),
            bound=bound(4 * n + 4 * nb + n + 8 * nb, flops=5 * n),
            max_abs_err=max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(q, qr))))
        k2.append(dict(
            shape=what, nb=nb,
            ms=cuda_ms(torch, lambda: ops.unpack_dequantize(*q, 8), flush=flush),
            plain_ms=cuda_ms(torch, lambda: ref.unpack_dequantize_ref(*q, 8), reps=3,
                             flush=flush),
            bound=bound(n + 8 * nb + 4 * n, flops=2 * n),
            max_abs_err=(d - dr).abs().max().item()))
        del x, rand, q, qr, d, dr
    for r in k1:
        log(f"K1 {r['shape']:26s} nb={r['nb']:6d}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound'][0]:.4f} by {r['bound'][1]})")
    for r in k2:
        log(f"K2 {r['shape']:26s} nb={r['nb']:6d}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound'][0]:.4f} by {r['bound'][1]})")
    rows["quantize_pack"] = k1
    rows["unpack_dequantize"] = k2

    # K3: tolerance against plain, both x dtypes; times in bf16 (main path)
    k3 = []
    for what, (m, k, n, n_seg) in K3_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        nb = k * n // 1024
        rand = key_uniform(nb, 1, -0.5, 0.5, k)
        codes, s, z = ops.quantize_pack(w.reshape(nb, 1024), rand, 255, 8, "shift")
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
            bound=bound(nbytes, flops=2 * m * k * n + 4 * m * k * n_seg),
            max_abs_err=err))
        del w, codes, s, z, wd
    for r in k3:
        log(f"K3 {r['shape']:12s} M={r['m']} K={r['k']} N={r['n']}: {r['ms']:.4f} ms "
            f"(plain {r['plain_ms']:.4f}, torch.matmul bf16 {r['library_ms']:.4f}, "
            f"bound {r['bound'][0]:.4f} by {r['bound'][1]})")
    rows["rowquant_matmul"] = k3
    return rows


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

KERNEL_META = {
    "quantize_pack": ("src/repro_torch/kernels/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:164"),
    "unpack_dequantize": ("src/repro_torch/kernels/csrc/quantize.cu",
                          "src/repro/kernels/quantize.py:231"),
    "rowquant_matmul": ("src/repro_torch/kernels/csrc/dequant_matmul.cu",
                        "src/repro/kernels/dequant_matmul.py:50"),
}


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
    ap.add_argument("--phases", default="build,kernels,small,serve",
                    help="comma-separated subset of build,kernels,small,serve")
    ap.add_argument("--profile", action="store_true",
                    help="serve phase: also profile one decode step of each run "
                         "(chrome traces under chiprun_out/)")
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
                    if "registers" in line or "error" in line.lower():
                        log(f"nvcc {name}: {line.strip()}")
            log(f"build: {time.time() - tb:.1f} s")
        rows = kernel_phase(torch, log) if "kernels" in phases else None
        launches = {}
        if "small" in phases:
            small_phase(torch, log)
        if "serve" in phases:
            launches = serve_phase(torch, log, profile=args.profile)
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
    def wrap(orig):
        def f(name, full):
            n = model.specs[name].n_logical_local(model.ms.model_size)
            raw = full[:n].contiguous().cpu().numpy().tobytes()
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


def expected_launches(model, gen: int, rowquant: bool) -> dict:
    """Kernel launches of generate() by the code's structure: every decode
    step (and the prefill) quantizes each quantized tensor once (K1) and
    densely decodes each one (K2) -- except, with rowquant, the decode MLP
    weights, which go through K3 instead of K2."""
    from repro_torch.models.decode import ROWQUANT_MLP
    eng = model.engine
    n_q = sum((s.stack or 1) for s in eng.specs.values() if eng._is_quantized(s))
    n_rq = sum(s.stack or 1 for n, s in eng.specs.items()
               if n.split("/")[-1] in ROWQUANT_MLP and eng.rowquant_eligible(n)) if rowquant else 0
    steps = gen - 1
    return {"quantize_pack": n_q * gen,
            "unpack_dequantize": n_q * gen - n_rq * steps,
            "rowquant_matmul": n_rq * steps,
            "per_step": (n_q, n_q - n_rq, n_rq)}


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
            check(counts[k] == want[k], f"{tag}: {k} launched {counts[k]} times, "
                  f"the code's structure predicts {want[k]}")
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
    kernels = [e for e in events if e.get("cat") == "kernel"]
    check(kernels, f"profile {tag}: the trace holds no kernel events")
    busy, end = 0.0, None
    for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
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


if __name__ == "__main__":
    raise SystemExit(main())
