"""Render the roofline tables from the port's dry-run sweeps (the JAX
package's ``benchmarks/roofline_report.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/torch_bench/dryrun_qsdp.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --baseline-fsdp \\
      --out results/torch_bench/dryrun_baseline.jsonl
  PYTHONPATH=src python -m repro_torch.experiments.roofline_report

Reads the QSDP and baseline-FSDP records (one JSON record a line) and
emits a markdown report: per (arch x shape x mesh) the three roofline terms
on the H100, the dominant bottleneck, MODEL_FLOPS / counted FLOPs, and the
QSDP-vs-baseline collective-byte reduction.  The tables, columns and
summary lines are the reference's; the header names the H100, and the
completeness check expects the dry run's 40 pairs on its one mesh (the
reference's 80 are 40 on each of two meshes).
"""
from __future__ import annotations

import argparse
import json
import os

from ..roofline import HW_H100

OUT_DIR = "results/torch_bench"
PAIRS = 40  # ten assigned archs x four shapes, on the 1x1 mesh


def load(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(l) for l in f]


def fmt_s(t):
    return f"{t*1e3:10.1f}ms"


def header(hw=HW_H100) -> list[str]:
    return [f"# Roofline report (H100: {hw.peak_flops / 1e12:.0f} TF/s bf16, "
            f"{hw.hbm_bw / 1e9:.0f} GB/s HBM, {hw.ici_bw / 1e9:.0f} GB/s NVLink)",
            "",
            "Terms are per-device seconds for ONE step, derived from the",
            "dry run's op counts on the meta device (roofline.counter).  `useful` =",
            "MODEL_FLOPS / counted FLOPs per device.  `coll x` = baseline-FSDP /",
            "QSDP collective bytes (the paper's wire compression).", ""]


def main(argv=None, out_dir=OUT_DIR):
    ap = argparse.ArgumentParser()
    ap.add_argument("--qsdp", default=os.path.join(OUT_DIR, "dryrun_qsdp.jsonl"))
    ap.add_argument("--baseline", default=os.path.join(OUT_DIR, "dryrun_baseline.jsonl"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.makedirs(out_dir, exist_ok=True)
    out_path = args.out or os.path.join(out_dir, "roofline_report.md")

    qs = {(r["arch"], r["shape"], r["mesh"]): r for r in load(args.qsdp) if r.get("ok")}
    bs = {(r["arch"], r["shape"], r["mesh"]): r for r in load(args.baseline) if r.get("ok")}

    lines = header()
    hdr = (f"| {'arch':22s} | {'shape':11s} | {'mesh':8s} | {'T_compute':>11s} "
           f"| {'T_mem_min':>11s} | {'T_mem_max':>11s} | {'T_coll':>11s} | {'bound':10s} | {'useful':>6s} "
           f"| {'coll x':>6s} | {'HBM fit':>8s} |")
    lines.append(hdr)
    lines.append("|" + "-" * (len(hdr) - 2) + "|")
    n_pairs = 0
    for key in sorted(qs):
        r = qs[key]
        b = bs.get(key)
        ratio = (b["collective_bytes"] / max(r["collective_bytes"], 1)) if b else None
        temp = (r.get("memory") or {}).get("temp")
        fit = "n/a" if temp is None else f"{temp/2**30:6.1f}GB"
        tmn = fmt_s(r.get("t_memory_min", r["t_memory"]))
        rtxt = f"{ratio:6.2f}" if ratio else "  n/a "
        lines.append(
            f"| {key[0]:22s} | {key[1]:11s} | {key[2]:8s} | {fmt_s(r['t_compute'])} "
            f"| {tmn} | {fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} "
            f"| {r['bottleneck']:10s} | {r['useful_flops_ratio']:6.3f} "
            f"| {rtxt} | {fit:>8s} |")
        n_pairs += 1

    # summary block
    from collections import Counter
    bns = Counter(r["bottleneck"] for r in qs.values())
    ratios = [bs[k]["collective_bytes"] / max(qs[k]["collective_bytes"], 1)
              for k in qs if k in bs]
    lines += ["", f"- pairs: {n_pairs} (expect {PAIRS} on one mesh)",
              f"- bottleneck census: {dict(bns)}",
              f"- QSDP collective-byte reduction vs baseline FSDP: "
              f"min {min(ratios):.2f}x / median {sorted(ratios)[len(ratios)//2]:.2f}x / "
              f"max {max(ratios):.2f}x" if ratios else "- no baseline comparison"]
    text = "\n".join(lines)
    with open(out_path, "w") as f:
        f.write(text + "\n")
    print(text)
    ok = n_pairs >= PAIRS
    print("\nroofline_report:", f"PASS ({n_pairs}/{PAIRS})" if ok
          else f"INCOMPLETE ({n_pairs}/{PAIRS})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
