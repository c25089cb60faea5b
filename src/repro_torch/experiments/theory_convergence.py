"""Theorem 2 / Corollary 3 convergence (the paper's Section 4), the JAX
package's ``benchmarks/theory_convergence.py`` on the port.

Produces the convergence table: quantized SGD with the random-shift weight
quantizer converges to the lattice-optimum band; naive round-to-nearest on
the coarse grid stalls; adding an unbiased gradient quantizer (Corollary 3)
preserves convergence.  The seeds of each variant run as one batch (a row
of keys), each seed's iteration its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from ..core import prng
from ..core.theory import make_quadratic, run_qsgd, theorem2_params
from ..device import resolve_device

OUT_DIR = "results/torch_bench"


def main(argv=None, out_dir=OUT_DIR):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8, help="seeds averaged per variant")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(out_dir, exist_ok=True)
    key = prng.PRNGKey(0)
    keys = prng.key_rows([prng.PRNGKey(s) for s in range(args.seeds)], device)
    rows = []
    for kappa in (2.0, 4.0, 8.0):
        obj = make_quadratic(key, n=64, kappa=kappa, device=device)
        delta_star, eps = 0.5, 1e-3
        x0 = torch.zeros(64, device=device)
        params = theorem2_params(obj.alpha, obj.beta, delta_star, eps, 0.0,
                                 f0_gap=float(obj.f(x0)))
        bench = obj.lattice_opt_value(delta_star, prng.PRNGKey(7))

        def avg_final(weight_q, grad_q_delta=None, delta=None):
            p = params if delta is None else dataclasses.replace(params, delta=delta)
            xs, _ = run_qsgd(obj, x0, p, keys, weight_q=weight_q, grad_q_delta=grad_q_delta,
                             device=device)
            return float(np.mean(obj.f(xs).cpu().numpy()))

        f_shift = avg_final("shift")
        f_none = avg_final("none")
        f_rtn_coarse = avg_final("nearest", delta=delta_star)
        f_shift_coarse = avg_final("shift", delta=delta_star)
        f_gq = avg_final("shift", grad_q_delta=0.05)
        rows.append(dict(
            kappa=kappa, T=params.T, eta=params.eta, delta=params.delta,
            lattice_opt=bench, shift=f_shift, unquantized=f_none,
            rtn_coarse=f_rtn_coarse, shift_coarse=f_shift_coarse,
            shift_gradquant=f_gq,
            theorem_holds=bool(f_shift <= bench + eps + 1e-6),
            gq_holds=bool(f_gq <= bench + eps + 1e-6),
        ))

    with open(os.path.join(out_dir, "theory_convergence.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print(f"\n# Theorem 2 convergence (f(x_T), avg of {args.seeds} seeds; "
          "target = lattice_opt + 1e-3)")
    hdr = (f"{'kappa':>6} {'T':>5} {'lattice_opt':>12} {'QSGD(shift)':>12} {'+gradQ':>10} "
           f"{'RTN@d*':>10} {'shift@d*':>10} {'ok':>4}")
    print(hdr)
    for r in rows:
        print(f"{r['kappa']:6.1f} {r['T']:5d} {r['lattice_opt']:12.5f} "
              f"{r['shift']:12.5f} {r['shift_gradquant']:10.5f} "
              f"{r['rtn_coarse']:10.5f} {r['shift_coarse']:10.5f} "
              f"{'Y' if r['theorem_holds'] and r['gq_holds'] else 'N':>4}")
    ok = all(r["theorem_holds"] and r["gq_holds"] for r in rows)
    print("theorem2:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
