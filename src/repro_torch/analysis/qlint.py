"""qlint CLI of the port — run the static-analysis passes and gate on the
baseline (the JAX package's ``analysis/qlint.py``: the same flags, report
and exit codes).

    PYTHONPATH=src python -m repro_torch.analysis.qlint --all \\
        [--arch gpt-125m] [--mesh 1,1] [--plan PLAN.json] \\
        [--baseline src/repro_torch/analysis/qlint_baseline.json] \\
        [--report QLINT_REPORT.json]

Exit codes: 0 = no non-baselined findings, 1 = new findings (printed and
written to the JSON report), 2 = a pass crashed (or ``--mesh`` names more
than one rank: the port audits one, ROADMAP A12e).
``--update-baseline`` rewrites the baseline from the current findings (new
entries get a TODO justification to hand-edit — suppressions are
code-reviewed, not generated).  The pass ``jaxpr`` keeps the reference's
name: here it is the trace audit (``trace_audit.py``), which runs the
programs on the meta device under a dispatch mode.  No pass needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

PASSES = ("lint", "key", "jaxpr", "collective")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.qlint",
                                 description=__doc__)
    ap.add_argument("--all", action="store_true",
                    help="run every pass (same as --passes "
                         + ",".join(PASSES) + ")")
    ap.add_argument("--passes", default="",
                    help="comma-separated subset of: " + ",".join(PASSES))
    ap.add_argument("--arch", default="gpt-125m",
                    help="config family the traced/compiled passes use")
    ap.add_argument("--mesh", default="1,1",
                    help="data,model mesh for the collective audit")
    ap.add_argument("--plan", default=None,
                    help="DeploymentPlan JSON the collective audit checks")
    ap.add_argument("--root", default=None,
                    help="source tree for the lint pass (default: src/repro_torch)")
    ap.add_argument("--baseline", default=None,
                    help="suppression file (default: qlint_baseline.json "
                         "beside this module)")
    ap.add_argument("--report", default=None,
                    help="write the JSON audit report here")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    return ap.parse_args(argv)


def _default_baseline() -> str:
    return str(Path(__file__).resolve().parent / "qlint_baseline.json")


def main(argv=None) -> int:
    args = parse_args(argv)
    names = [p.strip() for p in args.passes.split(",") if p.strip()]
    if args.all or not names:
        names = list(PASSES)
    bad = set(names) - set(PASSES)
    if bad:
        print(f"unknown passes: {sorted(bad)}", file=sys.stderr)
        return 2

    mesh_shape = tuple(int(x) for x in args.mesh.split(","))
    if mesh_shape != (1, 1):
        print(f"--mesh {args.mesh}: the port audits one rank (1,1); an audit over more "
              "ranks is not ported yet (ROADMAP A12e)", file=sys.stderr)
        return 2

    from .findings import (load_baseline, make_report, partition_findings,
                           save_baseline)

    baseline_path = args.baseline or _default_baseline()
    baseline = load_baseline(baseline_path)

    per_pass = {}
    extra = {}
    crashed = False
    for name in names:
        try:
            if name == "lint":
                from . import source_lint
                per_pass[name] = source_lint.run(args.root)
            elif name == "key":
                from . import key_audit
                per_pass[name] = key_audit.run()
            elif name == "jaxpr":
                from . import trace_audit
                launches = {}
                per_pass[name] = trace_audit.run(args.arch, report=launches)
                extra["trace_launches"] = launches
            elif name == "collective":
                from . import collective_audit
                detail = {}
                per_pass[name] = collective_audit.run(
                    args.arch, mesh_shape, args.plan, report=detail)
                extra["collective"] = detail
        except Exception as e:  # a crashed pass must fail the gate loudly
            crashed = True
            per_pass[name] = []
            extra.setdefault("crashes", {})[name] = f"{type(e).__name__}: {e}"
            print(f"[qlint] pass '{name}' crashed: {type(e).__name__}: {e}",
                  file=sys.stderr)

    all_findings = [f for fs in per_pass.values() for f in fs]
    new, suppressed, unused = partition_findings(all_findings, baseline)

    if args.update_baseline:
        save_baseline(baseline_path, all_findings, baseline)
        print(f"[qlint] wrote {len(set(all_findings))} suppression(s) to "
              f"{baseline_path}")

    report = make_report(per_pass, baseline,
                         meta={"arch": args.arch, "mesh": list(mesh_shape),
                               "plan": args.plan, "passes": names, **extra})
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")

    for f in new:
        print(f"[qlint] NEW {f}")
    for k in unused:
        print(f"[qlint] warning: unused suppression {k[0]} {k[1]}")
    print(f"[qlint] passes={','.join(names)} findings={len(all_findings)} "
          f"new={len(new)} suppressed={len(suppressed)}")
    if crashed:
        return 2
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
