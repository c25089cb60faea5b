"""Finding / rule / baseline plumbing shared by every qlint pass (the JAX
package's ``analysis/findings.py``; the jaxpr rules read a traced op graph
here, ``trace_audit.py``).

A finding's identity is ``(rule, site)`` — `site` is a stable fingerprint
that deliberately excludes line numbers (those shift on every edit), so a
baseline entry keeps suppressing the same finding across refactors.  The
port's ``analysis/qlint_baseline.json`` maps identities to one-line
justifications; the gate fails on any finding without one.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

BASELINE_VERSION = 1
REPORT_VERSION = 1

# Stable rule catalog.  IDs are append-only: never renumber, never reuse.
RULES = {
    # trace audit (the reference's jaxpr audit; same IDs)
    "QJ101": "redundant quantize->dequantize->quantize round-trip in the traced "
             "op graph (dequantized values re-quantized with no intervening "
             "compute)",
    "QJ102": "u8 wire buffer widened (u8->float conversion in the traced op "
             "graph) before a collective — bytes on the wire silently multiply",
    "QJ103": "nondeterminism-hazard op in the traced op graph of a "
             "bit-identity-guarded path (decode/prefill/verify must replay "
             "exactly)",
    # key audit
    "QK201": "quantization key collision: one derived key feeds two tensors "
             "(correlates shift-mode rounding noise, breaking unbiasedness)",
    "QK202": "FNV-1a name-hash collision in _h/_stable_hash key folds",
    "QK203": "reserved fold-salt overlap (microbatch/layer index range "
             "intersects a reserved salt or group offset)",
    # collective audit
    "QC301": "compiled collective launch count diverges from "
             "tune.cost_model.predict_hlo_gather_counts (at one rank: a "
             "collective in the counted step, or kernel launches per layer "
             "off the engine's gather structure)",
    "QC302": "compiled collective wire bytes exceed the analytic budget",
    "QC303": "DeploymentPlan drift: plan's recorded per-group policy/bytes "
             "disagree with the engine the plan builds",
    # source lint
    "QS401": "host sync (.item()/.cpu()/.tolist()/.numpy()/"
             "torch.cuda.synchronize) inside ContinuousScheduler's per-step loop",
    "QS402": "prng.PRNGKey(<literal>) or manual_seed(<literal>) in library "
             "code (seeds belong to callers / launchers)",
    "QS403": "direct call into kernels/ bypassing the kernels.ops "
             "dispatch surface (import the kernels.ops wrappers instead)",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str               # key into RULES
    site: str               # stable fingerprint, no line numbers
    message: str            # human-readable detail
    path: str = ""          # best-effort location (diagnostic only)
    line: int = 0           # best-effort location (diagnostic only)

    def ident(self) -> tuple[str, str]:
        return (self.rule, self.site)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["rule_doc"] = RULES.get(self.rule, "?")
        return d

    def __str__(self) -> str:
        loc = f" [{self.path}:{self.line}]" if self.path else ""
        return f"{self.rule} {self.site}{loc}: {self.message}"


def load_baseline(path: Optional[str]) -> dict[tuple[str, str], str]:
    """{(rule, site): justification}.  Missing file == empty baseline."""
    if not path:
        return {}
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return {}
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline version {doc.get('version')!r} != {BASELINE_VERSION} "
            f"— regenerate with qlint --update-baseline")
    out = {}
    for s in doc.get("suppressions", []):
        out[(s["rule"], s["site"])] = s.get("justify", "")
    return out


def save_baseline(path: str, findings: list[Finding],
                  old: Optional[dict[tuple[str, str], str]] = None) -> None:
    """Write every current finding as a suppression, keeping existing
    justifications; new entries get a TODO placeholder to be hand-edited."""
    old = old or {}
    sup = [
        {"rule": f.rule, "site": f.site,
         "justify": old.get(f.ident(), "TODO: justify or fix")}
        for f in sorted(set(findings), key=lambda f: f.ident())
    ]
    with open(path, "w") as f:
        json.dump({"version": BASELINE_VERSION, "suppressions": sup},
                  f, indent=1, sort_keys=False)
        f.write("\n")


def partition_findings(findings: list[Finding],
                       baseline: dict[tuple[str, str], str]):
    """-> (new, suppressed, unused_suppression_idents)."""
    new, suppressed = [], []
    seen = set()
    for f in findings:
        seen.add(f.ident())
        (suppressed if f.ident() in baseline else new).append(f)
    unused = sorted(k for k in baseline if k not in seen)
    return new, suppressed, unused


def make_report(per_pass: dict[str, list[Finding]],
                baseline: dict[tuple[str, str], str],
                meta: Optional[dict] = None) -> dict:
    """JSON-able audit report (the CI artifact)."""
    all_f = [f for fs in per_pass.values() for f in fs]
    new, suppressed, unused = partition_findings(all_f, baseline)
    return {
        "version": REPORT_VERSION,
        "meta": meta or {},
        "rules": RULES,
        "passes": {
            name: [f.to_dict() for f in fs] for name, fs in per_pass.items()
        },
        "new": [f.to_dict() for f in new],
        "suppressed": [
            {**f.to_dict(), "justify": baseline[f.ident()]} for f in suppressed
        ],
        "unused_suppressions": [list(k) for k in unused],
        "ok": not new,
    }
