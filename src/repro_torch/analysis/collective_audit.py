"""Collective audit: the counted step vs the cost model's promises
(QC301-303), the JAX package's ``analysis/collective_audit.py``.

The reference compiles the forward at two stack depths, takes the
per-layer MARGINAL collective counts / wire bytes from its HLO analyzer
and diffs them against ``tune.cost_model.predict_hlo_gather_counts`` plus
the engine's analytic wire-byte budget.  The port has no HLO: it builds
the train step at two depths on the meta device
(``launch.dryrun.build_step``), counts one microbatch of each under the
dry run's counter (``roofline.counter``) and takes the per-layer marginal
(``counter.marginal``).  At one rank no collective is launched, so both
sides read zero, as on the reference's (1, 1) mesh where every collective
degenerates to group size 1 and is compiled away; any collective in the
marginal is itself a finding.  What one rank does launch are the kernels:
the marginal K1/K2 launches per layer must equal what the engine's gather
structure derives (:func:`train_layer_launches`, from
``core.qsdp.layer_kernel_launches``: per gather, K1 encodes each quantized
tensor and K2 decodes each wire buffer, the coalesced layer's one buffer
being its ``core.qsdp.layer_gather_launches`` = 1 collective), or QC301
names the kernel.  With a DeploymentPlan the engine
is built from the plan's qsdp section and the plan's recorded per-group
policies are cross-checked against that engine (drift = a stale plan).

More than one rank (``--mesh`` other than 1,1) needs a count of every
rank's step and its collectives (ROADMAP A12e): :func:`audit` refuses it.

The count/byte differs are pure functions of the counts, so seeded
regression tests drive them with hand-written numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .findings import Finding

# marginal-byte slack: XLA may pad buffers to tile boundaries
WIRE_SLACK_FRAC = 0.10
WIRE_SLACK_BYTES = 4096


def diff_gather_counts(marginal_counts: dict, predicted: int,
                       tag: str) -> list[Finding]:
    """QC301 on any divergence between measured marginal collective counts
    and the cost model's prediction.  `marginal_counts` is the per-layer
    marginal of the counter's ``['collectives']['counts']`` (the
    reference's ``analyze_hlo`` key)."""
    out = []
    got = marginal_counts.get("all-gather", 0)
    if got != predicted:
        out.append(Finding(
            "QC301", f"{tag}::all-gather",
            f"compiled marginal all-gather count {got} != cost-model "
            f"prediction {predicted}"))
    for kind, n in sorted(marginal_counts.items()):
        if kind not in ("all-gather", "reduce-scatter", "all-reduce") and n:
            out.append(Finding(
                "QC301", f"{tag}::unexpected::{kind}",
                f"{n} unexplained '{kind}' launch(es) in the forward "
                f"marginal (only gathers belong on this path)"))
    return out


def diff_wire_bytes(marginal_wire: float, budget: float,
                    tag: str) -> list[Finding]:
    """QC302 when marginal on-the-wire bytes exceed the analytic budget."""
    limit = budget * (1 + WIRE_SLACK_FRAC) + WIRE_SLACK_BYTES
    if marginal_wire > limit:
        return [Finding(
            "QC302", f"{tag}::all-gather-bytes",
            f"compiled marginal all-gather wire bytes {marginal_wire:.0f} "
            f"exceed analytic budget {budget:.0f} (+slack {limit:.0f})")]
    return []


def check_plan_drift(plan, engine, tag: str) -> list[Finding]:
    """QC303: the plan's recorded per-group policy/bytes must match the
    engine its own qsdp section builds."""
    out = []
    for lp in plan.layers:
        names = tuple(sorted(n for n in engine.specs
                             if n.startswith(f"{lp.group}/")))
        if not names:
            if lp.group in engine.specs:
                names = (lp.group,)
            else:
                out.append(Finding(
                    "QC303", f"{tag}::{lp.group}::missing",
                    f"plan records group '{lp.group}' absent from the "
                    f"engine's spec tree"))
                continue
        got_co = engine.layer_coalesced(names)
        got_bytes = engine.layer_wire_bytes(names)
        if got_co != lp.coalesce:
            out.append(Finding(
                "QC303", f"{tag}::{lp.group}::coalesce",
                f"plan says coalesce={lp.coalesce} for '{lp.group}' but the "
                f"engine built from the plan decides {got_co}"))
        if got_bytes != lp.wire_buffer_bytes:
            out.append(Finding(
                "QC303", f"{tag}::{lp.group}::wire-bytes",
                f"plan records {lp.wire_buffer_bytes} wire bytes for "
                f"'{lp.group}', engine computes {got_bytes}"))
    return out


# ---------------------------------------------------------------------------
# Counting harness
# ---------------------------------------------------------------------------

DEPTHS = (2, 4)  # the stack depths whose counts give the per-layer marginal


def train_layer_launches(engine, names, n_micro: int = 1) -> dict[str, int]:
    """K1/K2 launches one stacked layer of `names` adds to a train step of
    `n_micro` microbatches at one rank: per microbatch its forward gather,
    the checkpoint's replay of it and the gradient's reduce-scatter, each as
    ``core.qsdp.layer_kernel_launches`` counts it.  Under the prefetch
    pipeline (a coalesced stack of two layers or more) the replay decodes
    the buffer the forward gathered: its K2 again, no K1."""
    from ..core.qsdp import layer_kernel_launches

    c = layer_kernel_launches(engine, names)
    encodes = 1 if engine.cfg.prefetch and engine.layer_coalesced(tuple(names)) else 2
    return {"quantize_pack": n_micro * (encodes * c["gather"][0] + c["reduce"][0]),
            "unpack_dequantize": n_micro * (2 * c["gather"][1] + c["reduce"][1])}


def _step_counts(mcfg, qcfg, n_layers: int) -> dict:
    """The counter's dict for one microbatch of the train step of `mcfg`
    cut to `n_layers`, on meta."""
    from ..launch.dryrun import build_step, count

    c = dataclasses.replace(mcfg, n_layers=n_layers)
    return count(build_step(c.name, "train_4k", qcfg, cfg=c), 1)


def audit(arch: str = "gpt-125m", mesh_shape=(1, 1),
          plan_path: Optional[str] = None, smoke: bool = True,
          report: Optional[dict] = None) -> list[Finding]:
    from .. import configs
    from ..core.qsdp import QSDPConfig
    from ..launch.dryrun import MS11
    from ..models.transformer import Model
    from ..roofline.counter import marginal
    from ..tune.cost_model import predict_hlo_gather_counts

    if tuple(mesh_shape) != MS11.shape:
        raise NotImplementedError(
            f"mesh {tuple(mesh_shape)}: the collective audit counts one rank; an audit over "
            "more ranks is not ported yet (ROADMAP A12e)")
    ms = MS11
    mcfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
    tag = f"{mcfg.name}@{ms.shape[0]}x{ms.shape[1]}"

    findings: list[Finding] = []
    if plan_path:
        from ..tune.plan import DeploymentPlan
        plan = DeploymentPlan.load(plan_path)
        plan.validate_mesh(ms.axes, ms.shape)
        qcfg = plan.to_qsdp_config(QSDPConfig(min_quant_size=256))
        engine = Model(mcfg, ms, qcfg).engine
        findings.extend(check_plan_drift(plan, engine, tag))
    else:
        qcfg = QSDPConfig(min_quant_size=256, coalesce=True)
        engine = Model(mcfg, ms, qcfg).engine

    layer_names = sorted(n for n in engine.specs if n.startswith("layers/"))
    predicted = predict_hlo_gather_counts(engine, layer_names)

    lo, hi = DEPTHS
    marg = marginal(_step_counts(mcfg, qcfg, hi), _step_counts(mcfg, qcfg, lo), hi - lo)
    coll = marg["collectives"]
    marg_counts = dict(coll["counts"])
    marg_wire = coll["all-gather"]

    findings.extend(diff_gather_counts(marg_counts, predicted, tag))
    # analytic budget: the gathered wire buffer crosses the ring once
    # -> B * (p-1)/p bytes on the wire per gather
    p = ms.fsdp_size
    buf = engine.layer_wire_bytes(tuple(layer_names))
    budget = buf * (p - 1) / p if p > 1 else 0.0
    findings.extend(diff_wire_bytes(marg_wire, budget, tag))

    launches = {k: v for k, v in sorted(marg["launches"].items()) if v}
    want = {k: v for k, v in train_layer_launches(engine, layer_names).items() if v}
    for k in sorted(set(launches) | set(want)):
        if launches.get(k, 0) != want.get(k, 0):
            findings.append(Finding(
                "QC301", f"{tag}::launches::{k}",
                f"counted marginal {k} launches per layer {launches.get(k, 0)} != the "
                f"engine's gather structure {want.get(k, 0)}"))

    if report is not None:
        report[tag] = {
            "predicted_marginal_all_gather": predicted,
            "marginal_counts": {k: v for k, v in sorted(marg_counts.items())
                                if v},
            "marginal_all_gather_wire_bytes": marg_wire,
            "analytic_wire_budget_bytes": budget,
            "layer_wire_buffer_bytes": buf,
            "marginal_launches": launches,
            "predicted_marginal_launches": want,
        }
    return findings


def run(arch: str = "gpt-125m", mesh_shape=(1, 1),
        plan_path: Optional[str] = None,
        report: Optional[dict] = None) -> list[Finding]:
    return audit(arch, mesh_shape, plan_path, report=report)
