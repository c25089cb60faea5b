"""Per-layer analytic cost models of the deployment-plan autotuner (the JAX
package's ``tune/cost_model.py``: the same arithmetic in the same order, so
its floats are the reference's).

Each schedulable unit -- a layer group's gather and its gradient
reduce-scatter -- gets a closed-form cost composed from a few hardware
constants; the search scores whole candidates by summing the per-layer
terms, and only the shortlist is measured:

    t_per_tensor = L_pt * t_launch + wire / link_bw
    t_coalesced  = L_co * t_launch + wire / link_bw + buf / ser_bw

Coalescing leaves the wire bytes alone and collapses L_pt = 3*n_quant +
n_fp launches into L_co = 1, but adds passes over the ONE gathered buffer
of ``buf = P * nbytes`` bytes.  Equating the two gives the crossover

    buf* = (L_pt - L_co) * t_launch * ser_bw

below which coalescing wins.  At one rank (the only mesh the autotuner
tunes) the wire term is 0 (a gather receives P - 1 = 0 shards), and the
other two are what the card spends on a layer's gather: host dispatch per
launch against passes over the coalesced buffer.  The two-level exchanges
(``hierarchical`` on a "pod" mesh) launch each level: L_co = 2 and 3 a
level a quantized tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core import collectives as coll
from ..core.qsdp import QSDPEngine
from ..core.quant import fp_segment_bytes, wire_segment_bytes
from ..roofline.analysis import HW_H100, Hardware

# ---------------------------------------------------------------------------
# Hardware presets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostParams:
    """The constants the per-layer models compose over."""

    hw: Hardware          # roofline part (peak flops / hbm / link bw)
    t_launch_s: float     # fixed dispatch+sync overhead per collective launch
    ser_bw: float         # effective B/s of the coalesce serialize/decode passes

    @property
    def name(self) -> str:
        return self.hw.name


# cpu-smoke: the JAX package's constants, calibrated against its emulated
# 8-device CPU mesh (ser_bw ~ 4 MB/s effective: interpreted per-op
# overhead, not memcpy); kept so the port's plans compare with the
# reference's byte for byte
HW_CPU_SMOKE = Hardware(name="cpu-smoke", peak_flops=5e10, hbm_bw=2e10,
                        ici_bw=2e9)
CPU_SMOKE = CostParams(hw=HW_CPU_SMOKE, t_launch_s=5e-6, ser_bw=4e6)

# h100: fitted by chip_smoke.py's tune phase (run BE, NVIDIA H100 80GB
# HBM3, 700.00 W) on one gpt-1.3b layer at full width: forward + backward of
# QSDPEngine.gather_layer, per tensor 7.8097 ms in 2 x 23 launches and
# coalesced 6.6833 ms in 2 launches over 2 x 67.6 MB of wire buffers (median
# of 20 after warm-up), solved through the model's own equations at wire 0:
# t_pt = L_pt * t_launch, t_co = L_co * t_launch + buf / ser_bw.  t_launch is
# ~3 host-dispatched kernels a collective, and ser_bw absorbs the coalesced
# form's kernels too (21.3 GB/s, not HBM's 3.35 TB/s).  The host sets both
# (the chip machines' hosts differ 1.4-1.8x).
H100 = CostParams(hw=HW_H100, t_launch_s=1.697756e-04, ser_bw=2.132655e+10)

HW_PRESETS: dict[str, CostParams] = {
    "cpu-smoke": CPU_SMOKE,
    "h100": H100,
}


# ---------------------------------------------------------------------------
# Per-layer gather / reduce-scatter costs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GatherCost:
    """One collective event (a layer gather or its grad reduce-scatter)."""

    launches: int     # collective launches
    wire_bytes: int   # per-device bytes on the wire (policy-invariant)
    ser_bytes: int    # coalesced-buffer bytes serialized (0 when per-tensor)

    def time_s(self, cp: CostParams) -> float:
        return (self.launches * cp.t_launch_s
                + self.wire_bytes / cp.hw.ici_bw
                + self.ser_bytes / cp.ser_bw)


def _levels(engine: QSDPEngine) -> int:
    return 2 if engine.cfg.hierarchical and engine.ms.multi_pod else 1


def _per_tensor_launches(engine: QSDPEngine, names: list[str]) -> int:
    lv = _levels(engine)
    return sum(3 * lv if engine._is_quantized(engine.specs[n]) else 1
               for n in names)


def layer_gather_cost(engine: QSDPEngine, names: list[str],
                      coalesced: bool) -> GatherCost:
    """Cost of ONE all-gather of `names` under a forced coalesce policy."""
    ms, cfg = engine.ms, engine.cfg
    p = ms.fsdp_size
    wfp = 4 if cfg.weight_wire_dtype == "float32" else 2
    wire = sum(coll.gather_wire_bytes(
        engine.specs[n].n_local(ms), p,
        cfg.wcfg() if engine._is_quantized(engine.specs[n]) else None, wfp)
        for n in names)
    if coalesced:
        return GatherCost(launches=_levels(engine), wire_bytes=wire,
                          ser_bytes=engine.layer_wire_bytes(tuple(names)))
    return GatherCost(launches=_per_tensor_launches(engine, names),
                      wire_bytes=wire, ser_bytes=0)


def layer_rs_cost(engine: QSDPEngine, names: list[str],
                  coalesced: bool) -> GatherCost:
    """Cost of ONE gradient reduce-scatter of `names` (same structure: the
    coalesced form ships one chunked u8 buffer of ~P * per-chunk bytes)."""
    ms, cfg = engine.ms, engine.cfg
    p = ms.fsdp_size
    gfp = 4 if cfg.grad_wire_dtype == "float32" else 2
    wire = buf = 0
    for n in names:
        spec = engine.specs[n]
        n_local = spec.n_local(ms)
        gq = cfg.gcfg() if engine._is_grad_quantized(spec) else None
        wire += coll.reduce_scatter_wire_bytes(n_local * p, p, gq, gfp)
        # coalesced RS buffer: P chunk-rows, each one shard's worth
        buf += p * (wire_segment_bytes(n_local, gq) if gq is not None
                    else fp_segment_bytes(n_local, cfg.grad_wire_dtype))
    if coalesced:
        return GatherCost(launches=_levels(engine), wire_bytes=wire,
                          ser_bytes=buf)
    return GatherCost(launches=_per_tensor_launches(engine, names),
                      wire_bytes=wire, ser_bytes=0)


def crossover_bytes(engine: QSDPEngine, names: list[str],
                    cp: CostParams) -> int:
    """Gathered-buffer size at which coalescing `names` stops paying:
    buf* = (L_pt - L_co) * t_launch * ser_bw."""
    saved = _per_tensor_launches(engine, names) - _levels(engine)
    return max(int(saved * cp.t_launch_s * cp.ser_bw), 0)


# ---------------------------------------------------------------------------
# Visible launch prediction
# ---------------------------------------------------------------------------


def predict_hlo_gather_counts(engine: QSDPEngine, names: list[str],
                              coalesced: Optional[bool] = None) -> int:
    """All-gather launches a compiled step shows for ONE gather of `names`
    (the reference's conformance count against its HLO analyzer): only
    collectives over more than one rank count, so at one rank every
    gather is invisible and this is 0; under two levels each level of more
    than one rank counts.  `coalesced` forces the policy; None uses
    ``engine.layer_coalesced``."""
    ms = engine.ms
    if coalesced is None:
        coalesced = engine.layer_coalesced(tuple(names))
    hier = engine.cfg.hierarchical and ms.multi_pod
    levels = [ms.pod_size, ms.data_size] if hier else [ms.fsdp_size]
    visible = [sz for sz in levels if sz > 1]
    if coalesced:
        return len(visible)
    total = 0
    for n in names:
        if engine._is_quantized(engine.specs[n]):
            # 3 per visible level hierarchically, else 3 over the joint axis
            total += 3 * (len(visible) if hier else (1 if ms.fsdp_size > 1 else 0))
        else:
            # fp payloads ride ONE all-gather over the joint FSDP axes
            total += 1 if ms.fsdp_size > 1 else 0
    return total


# ---------------------------------------------------------------------------
# Step-level composition
# ---------------------------------------------------------------------------


def layer_groups(engine: QSDPEngine) -> list[tuple[str, list[str], int]]:
    """(group name, param names, gathers per stack traversal) -- stacked
    specs grouped by their prefix (the layer loop gathers each slice once
    per traversal), non-stacked params as singleton groups."""
    grouped: dict[str, list[str]] = {}
    singles: list[tuple[str, list[str], int]] = []
    stacks: dict[str, int] = {}
    for name, spec in sorted(engine.specs.items()):
        if spec.stack is not None and "/" in name:
            g = name.split("/", 1)[0]
            grouped.setdefault(g, []).append(name)
            stacks[g] = spec.stack
        else:
            singles.append((name, [name], 1))
    out = [(g, ns, stacks[g]) for g, ns in sorted(grouped.items())]
    return out + singles


def predict_step_time(engine: QSDPEngine, cp: CostParams, *,
                      n_micro: int = 1,
                      coalesced_groups: Optional[dict[str, bool]] = None,
                      t_compute_s: float = 0.0) -> float:
    """Predicted seconds per train step: a compute floor (optional) + the
    comm terms of the FSDP schedule -- per microbatch each layer is
    gathered twice (forward + remat backward) and reduce-scattered once."""
    total = t_compute_s
    for group, names, stack in layer_groups(engine):
        if coalesced_groups is not None:
            co = coalesced_groups[group]
        else:
            co = engine.layer_coalesced(tuple(names))
        g = layer_gather_cost(engine, names, co)
        r = layer_rs_cost(engine, names, co)
        total += n_micro * stack * (2 * g.time_s(cp) + r.time_s(cp))
    return total


def plan_layer_policies(engine: QSDPEngine, cp: CostParams):
    """Per-group coalesce decisions + the single ``coalesce_max_bytes``
    threshold that realizes them.

    The engine expresses the policy as ONE byte threshold on the gathered
    buffer (coalesce iff buffer <= threshold), so the search is over the
    expressible cuts: 0 plus each group's buffer size.  For every cut, sum
    each group's predicted gather+RS time under the decision that cut
    induces (weighted by the stack depth), and keep the cheapest.

    Returns (policies, coalesce_max_bytes); coalesce_max_bytes is None when
    the best cut coalesces every group (no threshold needed).
    """
    from .plan import LayerPolicy

    infos = []
    for group, names, stack in layer_groups(engine):
        tco = (layer_gather_cost(engine, names, True).time_s(cp)
               + layer_rs_cost(engine, names, True).time_s(cp))
        tpt = (layer_gather_cost(engine, names, False).time_s(cp)
               + layer_rs_cost(engine, names, False).time_s(cp))
        infos.append((group, names, stack,
                      engine.layer_wire_bytes(tuple(names)), tco, tpt))
    cuts = sorted({0} | {buf for _, _, _, buf, _, _ in infos})
    best_cut, best_total = 0, None
    for t in cuts:
        total = sum(stack * (tco if buf <= t else tpt)
                    for _, _, stack, buf, tco, tpt in infos)
        if best_total is None or total < best_total:
            best_cut, best_total = t, total
    policies = [LayerPolicy(
        group=group,
        coalesce=buf <= best_cut,
        wire_buffer_bytes=buf,
        launches_per_tensor=_per_tensor_launches(engine, names),
        launches_coalesced=_levels(engine),
    ) for group, names, _stack, buf, _tco, _tpt in infos]
    if all(p.coalesce for p in policies):
        return policies, None
    return policies, best_cut
