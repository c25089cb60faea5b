"""Three-term roofline of one step on the card the port runs on (the JAX
package's ``roofline/analysis.py``):

    compute term    = counted FLOPs / peak FLOP/s
    memory term     = counted bytes / HBM bytes/s  (t_memory: every op's
                      inputs and outputs; t_memory_min: the elementwise ops
                      fused away)
    collective term = collective wire bytes / link bytes/s

The counts come from ``roofline.counter`` (an eager step counted op by op,
on the meta device in the dry run) instead of compiled HLO, so the
reference's ``collective_bytes_from_hlo`` has no counterpart; the
arithmetic and the report's fields are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float  # FLOP/s per chip (bf16)
    hbm_bw: float  # B/s per chip
    ici_bw: float  # B/s per link


# NVIDIA H100 80GB HBM3 (SXM), 700 W power limit: the data sheet's dense
# bf16 tensor-core rate, its HBM3 rate and NVLink 4's 450 GB/s a direction
# (900 GB/s both ways over 18 links)
HW_H100 = Hardware(name="h100", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)

# the data sheet's f32 rate outside the tensor cores, for the products the
# port runs in f32 (attention, cross-entropy): the dtype-aware compute floor
# of ``compute_floor``
H100_F32_FLOPS = 67e12


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collectives: dict
    t_compute: float
    t_memory: float  # upper bound (every op's inputs and outputs)
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_flops_ratio: float
    peak_memory_bytes: Optional[float] = None
    bytes_min_per_device: float = 0.0
    t_memory_min: float = 0.0  # lower bound (perfect elementwise fusion)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        return (
            f"{self.arch:24s} {self.shape:12s} {self.mesh:10s} "
            f"Tc={self.t_compute*1e3:9.3f}ms Tm={self.t_memory*1e3:9.3f}ms "
            f"Tcoll={self.t_collective*1e3:9.3f}ms -> {self.bottleneck:10s} "
            f"useful={self.useful_flops_ratio:6.3f}"
        )


def roofline(arch: str, shape: str, mesh: str, counts: dict, n_chips: int,
             model_flops_global: float, hw: Hardware = HW_H100,
             peak_memory: Optional[float] = None) -> RooflineReport:
    """Three-term roofline from a counter's `counts` (``flops``,
    ``traffic_bytes``, ``traffic_min_bytes``, ``collectives``): one peak
    for all FLOPs, the bottleneck decided with the optimistic memory bound,
    as in the reference."""
    flops = float(counts["flops"])
    byts = float(counts["traffic_bytes"])
    byts_min = float(counts.get("traffic_min_bytes", byts))
    coll = counts["collectives"]
    t_c = flops / hw.peak_flops
    t_m = byts / hw.hbm_bw
    t_m_min = byts_min / hw.hbm_bw
    t_x = coll["total"] / hw.ici_bw
    # bottleneck decided with the OPTIMISTIC memory bound: if even the
    # perfectly-fused traffic dominates, the step is genuinely memory-bound
    # on the target; the pessimistic bound only brackets fusion quality.
    bn = max((("compute", t_c), ("memory", t_m_min), ("collective", t_x)),
             key=lambda kv: kv[1])[0]
    mf_per_dev = model_flops_global / n_chips
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh,
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes=float(coll["total"]), collectives=coll,
        t_compute=t_c, t_memory=t_m, t_collective=t_x, bottleneck=bn,
        model_flops=mf_per_dev,
        useful_flops_ratio=(mf_per_dev / flops) if flops else 0.0,
        peak_memory_bytes=peak_memory,
        bytes_min_per_device=byts_min, t_memory_min=t_m_min,
    )


def compute_floor(flops_by_dtype: dict, hw: Hardware = HW_H100,
                  f32_flops: float = H100_F32_FLOPS) -> float:
    """Seconds the products take at their own dtype's peak: f32 (and f64)
    at the f32 rate outside the tensor cores, the rest at `hw`'s bf16
    tensor-core rate.  The report's ``t_compute`` keeps the reference's one
    peak; this is the floor a measured step is held above."""
    return sum(f / (f32_flops if dt in ("f32", "f64") else hw.peak_flops)
               for dt, f in flops_by_dtype.items())
