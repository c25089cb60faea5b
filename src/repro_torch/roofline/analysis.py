"""Peak rates of the card the port runs on, as the JAX package's
``roofline/analysis.py:33`` records its chip's.  The HLO parsing of that
module has no counterpart here: the port compiles no HLO (a roofline from
``torch.profiler`` is ROADMAP A12b)."""
from __future__ import annotations

import dataclasses


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
