"""The composed quant-and-schedule design space the autotuner searches
(the JAX package's ``tune/space.py``: the same axes, labels, validity rule
and enumeration order).

A :class:`Candidate` is one point: the QSDP comm policy knobs plus the
serve-side scheduler knobs.  ``enumerate_space`` yields only *valid*
combinations (prefetch requires coalesce, draft bits pair with draft
depth, ...), the constraints the launchers validate at parse time.

Two tiers:
  * quality-neutral (default): coalesce / prefetch / the per-layer byte
    threshold -- these permute launches, not values; gradients stay
    bit-exact, so the tuner may flip them freely.
  * quality-affecting (--full-space): bits / bucket / meta dtype -- these
    change the quantization error, so they enter the search only when asked
    for (and the plan records them).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Optional

from ..core.qsdp import QSDPConfig


@dataclasses.dataclass(frozen=True)
class Candidate:
    # comm policy (train + serve weight gathers)
    coalesce: bool = True
    prefetch: bool = False
    coalesce_max_bytes: Optional[int] = None
    weight_bits: int = 8
    grad_bits: int = 8
    bucket_size: int = 1024
    weight_mode: str = "shift"
    grad_mode: str = "stochastic"
    meta_wire_dtype: str = "float32"
    # serve schedule
    slots: int = 8
    prefill_chunk: int = 0
    prefill_buckets: int = 4
    draft_bits: int = 0
    draft_depth: int = 0

    def label(self) -> str:
        co = ("coalesced" if self.coalesce_max_bytes is None else
              f"coalesce<={self.coalesce_max_bytes}B") if self.coalesce else "per-tensor"
        tag = f"W{self.weight_bits}G{self.grad_bits} b{self.bucket_size} {co}"
        if self.prefetch:
            tag += "+prefetch"
        if self.meta_wire_dtype != "float32":
            tag += f" meta={self.meta_wire_dtype}"
        return tag

    def valid(self) -> bool:
        return (
            not (self.prefetch and not self.coalesce)
            and 2 <= self.weight_bits <= 8
            and 2 <= self.grad_bits <= 8
            and self.bucket_size > 0
            and (self.draft_bits > 0) == (self.draft_depth > 1)
            and (self.draft_bits == 0 or 2 <= self.draft_bits <= 8)
        )

    def to_qsdp(self, base: QSDPConfig) -> QSDPConfig:
        return dataclasses.replace(
            base, coalesce=self.coalesce, prefetch=self.prefetch,
            coalesce_max_bytes=self.coalesce_max_bytes,
            weight_bits=self.weight_bits, grad_bits=self.grad_bits,
            bucket_size=self.bucket_size, weight_mode=self.weight_mode,
            grad_mode=self.grad_mode, meta_wire_dtype=self.meta_wire_dtype)

    def axes_dict(self) -> dict:
        return dataclasses.asdict(self)


def enumerate_space(*, thresholds: tuple[Optional[int], ...] = (None,),
                    full_space: bool = False,
                    serve_slots: tuple[int, ...] = (8,),
                    base: Optional[Candidate] = None) -> Iterator[Candidate]:
    """Yield every valid candidate.  `thresholds` injects cost-model-derived
    ``coalesce_max_bytes`` cut points (the crossover) next to None."""
    base = base or Candidate()
    schedule = []
    for co, pf in ((False, False), (True, False), (True, True)):
        ths = thresholds if co else (None,)
        for th in ths:
            schedule.append((co, pf, th))
    if full_space:
        quant = itertools.product((4, 6, 8), (4, 8), (256, 1024),
                                  ("float32", "bfloat16"))
    else:
        quant = [(base.weight_bits, base.grad_bits, base.bucket_size,
                  base.meta_wire_dtype)]
    for (co, pf, th), (wb, gb, bsz, meta), slots in itertools.product(
            schedule, quant, serve_slots):
        cand = dataclasses.replace(
            base, coalesce=co, prefetch=pf, coalesce_max_bytes=th,
            weight_bits=wb, grad_bits=gb, bucket_size=bsz,
            meta_wire_dtype=meta, slots=slots)
        if cand.valid():
            yield cand
