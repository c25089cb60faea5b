"""Search strategies over the design space (the JAX package's
``tune/search.py``): brute force for small composed spaces, seeded
simulated annealing when the space explodes.

Both are deterministic: exhaustive by construction, annealing through an
explicit ``np.random.default_rng(seed)`` with a fixed iteration count, so
reruns pick the same plan (and the reference's draws: numpy only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from .space import Candidate


def exhaustive_search(candidates: Sequence[Candidate],
                      cost_fn: Callable[[Candidate], float]):
    """Score every candidate; return [(cost, candidate)] best-first with a
    stable tiebreak (candidate label) so equal-cost reruns agree."""
    scored = [(float(cost_fn(c)), c) for c in candidates]
    scored.sort(key=lambda t: (t[0], t[1].label()))
    return scored


def simulated_annealing(candidates: Sequence[Candidate],
                        cost_fn: Callable[[Candidate], float],
                        *, seed: int = 0, iters: int = 200,
                        t0: float = 1.0, t1: float = 1e-3):
    """Anneal over the candidate list by single-axis mutation: propose a
    candidate agreeing with the current one on all but one knob.  Costs are
    memoized.  Returns the same best-first [(cost, candidate)] shape as
    exhaustive_search (the evaluated subset only)."""
    rng = np.random.default_rng(seed)
    pool = list(candidates)
    if not pool:
        return []
    cache: dict[Candidate, float] = {}

    def cost(c: Candidate) -> float:
        if c not in cache:
            cache[c] = float(cost_fn(c))
        return cache[c]

    fields = [f.name for f in dataclasses.fields(Candidate)]
    cur = pool[int(rng.integers(len(pool)))]
    cur_cost = cost(cur)
    for i in range(iters):
        t = t0 * (t1 / t0) ** (i / max(iters - 1, 1))
        ax = fields[int(rng.integers(len(fields)))]
        neighbors = [c for c in pool
                     if getattr(c, ax) != getattr(cur, ax)
                     and all(getattr(c, f) == getattr(cur, f)
                             for f in fields if f != ax)]
        if not neighbors:
            continue
        nxt = neighbors[int(rng.integers(len(neighbors)))]
        nxt_cost = cost(nxt)
        if (nxt_cost <= cur_cost
                or rng.random() < math.exp((cur_cost - nxt_cost) / max(t, 1e-12))):
            cur, cur_cost = nxt, nxt_cost
    return sorted(((cost, cand) for cand, cost in cache.items()),
                  key=lambda t: (t[0], t[1].label()))
