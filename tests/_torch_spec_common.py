"""Shared set-up of the speculative-decoding comparison tests
(``test_torch_speculative*.py``): the reference's ``tests/test_speculative.py``
setting (4 slots, a 4-bit draft of depth 4) over the scheduler suite's
model (``tests/_torch_serve_common.py``), a request plan, the JAX scheduler
of each KV layout built once per test module, and the non-speculative
batch-of-1 solo runs."""
import torch

from _torch_serve_common import (BUCKETS, CHUNK, GATHER_SEED, MESH, models, requests,
                                 schedulers, spec_kw)
from repro.serve import Request as JRequest
from repro_torch.core import prng
from repro_torch.models.decode import DecodeSpec
from repro_torch.serve import ContinuousScheduler, Request, ServeEngine, make_sample_params

BITS, DEPTH, SLOTS = 4, 4, 4
# (behind the shared prefix?, sampled?, prompt tokens, new tokens): 3 greedy
# and 3 sampled requests, so lanes retire mid-window and drafts of several
# depths share a verify launch; two prompt lengths keep the JAX scheduler's
# blocking admission at two compiled prefill shapes
PLAN = [(False, False, 4, 7), (False, True, 6, 6), (False, False, 4, 8), (False, False, 6, 6),
        (False, True, 4, 1), (False, True, 6, 8)]
STATS = ("spec_tokens", "spec_lane_steps", "draft_launches", "draft_lane_steps",
         "verify_launches", "decode_launches", "tokens_generated")
_jax: dict = {}


def _reqs(seed, tag):
    """PLAN's requests under rids of their own (the JAX schedulers serve
    several tests)."""
    return [dict(r, rid=f"{tag}.{r['rid']}") for r in requests(PLAN, seed=seed)]


def _kw(paged):
    return dict(prefill_chunk=CHUNK, prefill_buckets=BUCKETS) if paged else {}


def _jax_sched(paged):
    """The JAX scheduler of a layout, built once (its steps compile once)."""
    if paged not in _jax:
        _jax[paged] = schedulers(slots=SLOTS, paged=paged, draft_bits=BITS, draft_depth=DEPTH,
                                 **_kw(paged))[0]
    return _jax[paged]


def _port_sched(paged, lane_block=0, bits=BITS, depth=DEPTH):
    _, (tm, tp) = models()
    spec = DecodeSpec(**spec_kw(SLOTS, paged, draft_bits=bits, draft_depth=depth),
                      lane_block=lane_block)
    return ContinuousScheduler(tm, spec, tp, "cpu", gather_key=prng.PRNGKey(GATHER_SEED),
                               **_kw(paged))


def _run(sched, reqs, make=Request):
    """Drain `reqs` through `sched`: ({rid: tokens}, the run's stats deltas)."""
    base = sched.stats()
    for r in reqs:
        sched.submit(make(**r))
    if make is JRequest:
        with MESH:
            done = sched.run(max_steps=500)
    else:
        done = sched.run(max_steps=500)
    st = sched.stats()
    return ({r["rid"]: done[r["rid"]].tokens.tolist() for r in reqs},
            {k: st[k] - base[k] for k in STATS})


def _solo(paged, reqs, lane_block=0) -> dict:
    """Each request alone, non-speculative, on a batch-of-1 engine with the
    fixed gather key (the reference's solo form)."""
    _, (tm, tp) = models()
    spec = DecodeSpec(**spec_kw(1, paged), lane_block=lane_block)
    eng = ServeEngine(tm, spec, "cpu")
    out = {}
    for r in reqs:
        out[r["rid"]] = eng.generate(
            tp, {"tokens": torch.tensor([r["prompt"]])}, r["max_new_tokens"],
            key=prng.PRNGKey(GATHER_SEED), fold_step_keys=False,
            sample=make_sample_params(r["temperature"], r["top_k"], r["seed"]),
            **_kw(paged))[0].tolist()
    return out
