"""Self-speculative decoding in the port's ContinuousScheduler against the
JAX package's on the CPU, over private KV rings with blocking admission
(the reference's ``tests/test_speculative.py`` setting: 4 slots, a 4-bit
draft of depth 4).  Committed streams and the acceptance statistics equal
the JAX scheduler's on the same requests, greedy and sampled; every
committed stream equals the request's non-speculative batch-of-1 solo run
on the card's fixed-shape route (``DecodeSpec.lane_block``); streams do not
depend on what shares the batch.  The paged pool's cases are in
``test_torch_speculative_paged.py``; set-up in ``_torch_spec_common.py``."""
import dataclasses

from _torch_serve_common import requests
from _torch_spec_common import PLAN, _jax_sched, _port_sched, _reqs, _run, _solo
from repro.serve import Request as JRequest
from repro_torch.serve import Request


def test_speculative_matches_jax():
    """Greedy and sampled streams, and the acceptance rate with every launch
    count, equal the JAX scheduler's; drafts were accepted."""
    reqs = _reqs(21, "jax")
    jt, jd = _run(_jax_sched(False), reqs, JRequest)
    tt, td = _run(_port_sched(False), reqs)
    assert tt == jt
    assert td == jd
    assert td["verify_launches"] > 0 and td["spec_tokens"] > td["spec_lane_steps"]


def test_speculative_matches_batch_of_one_solo():
    """On the card's fixed-shape route (lanes in blocks of 4), every
    committed stream, greedy and sampled, is the request's non-speculative
    batch-of-1 solo run on that route."""
    reqs = _reqs(35, "solo")
    tt, td = _run(_port_sched(False, 4), reqs)
    assert tt == _solo(False, reqs, 4)
    assert td["spec_tokens"] > td["spec_lane_steps"]


def test_acceptance_independent_of_batch_composition():
    """A request's committed stream, and the drafts it accepts, depend on the
    request alone: resubmitted in another order among other requests
    (one with a 1-token budget, a k = 1 lane inside deeper windows) under
    fresh ids, every stream repeats (after the reference's
    ``tests/test_speculative.py:279``)."""
    base = requests(PLAN[:3], seed=41)
    fillers = requests(PLAN[3:], seed=42)
    fillers = [dict(f, rid=f"f{i}") for i, f in enumerate(fillers)]
    fillers[0] = dict(fillers[0], max_new_tokens=1)
    redo = {r["rid"]: dict(r, rid=r["rid"] + ".redo") for r in base}
    sched = _port_sched(False, lane_block=4)
    done_a, _ = _run(sched, base)
    done_b, _ = _run(sched, [fillers[0], redo["r2"], fillers[1], redo["r0"], fillers[2],
                             redo["r1"]])
    for r in base:
        assert done_b[r["rid"] + ".redo"] == done_a[r["rid"]], r["rid"]


def test_speculative_step_launches_and_depths():
    """One speculative step by hand: the draft runs depth - 1 launches with a
    lane's rounds stopping at its own depth, and one verify launch commits
    at most `depth` tokens per lane; a 2-bit draft of depth 3 as well."""
    for bits, depth in ((4, 4), (2, 3)):
        sched = _port_sched(False, bits=bits, depth=depth)
        sched.submit(Request(rid="a", prompt=[1, 2, 3], max_new_tokens=9))
        sched.submit(Request(rid="b", prompt=[4, 5], max_new_tokens=2))
        sched.step()  # admission (prefill tokens) and the first window
        st = sched.stats()
        assert st["verify_launches"] == 1 and st["draft_launches"] == depth - 1
        # lane b has one token left after its prefill token: it decodes plainly
        assert st["draft_lane_steps"] == depth - 1
        assert 2 <= st["tokens_generated"] - st["prefills"] <= depth + 1
        sched.run()
        assert len(sched.finished["a"].tokens) == 9 and len(sched.finished["b"].tokens) == 2
    assert dataclasses.replace(sched.spec, draft_depth=1).speculative is False
