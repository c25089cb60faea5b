"""The port's ContinuousScheduler serving the MoE family against the JAX
package's on the CPU, on the reference's own MoE scheduler-suite model
(``tests/test_serve_scheduler.py:45-51``: 2 layers, d_model 64, 4 experts
top-2, whose experts have moe_d_ff 0) and on the same model with experts of
width 64: blocking and chunked admission over private rings.  Every stream,
greedy and sampled, and ``stats()`` equal the JAX scheduler's.  The paged
pool and speculative decoding are in ``test_torch_moe_scheduler_paged.py``;
set-up in ``tests/_torch_serve_common.py``."""
import pytest

from _torch_serve_common import (BUCKETS, CHUNK, MOE_CFG, MOE_FF_CFG, requests, run_both,
                                 schedulers)

FAMILIES = {"reference": MOE_CFG, "experts": MOE_FF_CFG}
# (shared prefix?, sampled?, prompt tokens, new tokens): mixed lengths on 3
# slots, so requests retire and admit mid-decode
PLAN = [(False, False, 3, 4), (True, True, 5, 3), (False, False, 9, 6), (True, False, 2, 5),
        (False, True, 7, 2), (True, True, 4, 6)]


def _same(js, ts, reqs):
    jt, tt = run_both(js, ts, reqs)
    assert set(jt) == set(tt) == {r["rid"] for r in reqs}
    for r in reqs:
        assert tt[r["rid"]] == jt[r["rid"]], r["rid"]
    jst, tst = js.stats(), ts.stats()
    assert {k: tst[k] for k in jst} == jst
    return tst


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("admission", ["blocking", "chunked"])
def test_moe_scheduler_matches_jax(admission, family):
    kw = dict(prefill_chunk=CHUNK, prefill_buckets=BUCKETS) if admission == "chunked" else {}
    js, ts = schedulers(cfg_kw=FAMILIES[family], **kw)
    st = _same(js, ts, requests(PLAN, seed=11 if admission == "chunked" else 5))
    assert st["sampled_launches"] > 0 and st["decode_steps"] > 0


