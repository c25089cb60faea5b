"""The port's ContinuousScheduler against the JAX package's on the CPU:
blocking and chunked admission over private KV rings, greedy and sampled
requests mixed.  Every request gets the same tokens, and ``stats()``
agree (the port adds ``sampled_launches``).  Set-up in
``tests/_torch_serve_common.py``."""
import pytest

from _torch_serve_common import BUCKETS, CHUNK, requests, run_both, schedulers

# (shared prefix?, sampled?, prompt tokens, new tokens): mixed lengths on 3
# slots, so requests retire and admit mid-decode
PLAN = [(False, False, 3, 4), (True, True, 5, 3), (False, False, 9, 6), (True, False, 2, 5),
        (False, True, 7, 2), (True, True, 4, 6), (False, False, 1, 3), (True, False, 6, 4)]


@pytest.mark.parametrize("admission", ["blocking", "chunked"])
def test_scheduler_matches_jax(admission):
    kw = dict(prefill_chunk=CHUNK, prefill_buckets=BUCKETS) if admission == "chunked" else {}
    js, ts = schedulers(**kw)
    reqs = requests(PLAN, seed=11 if admission == "chunked" else 5)
    jt, tt = run_both(js, ts, reqs)
    assert set(jt) == set(tt) == {r["rid"] for r in reqs}
    for r in reqs:
        assert tt[r["rid"]] == jt[r["rid"]], r["rid"]
    jst, tst = js.stats(), ts.stats()
    assert {k: tst[k] for k in jst} == jst
    assert tst["sampled_launches"] > 0 and tst["decode_steps"] > 0
    if admission == "chunked":
        assert tst["prefill_chunks"] > len(reqs) and tst["prefill_traces"] > 1
