"""Self-speculative decoding over the paged KV pool (chunked admission,
prefix sharing) in the port's ContinuousScheduler against the JAX
package's on the CPU: committed streams and acceptance statistics equal the
JAX scheduler's, and every committed stream, greedy and sampled, equals the
request's non-speculative batch-of-1 solo run on a fixed-shape route of two
lane blocks of 2 (the ring file runs one block of 4).  Set-up in
``_torch_spec_common.py``."""
from _torch_spec_common import _jax_sched, _port_sched, _reqs, _run, _solo
from repro.serve import Request as JRequest


def test_speculative_matches_jax_paged():
    """Greedy and sampled streams, and the acceptance rate with every launch
    count, equal the JAX scheduler's; drafts were accepted."""
    reqs = _reqs(22, "jax")
    jt, jd = _run(_jax_sched(True), reqs, JRequest)
    tt, td = _run(_port_sched(True), reqs)
    assert tt == jt
    assert td == jd
    assert td["verify_launches"] > 0 and td["spec_tokens"] > td["spec_lane_steps"]


def test_speculative_matches_batch_of_one_solo_paged():
    """Every committed stream is the batch-of-1 solo run on the same route
    (lanes in two blocks of 2)."""
    reqs = _reqs(38, "solo")
    tt, td = _run(_port_sched(True, 2), reqs)
    assert tt == _solo(True, reqs, 2)
    assert td["spec_tokens"] > td["spec_lane_steps"]
