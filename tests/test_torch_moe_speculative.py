"""Self-speculative decoding of the MoE family in the port's
ContinuousScheduler against the JAX package's on the CPU, on the models of
``test_torch_moe_scheduler.py``: a 4-bit draft of depth 4 whose expert
stacks stay 3-D wire codes, decoded through K2 (never rowquant).  Committed
streams and ``stats()`` (acceptance included) equal the JAX scheduler's."""
import pytest

from _torch_serve_common import MESH, requests, schedulers
from test_torch_moe_scheduler import FAMILIES
from repro.serve import Request as JRequest
from repro_torch.serve import Request


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_moe_speculative_matches_jax(family):
    """Blocking admission over rings, 4 slots, a 4-bit draft of depth 4:
    committed streams and acceptance equal the JAX scheduler's, and drafts
    were accepted."""
    js, ts = schedulers(slots=4, draft_bits=4, draft_depth=4, cfg_kw=FAMILIES[family])
    reqs = requests([(False, False, 4, 7), (False, True, 6, 6), (False, False, 4, 8),
                     (False, False, 6, 6), (False, True, 4, 1)], seed=21)
    for r in reqs:
        js.submit(JRequest(**r))
        ts.submit(Request(**r))
    with MESH:
        jd = js.run(max_steps=500)
    td = ts.run(max_steps=500)
    assert {r: c.tokens.tolist() for r, c in td.items()} == \
        {r: c.tokens.tolist() for r, c in jd.items()}
    jst, tst = js.stats(), ts.stats()
    assert {k: tst[k] for k in jst} == jst
    assert tst["verify_launches"] > 0 and tst["spec_tokens"] > tst["spec_lane_steps"]
