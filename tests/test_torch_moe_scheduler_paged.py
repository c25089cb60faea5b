"""The paged KV pool of the MoE family in the port's ContinuousScheduler
against the JAX package's on the CPU, on the models of
``test_torch_moe_scheduler.py``: chunked admission into the paged pool with
prefix sharing and its 4-bit cold tier.  Every stream and ``stats()`` equal
the JAX scheduler's."""
import pytest

from _torch_serve_common import BUCKETS, CHUNK, requests, schedulers
from test_torch_moe_scheduler import FAMILIES, _same

# the paged plan of tests/test_torch_scheduler_paged.py: a greedy hot
# prefix hit, a sampled request rehydrating the demoted block, another
# sharing it hot
PAGED_PLAN = [(True, False, 3, 3), (True, True, 6, 5), (False, False, 2, 4),
              (True, False, 2, 3), (False, True, 12, 8), (False, False, 14, 7),
              (False, True, 13, 8), (True, True, 3, 4), (True, True, 2, 3)]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_moe_paged_prefix_and_cold_tier_match_jax(family):
    js, ts = schedulers(paged=True, pool_blocks=24, prefill_chunk=CHUNK, cfg_kw=FAMILIES[family],
                        prefill_buckets=BUCKETS, kv_quant_bits=4, kv_quant_horizon=2)
    st = _same(js, ts, requests(PAGED_PLAN, seed=17))
    assert st["prefix_hits"] >= 2 and st["demotions"] > 0 and st["rehydrations"] > 0
    assert st["blocks_in_use"] == 0
    ts.pool.check_invariants()
