"""The paged KV pool under the port's ContinuousScheduler, on the CPU.

  (a) against the JAX scheduler (chunked admission, KV block 8, a 4-bit cold
      tier with horizon 2): a greedy request shares a hot prefix block, a
      sampled one rehydrates it from the cold tier, another shares the
      rehydrated block; every request gets the JAX tokens and ``stats()``
      agree, and the pool's invariants hold;
  (b) copy-on-write on ring wrap, held to the invariant the reference's own
      test states (that test fails under JAX 0.9, see
      ``_torch_serve_common._host_block_ops``): across the fork the shared
      block's bytes are unchanged and the writer's copy holds them, and
      every stream equals its solo run on an engine of the scheduler's spec;
  (c) EOS: a request stops at its eos id, taken from a later position of
      its solo stream, and its slot admits the next request.
"""
import numpy as np
import torch

from _torch_serve_common import BLOCK, BUCKETS, CHUNK, RING, models, requests, run_both, schedulers
from repro_torch.core import prng
from repro_torch.models.decode import DecodeSpec
from repro_torch.serve import ContinuousScheduler, Request, ServeEngine

# (shared prefix?, sampled?, prompt tokens after the prefix, new tokens):
# r3 is admitted while r0 holds the prefix block (a greedy hot hit); r4-r6
# keep the slots busy past the horizon after the last holder retires, so r7
# rehydrates the demoted block and r8 shares it hot
PLAN = [(True, False, 3, 3), (True, True, 6, 5), (False, False, 2, 4), (True, False, 2, 3),
        (False, True, 12, 8), (False, False, 14, 7), (False, True, 13, 8), (True, True, 3, 4),
        (True, True, 2, 3)]


def test_paged_prefix_and_cold_tier_match_jax():
    js, ts = schedulers(paged=True, pool_blocks=24, prefill_chunk=CHUNK,
                        prefill_buckets=BUCKETS, kv_quant_bits=4, kv_quant_horizon=2)
    reqs = requests(PLAN, seed=17)
    jt, tt = run_both(js, ts, reqs)
    for r in reqs:
        assert tt[r["rid"]] == jt[r["rid"]], r["rid"]
    jst, tst = js.stats(), ts.stats()
    assert {k: tst[k] for k in jst} == jst
    assert tst["prefix_hits"] >= 2 and tst["demotions"] > 0 and tst["rehydrations"] > 0
    assert tst["blocks_in_use"] == 0
    ts.pool.check_invariants()


def _solo(model, spec, params, prompt, gen, chunk):
    eng = ServeEngine(model, spec, "cpu")
    return eng.generate(params, {"tokens": torch.tensor([prompt])}, gen,
                        key=prng.PRNGKey(7), fold_step_keys=False, prefill_chunk=chunk,
                        prefill_buckets=2)[0].tolist()


def test_paged_wrap_cow_preserves_shared_blocks():
    """Two lanes share a system-prompt block and both wrap their 16-token
    window back into it.  The first to wrap finds the block shared and
    copies on write: across that step the shared block's bytes do not
    change and the writer's private copy holds them (but for the row it
    wrote); the second wraps as sole owner and withdraws the block from the
    prefix table.  Every stream equals its solo run."""
    _, (model, params) = models()
    # a 16-token window; 6 blocks: both wrapping lanes admit together, so the first writer
    # finds the shared block still referenced by the other
    spec = DecodeSpec(cache_len=16, batch_global=2, batch_sharded=False, sampling=True,
                      kv_block_size=BLOCK, kv_pool_blocks=6)
    sched = ContinuousScheduler(model, spec, params, "cpu", gather_key=prng.PRNGKey(7),
                                prefill_chunk=BLOCK, prefill_buckets=2)
    rng = np.random.default_rng(13)
    system = rng.integers(0, 256, size=BLOCK).tolist()
    # (tokens after the system prompt, new tokens): w2 reaches position 16
    # two steps before w1
    reqs = [Request(rid=f"w{i}", prompt=system + rng.integers(0, 256, size=n).tolist(),
                    max_new_tokens=g) for i, (n, g) in enumerate(((2, 2), (2, 10), (4, 10)))]
    sched.submit(reqs[0])
    sched.run()  # registers the system block, retires (block cached)
    bid = next(iter(sched.pool._bid_of.values()))
    extract, _, _ = sched.engine.kv_block_ops()
    for r in reqs[1:]:
        sched.submit(r)
    checked = False
    while sched.queue or sched.n_active():
        forks = sched.pool.stats["cow_forks"]
        before = [t.clone() for t in extract(sched.cache, bid)]
        sched.step()
        if sched.pool.stats["cow_forks"] > forks and not checked:
            lane = int(np.nonzero(sched.block_tables[:, 0] != bid)[0][0])
            copy = extract(sched.cache, int(sched.block_tables[lane, 0]))
            for a, b, c in zip(before, extract(sched.cache, bid), copy):
                assert torch.equal(a.view(torch.int16), b.view(torch.int16))
                assert torch.equal(a[:, 1:].view(torch.int16), c[:, 1:].view(torch.int16))
            assert sched.pool.ref(bid) == 1 and sched.pool.is_registered(bid)
            checked = True
    assert checked and sched.pool.stats["prefix_hits"] >= 2
    assert not sched.pool.is_registered(bid)  # w1 wrapped it as sole owner
    for r in reqs:
        assert sched.finished[r.rid].tokens.tolist() == _solo(
            model, spec, params, r.prompt, r.max_new_tokens, BLOCK), r.rid
    sched.pool.check_invariants()


def test_eos_frees_slot_early():
    (_, _), (tm, tp) = models()
    spec = DecodeSpec(cache_len=RING, batch_global=1, batch_sharded=False, sampling=True,
                      kv_block_size=BLOCK)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 6)]
    solo = [_solo(tm, spec, tp, p, 8, CHUNK) for p in prompts]
    # the eos id: the first token of the stream, after its first, that is new
    j = next(i for i in range(1, 8) if solo[0][i] not in solo[0][:i])
    sched = ContinuousScheduler(tm, spec, tp, "cpu", gather_key=prng.PRNGKey(7),
                                prefill_chunk=CHUNK, prefill_buckets=BUCKETS)
    sched.submit(Request(rid="a", prompt=prompts[0], max_new_tokens=8, eos_id=solo[0][j]))
    sched.submit(Request(rid="b", prompt=prompts[1], max_new_tokens=8))
    out = sched.run()
    assert out["a"].tokens.tolist() == solo[0][:j + 1]
    assert out["b"].tokens.tolist() == solo[1]
    assert out["b"].admit_step <= out["a"].finish_step + 1  # the one slot was reused
    assert sched.stats()["tokens_generated"] == j + 1 + 8
