"""The paged KV block pool of the port against the JAX package's, on the CPU.

  (a) ``BlockPool`` and the JAX ``BlockPool`` driven by the same random
      sequences of operations (alloc, decref, incref, register, lookup,
      cold lookup, copy-on-write, demote, rehydrate, unregister, touch):
      the same returned ids and refusals, the same free list, refcounts,
      prefix table, LRU order, cold store and statistics after every
      operation, and both pools' invariants;
  (b) the cold tier's codec: ``encode_block`` wire bytes byte-equal to the
      JAX package's, and ``decode_block`` byte-equal to
      ``block_qdq_reference`` (and to the JAX decode);
  (c) ``prefix_keys`` equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve import kv_pool as jpool
from repro_torch.serve import kv_pool as tpool


def _state(pool):
    return dict(free=list(pool._free), ref=[int(r) for r in pool._ref],
                key_of=dict(pool._key_of), cached=list(pool._cached.items()),
                cold=list(pool._cold), cold_idle=dict(pool._cold_idle), stats=dict(pool.stats),
                free_blocks=pool.free_blocks, in_use=pool.blocks_in_use)


def _apply(pool, op, arg, now, cold):
    """One operation; returns what it returned, or the exception's type."""
    try:
        if op == "alloc":
            return pool.alloc(now)
        if op == "decref":
            return pool.decref(arg, now)
        if op == "incref":
            return pool.incref(arg)
        if op == "register":
            return pool.register(("k", arg[1]), arg[0])
        if op == "lookup":
            return pool.lookup(("k", arg), now)
        if op == "cow":
            return pool.cow_fork(arg, now)
        if op == "unregister":
            return pool.unregister(arg)
        if op == "touch":
            return pool.touch(arg, now)
        if op == "demote":
            ids = pool.demotable(now)
            for bid in ids:
                pool.demote(bid, cold, now)
            return ids
        if op == "rehydrate":
            key = ("k", arg)
            if pool.lookup_cold(key) is None:
                return None
            return pool.rehydrate(key, now)[0]
    except (RuntimeError, KeyError, IndexError) as e:
        return type(e).__name__
    raise ValueError(op)


OPS = ("alloc", "alloc", "decref", "incref", "register", "lookup", "cow", "unregister",
       "touch", "demote", "rehydrate")


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000), n_blocks=st.integers(2, 10), n_ops=st.integers(1, 150),
       horizon=st.integers(0, 4))
def test_block_pool_matches_jax(seed, n_blocks, n_ops, horizon):
    rng = np.random.default_rng(seed)
    kw = dict(quant_bits=4 if horizon else 0, quant_horizon=horizon, hot_block_bytes=1024)
    jp, tp = jpool.BlockPool(n_blocks, 8, **kw), tpool.BlockPool(n_blocks, 8, **kw)
    jcold = jpool.ColdBlock(np.zeros(4, np.uint8), np.zeros(4, np.uint8), (1, 8, 1, 2),
                            jp.quant_cfg)
    tcold = tpool.ColdBlock(torch.zeros(4, dtype=torch.uint8), torch.zeros(4, dtype=torch.uint8),
                            (1, 8, 1, 2), tp.quant_cfg)
    for now in range(n_ops):
        op = OPS[int(rng.integers(len(OPS)))]
        bid = int(rng.integers(n_blocks))
        arg = {"register": (bid, int(rng.integers(6))), "lookup": int(rng.integers(6)),
               "rehydrate": int(rng.integers(6))}.get(op, bid)
        if op in ("decref", "incref", "cow", "touch", "unregister") or op == "register":
            # only on blocks the caller holds, as the scheduler does
            b = arg[0] if op == "register" else arg
            if jp.ref(b) < 1 and op != "touch":
                continue
        got_j = _apply(jp, op, arg, now, jcold)
        got_t = _apply(tp, op, arg, now, tcold)
        assert got_j == got_t, (now, op, arg)
        assert _state(jp) == _state(tp), (now, op, arg)
        tp.check_invariants()
    assert tp.capacity_stats() == jp.capacity_stats()


def test_exhausted_pool_raises_the_same():
    for mod in (jpool, tpool):
        pool = mod.BlockPool(2, 4)
        pool.alloc()
        pool.alloc()
        with pytest.raises(mod.PoolExhausted):
            pool.alloc()


@pytest.mark.parametrize("bits,bucket,shape", [(4, 128, (2, 8, 2, 16)), (2, 32, (1, 4, 2, 16)),
                                               (8, 128, (3, 8, 2, 16)), (4, 128, (2, 8, 3, 7))])
def test_cold_block_codec_bytes_equal_jax(bits, bucket, shape):
    rng = np.random.default_rng(bits * 100 + bucket)
    k = (rng.standard_normal(shape) * 3).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jcfg, tcfg = jpool.kv_quant_config(bits, bucket), tpool.kv_quant_config(bits, bucket)
    assert (tcfg.bits, tcfg.bucket_size, tcfg.mode, tcfg.meta_dtype) == \
        (jcfg.bits, jcfg.bucket_size, jcfg.mode, jcfg.meta_dtype)
    jcold = jpool.encode_block(k, v, jcfg)
    for kin, vin in ((k, v), (k.astype(jnp.bfloat16), v.astype(jnp.bfloat16))):
        tin = [torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16 if a.dtype != np.float32 else torch.float32) for a in (kin, vin)]
        tcold = tpool.encode_block(*tin, tcfg)
        if kin is k:
            assert tcold.k_wire.numpy().tobytes() == jcold.k_wire.tobytes()
            assert tcold.v_wire.numpy().tobytes() == jcold.v_wire.tobytes()
        else:  # a bf16 hot block encodes its exact f32 values
            ref = jpool.encode_block(np.asarray(kin, np.float32), np.asarray(vin, np.float32),
                                     jcfg)
            assert tcold.k_wire.numpy().tobytes() == ref.k_wire.tobytes()
        assert tcold.nbytes == tcold.k_wire.numel() * 2 and tcold.shape == shape
    tcold = tpool.encode_block(torch.from_numpy(k), torch.from_numpy(v), tcfg)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        kd, vd = tpool.decode_block(tcold, dt)
        jk, jv = jpool.decode_block(jcold, jdt)
        assert kd.dtype == dt and tuple(kd.shape) == shape
        for got, want in ((kd, jk), (vd, jv)):
            assert got.float().numpy().tobytes() == np.asarray(want, np.float32).tobytes()
    kd, vd = tpool.decode_block(tcold, torch.float32)
    assert torch.equal(kd, tpool.block_qdq_reference(torch.from_numpy(k), tcfg))
    assert torch.equal(vd, tpool.block_qdq_reference(torch.from_numpy(v), tcfg))


def test_prefix_keys_equal():
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 50, size=37).tolist()
    for bs in (1, 4, 8, 40):
        assert tpool.prefix_keys(prompt, bs) == jpool.prefix_keys(prompt, bs)
