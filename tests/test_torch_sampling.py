"""The serving sampler of the port against the JAX package, on the CPU.

  (a) ``kernels.ops.random_bits`` (its plain version here) byte-equal to
      ``jax.random.bits`` per row, and ``prng.fold_in_rows`` equal to
      ``vmap(jax.random.fold_in)``;
  (b) ``prng.gumbel`` within GUMBEL_ATOL of ``jax.random.gumbel`` (the same
      bits and uniforms; torch's and XLA's ``log`` may differ by an ulp);
  (c) ``layers.sample_vocab_parallel`` against the JAX one on seeded
      logits over temperature / top-k / greedy rows: greedy rows equal bit
      for bit, sampled rows equal wherever the top two perturbed logits lie
      further apart than the tolerance the noise and the logits' division
      carry, and the test counts the rows inside it and expects none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.models import layers as jlayers
from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers

# |torch log - XLA log| on the f32 Gumbel noise, measured 9.5e-7 over 50,304
# draws (values up to ~17); a wrong uniform or key gives O(1)
GUMBEL_ATOL = 1e-5
# per-row margin below which two perturbed logits could swap: the noise's
# tolerance plus the f32 rounding of logits / temperature
MARGIN_TOL = 2 * GUMBEL_ATOL


@pytest.mark.parametrize("seed,data,n", [(0, 1, 1), (5, 17, 256), (123, 2**31 + 7, 50304),
                                         (2**32 - 1, 0, 1000)])
def test_random_bits_plain_equals_jax(seed, data, n):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    keys = prng.fold_in_rows(torch.tensor([prng.PRNGKey(seed)]), torch.tensor([data]))
    assert keys.tolist() == [np.asarray(jax.random.key_data(key)).tolist()]
    got = ops.random_bits(prng.as_i32(keys), n)
    assert got.dtype == torch.int32 and got.shape == (1, n)
    want = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), want)


def test_fold_in_rows_equals_vmap():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, size=(6, 2), dtype=np.uint64).astype(np.uint32)
    data = rng.integers(0, 2**31, size=6).astype(np.uint32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(data)))
    got = prng.fold_in_rows(torch.from_numpy(keys.astype(np.int64)),
                            torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_gumbel_within_tolerance():
    key = jax.random.fold_in(jax.random.PRNGKey(11), 42)
    want = np.asarray(jax.random.gumbel(key, (50304,), jnp.float32))
    got = prng.gumbel(tuple(int(w) for w in np.asarray(jax.random.key_data(key))),
                      (50304,)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=GUMBEL_ATOL)


def _jax_sample(logits, temp, top_k, keys):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    fn = shard_map(lambda lg, t, k, kk: jlayers.sample_vocab_parallel(lg, lg.shape[1], t, k, kk),
                   mesh=mesh, in_specs=(P(), P(), P(), P()), out_specs=P(), check_vma=False)
    with mesh:
        return np.asarray(jax.jit(fn)(jnp.asarray(logits), jnp.asarray(temp),
                                      jnp.asarray(top_k), jnp.asarray(keys)))


@pytest.mark.parametrize("vocab", [256, 1024])
def test_sample_vocab_parallel_matches_jax(vocab):
    rng = np.random.default_rng(vocab)
    rows = 24
    logits = (rng.standard_normal((rows, vocab)) * 2).astype(np.float32)
    temp = rng.choice([0.0, 0.3, 0.8, 1.3], size=rows).astype(np.float32)
    top_k = rng.choice([0, 1, 5, 40], size=rows).astype(np.int32)
    keys = rng.integers(0, 2**32, size=(rows, 2), dtype=np.uint64).astype(np.uint32)
    want = _jax_sample(logits, temp, top_k, keys)
    got = tlayers.sample_vocab_parallel(torch.from_numpy(logits), vocab,
                                        torch.from_numpy(temp), torch.from_numpy(top_k),
                                        torch.from_numpy(keys.astype(np.int64))).numpy()
    greedy = (temp <= 0) | (top_k == 1)
    assert greedy.any() and (~greedy).any()
    np.testing.assert_array_equal(got[greedy], np.argmax(logits[greedy], -1))
    np.testing.assert_array_equal(want[greedy], got[greedy])
    # the sampled rows' perturbed logits, with the JAX package's noise
    close = 0
    for r in np.nonzero(~greedy)[0]:
        noise = np.asarray(jax.random.gumbel(jnp.asarray(keys[r]), (vocab,), jnp.float32))
        z = logits[r] / max(temp[r], 1e-6) + noise
        if top_k[r] > 0:
            z[logits[r] < np.sort(logits[r])[vocab - top_k[r]]] = -np.inf
        top2 = np.sort(z)[-2:]
        if top2[1] - top2[0] <= MARGIN_TOL:
            close += 1
        else:
            assert got[r] == want[r] == np.argmax(z), r
    assert close == 0, f"{close} sampled rows inside the tolerance"


def test_sampler_draws_only_for_sampled_rows():
    """One random_bits call for the sampled rows; an all-greedy batch draws
    nothing (counted by wrapping the wrapper: the CPU runs the plain
    version, which counts no launch)."""
    calls = []
    orig = ops.random_bits

    def counted(keys, n):
        calls.append(tuple(keys.shape))
        return orig(keys, n)
    logits = torch.randn((4, 64), generator=torch.Generator().manual_seed(0))
    keys = torch.tensor([prng.PRNGKey(i) for i in range(4)])
    try:
        ops.random_bits = counted
        tlayers.sample_vocab_parallel(logits, 64, torch.tensor([0.0, 0.0, 0.5, 0.0]),
                                      torch.tensor([0, 1, 3, 7]), keys)
        tlayers.sample_vocab_parallel(logits, 64, torch.zeros(4), torch.zeros(4, dtype=torch.int64),
                                      keys)
    finally:
        ops.random_bits = orig
    assert calls == [(1, 2)]
