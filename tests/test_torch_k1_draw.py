"""K1 draws its own rounding randomness from the PRNG key.  Its counter
arithmetic (``kernels.ref.k1_counters``: bucket b, lane j -> threefry
counter) and the draws made at those counters (``kernels.ref.draw_rand``,
what the kernel computes in its threads) are byte-equal to ``jax.random``,
and ``core.quant.quantize`` on the key path is byte-equal to the JAX
package's ``core.quant.quantize`` (jnp path and Pallas interpret)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import prng
from repro_torch.core import quant as tq
from repro_torch.kernels import ref

SEEDS = (0, 7, 2**31 - 1)


def _bytes(a):
    return (a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)).tobytes()


@pytest.mark.parametrize("bucket", [100, 256, 1024])
@pytest.mark.parametrize("nb", [1, 33, 4096])
def test_counter_draws_equal_jax_random(nb, bucket):
    for seed in SEEDS:
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5D)
        tk = prng.fold_in(prng.PRNGKey(seed), 0x5D)
        u, scale = ref.draw_rand(tk, nb, bucket, "stochastic", 32)
        assert scale == 1.0 and u.shape == (nb, bucket)
        assert _bytes(u) == _bytes(jax.random.uniform(jk, (nb, bucket)))
        b16, scale = ref.draw_rand(tk, nb, bucket, "stochastic", 16)
        assert scale == 65536.0
        want = np.asarray(jax.random.bits(jk, (nb, bucket), jnp.uint16)).astype(np.float32)
        assert _bytes(b16) == want.tobytes()
        r, scale = ref.draw_rand(tk, nb, bucket, "shift")
        assert scale == 1.0 and r.shape == (nb, 1)
        assert _bytes(r) == _bytes(jax.random.uniform(jk, (nb, 1), minval=-0.5, maxval=0.5))


def test_counters_are_flat_indices():
    c = ref.k1_counters(3, 5, "stochastic")
    assert torch.equal(c.reshape(-1), torch.arange(15))
    assert torch.equal(ref.k1_counters(3, 5, "shift")[:, 0], torch.arange(3))


def test_draw_rand_needs_key_and_bounds_counters():
    r, scale = ref.draw_rand(None, 4, 8, "nearest")
    assert scale == 1.0 and not r.any()
    with pytest.raises(ValueError, match="key"):
        ref.draw_rand(None, 4, 8, "shift")
    with pytest.raises(ValueError, match="2\\*\\*32"):
        ref.draw_rand((0, 1), 1 << 23, 1024, "stochastic")


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("rand_bits", [16, 32])
@pytest.mark.parametrize("mode", ["nearest", "stochastic", "shift"])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_quantize_key_path_equals_jax(bits, mode, rand_bits, backend):
    """The port's quantize(x, cfg, key) against the JAX package's, Pallas
    kernels in interpret mode for backend="pallas"."""
    x = (np.random.default_rng(bits).standard_normal(3000) * 0.3).astype(np.float32)
    jcfg = jq.QuantConfig(bits=bits, bucket_size=256, mode=mode, rand_bits=rand_bits,
                          backend=backend)
    tcfg = tq.QuantConfig(bits=bits, bucket_size=256, mode=mode, rand_bits=rand_bits)
    qj = jq.quantize(jnp.asarray(x), jcfg, jax.random.PRNGKey(bits + 40))
    qt = tq.quantize(torch.from_numpy(x), tcfg, prng.PRNGKey(bits + 40))
    for a, b in ((qj.codes, qt.codes), (qj.scale, qt.scale), (qj.zero, qt.zero)):
        assert _bytes(a) == _bytes(b)
