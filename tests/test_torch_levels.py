"""Learned quantization levels (Algorithm 2), port against the JAX
package's ``core/levels.py`` on the CPU, then the claims of
``tests/test_levels.py`` through the port alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import levels as jl
from repro_torch.core import levels as tl
from repro_torch.core import prng
from repro_torch.core.quant import QuantConfig, quantize_dequantize

torch.set_num_threads(1)

# f32 sums over a batch in another order: a level moves by a few ulps of 1
LEVEL_ATOL = 1e-6
TENSOR_LEVEL_ATOL = 1e-5  # two epochs over a (192, 384) tensor
ERR_ATOL = 1e-6


def _values(n, seed=0):
    return (np.random.default_rng(seed).random(n).astype(np.float32)) ** 2


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 8])
def test_uniform_levels_byte_equal(bits):
    assert np.array_equal(np.asarray(jl.uniform_levels(bits)), tl.uniform_levels(bits).numpy())


def test_sequential_and_minibatch_match_reference():
    v = _values(10_000)
    seq = tl.learn_levels_sequential(torch.from_numpy(v[:2000]), tl.uniform_levels(4))
    np.testing.assert_allclose(
        seq.numpy(), jl.learn_levels_sequential(jnp.asarray(v[:2000]), jl.uniform_levels(4)),
        rtol=0, atol=LEVEL_ATOL)
    mb = tl.learn_levels_minibatch(torch.from_numpy(v), tl.uniform_levels(4))
    np.testing.assert_allclose(
        mb.numpy(), jl.learn_levels_minibatch(jnp.asarray(v), jl.uniform_levels(4)),
        rtol=0, atol=LEVEL_ATOL)


def _tensor():
    w = np.random.default_rng(1).standard_normal((192, 384)).astype(np.float32) * 0.02
    return np.sign(w) * np.abs(w) ** 1.5


def test_quantize_dequantize_levels_match_reference():
    w = _tensor()
    lv_j = jl.learn_levels_for_tensor(jnp.asarray(w), jl.LevelsConfig(bits=4, epochs=2))
    lv_t = tl.learn_levels_for_tensor(torch.from_numpy(w), tl.LevelsConfig(bits=4, epochs=2))
    np.testing.assert_allclose(lv_t.numpy(), lv_j, rtol=0, atol=TENSOR_LEVEL_ATOL)
    lv = np.array(lv_j)  # one table on both sides: codes must then be equal
    for seed in (None, 3):
        qj = jl.quantize_levels(jnp.asarray(w), jnp.asarray(lv), 1024,
                                None if seed is None else jax.random.PRNGKey(seed))
        qt = tl.quantize_levels(torch.from_numpy(w), torch.from_numpy(lv), 1024,
                                None if seed is None else prng.PRNGKey(seed))
        assert np.array_equal(np.asarray(qj.codes), qt.codes.numpy())
        assert np.array_equal(np.asarray(qj.scale), qt.scale.numpy())
        assert np.array_equal(np.asarray(qj.zero), qt.zero.numpy())
        assert (qt.shape, qt.size, qt.cfg.bits) == (tuple(qj.shape), qj.size, qj.cfg.bits)
        dj = jl.dequantize_levels(qj, jnp.asarray(lv))
        dt = tl.dequantize_levels(qt, torch.from_numpy(lv))
        np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=ERR_ATOL)
        assert float(tl.compression_error(torch.from_numpy(w), dt)) == pytest.approx(
            float(jl.compression_error(jnp.asarray(w), dj)), abs=ERR_ATOL)
    for bits, bucket in ((3, 256), (5, 1024), (8, 512)):
        qj = jl.quantize_levels(jnp.asarray(w), jl.uniform_levels(bits), bucket)
        qt = tl.quantize_levels(torch.from_numpy(w), tl.uniform_levels(bits), bucket)
        assert np.array_equal(np.asarray(qj.codes), qt.codes.numpy())


# ---- the claims of tests/test_levels.py, through the port ----


def _skewed(n=8192):
    """Heavy-tailed values where a uniform grid wastes levels."""
    g = prng.normal(prng.PRNGKey(0), (n,))
    return torch.sign(g) * torch.abs(g) ** 3


def test_sequential_rule_matches_paper_update():
    out = tl.learn_levels_sequential(torch.tensor([0.8]), torch.tensor([0.0, 1.0]), lr=0.1)
    np.testing.assert_allclose(out.numpy(), [0.0, 1.0 - 0.1 * (1.0 - 0.8)], atol=1e-7)


def test_minibatch_matches_sequential_single_level():
    levels, vals = torch.tensor([0.0, 10.0]), torch.full((16,), 0.5)
    seq = tl.learn_levels_sequential(vals, levels, lr=0.05)
    mb = tl.learn_levels_minibatch(vals, levels, lr=0.05, batch_size=16)
    np.testing.assert_allclose(seq.numpy(), mb.numpy(), rtol=1e-5)


def _errors(x, bits, **cfg):
    levels = tl.learn_levels_for_tensor(x, tl.LevelsConfig(bits=bits, bucket_size=1024, **cfg))
    uni = tl.uniform_levels(bits)
    el = float(tl.compression_error(x, tl.dequantize_levels(tl.quantize_levels(x, levels), levels)))
    eu = float(tl.compression_error(x, tl.dequantize_levels(tl.quantize_levels(x, uni), uni)))
    return el, eu


def test_learned_levels_reduce_error_low_bits():
    el, eu = _errors(_skewed(), 4, epochs=2)
    assert el < eu, (el, eu)


def test_learned_no_worse_at_high_bits():
    el, eu = _errors(_skewed(), 8)
    assert el < eu * 1.25


def test_levels_roundtrip_and_wire_format():
    x = prng.normal(prng.PRNGKey(0), (3000,))
    levels = tl.uniform_levels(4)
    y = tl.dequantize_levels(tl.quantize_levels(x, levels, bucket_size=512), levels)
    assert y.shape == x.shape
    cfg = QuantConfig(bits=4, bucket_size=512, mode="nearest")
    np.testing.assert_allclose(y.numpy(), quantize_dequantize(x, cfg).numpy(), atol=1e-6)


def test_stochastic_levels_unbiased_within_hull():
    x = torch.linspace(0.05, 0.95, 64)
    levels = torch.sort(prng.uniform(prng.PRNGKey(0), (8,))).values
    levels = torch.cat([torch.zeros(1), levels[1:-1], torch.ones(1)])
    ys = torch.stack([tl.dequantize_levels(tl.quantize_levels(x, levels, bucket_size=64, key=k),
                                           levels)
                      for k in prng.split(prng.PRNGKey(0), 3000)])
    np.testing.assert_allclose(ys.mean(0).numpy(), x.numpy(), atol=2e-2)
