"""The port's unpacked quantizer entry points (K4 ``quantize_buckets``, K5
``dequantize_buckets``) against the JAX package's, over the sweep of
``tests/test_kernels.py``.  The JAX side runs its Pallas kernels in
interpret mode (``repro.kernels.ops`` off-TPU); the port takes its plain
versions on the CPU.  Inputs are made with numpy and handed to both.

Codes, scale, zero and the decoded values are held byte-equal: min and max
are exact, and both sides divide, round half-even and clamp in f32 in the
same order (the decode is one fused multiply-add on both).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops


def _inputs(nb, bucket, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((nb, bucket)) * 2.0).astype(np.float32)
    rand = rng.random((nb, bucket), dtype=np.float32)
    return x, rand


def _both(x, rand, levels, stochastic):
    want = jops.quantize_buckets(x, rand, levels, stochastic)
    got = ops.quantize_buckets(torch.from_numpy(x), torch.from_numpy(rand), levels, stochastic)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_bytes_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("nb", [1, 7, 8, 17])
@pytest.mark.parametrize("bucket", [256, 1024])
@pytest.mark.parametrize("stochastic", [True, False])
def test_quantize_buckets_byte_equal(nb, bucket, stochastic):
    x, rand = _inputs(nb, bucket, nb * bucket)
    want, got = _both(x, rand, 255, stochastic)
    for w, g in zip(want, got):
        _assert_bytes_equal(w, g)


@pytest.mark.parametrize("levels", [3, 15, 63, 255])
@pytest.mark.parametrize("stochastic", [True, False])
def test_quantize_buckets_levels_sweep(levels, stochastic):
    x, rand = _inputs(4, 512, levels)
    want, got = _both(x, rand, levels, stochastic)
    for w, g in zip(want, got):
        _assert_bytes_equal(w, g)
    assert int(got[0].max()) <= levels


@pytest.mark.parametrize("nb", [1, 5, 16])
def test_dequantize_buckets_byte_equal(nb):
    rng = np.random.default_rng(nb)
    codes = rng.integers(0, 256, (nb, 512), dtype=np.uint8)
    scale = (rng.random((nb, 1), dtype=np.float32) + 0.01).astype(np.float32)
    zero = rng.standard_normal((nb, 1)).astype(np.float32)
    want = np.asarray(jops.dequantize_buckets(codes, scale, zero))
    got = ops.dequantize_buckets(*(torch.from_numpy(a) for a in (codes, scale, zero)))
    _assert_bytes_equal(want, got.numpy())


def test_quantize_dequantize_roundtrip_error():
    x, rand = _inputs(8, 1024, 5)
    c, s, z = ops.quantize_buckets(torch.from_numpy(x), torch.from_numpy(rand), 255, False)
    y = ops.dequantize_buckets(c, s, z)
    assert float((y - torch.from_numpy(x)).abs().max()) <= 0.5 * float(s.max()) + 1e-6
    assert ops.dequantize_buckets(c, s, z, torch.bfloat16).dtype == torch.bfloat16
