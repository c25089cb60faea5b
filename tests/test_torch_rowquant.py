"""The port's rowquant matmul (plain version on the CPU) against the JAX
package's reference and its Pallas kernel in interpret mode.  Tolerances
follow tests/test_kernels.py:61-96: 2e-4 for f32 x, 2e-2 for bf16 x."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _case(m, k, n, n_seg, dtype, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, size=(k, n), dtype=np.uint8)
    scale = (rng.random((k, n_seg), dtype=np.float32) * 1e-3 + 1e-5).astype(np.float32)
    zero = (rng.standard_normal((k, n_seg)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return (jx, jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(zero)), \
        (tx, torch.from_numpy(codes), torch.from_numpy(scale), torch.from_numpy(zero))


def _close(got, want, dtype, k):
    tol = TOL[dtype]
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,n_seg", [(4, 256, 2048, 1), (4, 256, 2048, 2),
                                         (3, 512, 1024, 1), (33, 100, 77, 1),
                                         (8, 64, 4096, 4)])
def test_rowquant_ref_matches_jax_ref(m, k, n, n_seg, dtype):
    """n_seg in {1, N/1024} (and an intermediate) against the reference."""
    (jx, jc, js, jz), (tx, tc, ts, tz) = _case(m, k, n, n_seg, dtype)
    y = ops.rowquant_matmul(tx, tc, ts, tz)
    assert y.dtype == tx.dtype and y.shape == (m, n)
    _close(y, jref.rowquant_matmul_ref(jx, jc, js, jz), dtype, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_seg", [1, 2])
def test_rowquant_ref_matches_pallas_interpret(n_seg, dtype):
    (jx, jc, js, jz), (tx, tc, ts, tz) = _case(8, 128, 2048, n_seg, dtype, seed=1)
    y_pallas = jops.rowquant_matmul(jx, jc, js, jz, block_m=8, block_n=256,
                                    block_k=128, interpret=True)
    _close(ops.rowquant_matmul(tx, tc, ts, tz), y_pallas, dtype, 128)


def test_rowquant_equals_dense_dequant_then_matmul():
    """The plain rowquant's weight is exactly K2's dequantized values."""
    (_, _, _, _), (tx, tc, ts, tz) = _case(4, 64, 2048, 2, "float32", seed=2)
    w = ref.unpack_dequantize_ref(tc.reshape(-1, 1024), ts.reshape(-1, 1),
                                  tz.reshape(-1, 1), 8).reshape(64, 2048)
    torch.testing.assert_close(ops.rowquant_matmul(tx, tc, ts, tz), tx @ w,
                               rtol=1e-6, atol=1e-6)


def test_rowquant_rejects_bad_segments():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        ops.rowquant_matmul(x, torch.zeros(4, 10, dtype=torch.uint8),
                            torch.zeros(4, 3), torch.zeros(4, 3))
