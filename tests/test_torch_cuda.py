"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they skip on a machine without a CUDA device (decided in
the fixture, never at import).  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["nearest", "stochastic", "shift"])
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("bucket", [1024, 256, 100])
def test_quantize_pack_and_dequantize_byte_equal(cuda, bits, mode, bucket):
    nb = 37
    x = torch.randn((nb, bucket), generator=torch.Generator().manual_seed(bits)).to(cuda)
    key = prng.PRNGKey(bits)
    if mode == "stochastic":
        rand = prng.uniform(key, (nb, bucket), cuda)
    elif mode == "shift":
        rand = prng.uniform(key, (nb, 1), cuda, -0.5, 0.5)
    else:
        rand = torch.zeros((nb, 1), device=cuda)
    levels = (1 << bits) - 1
    before = ops.LAUNCHES["quantize_pack"]
    got = ops.quantize_pack(x, rand, levels, bits, mode)
    assert ops.LAUNCHES["quantize_pack"] == before + 1
    for g, w in zip(got, ref.quantize_pack_ref(x, rand, levels, bits, mode)):
        assert torch.equal(g, w)
    for dt in (torch.float32, torch.bfloat16):
        d = ops.unpack_dequantize(*got, bits, dt)
        w = ref.unpack_dequantize_ref(*got, bits, dt)
        assert torch.equal(d.view(torch.uint8), w.view(torch.uint8))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n,n_seg", [(4, 2048, 8192, 8), (4, 8192, 2048, 2),
                                         (33, 100, 77, 1), (9, 3000, 2048, 2)])
def test_rowquant_matmul_close(cuda, m, k, n, n_seg, dtype, tol):
    g = torch.Generator().manual_seed(m)
    codes = torch.randint(0, 256, (k, n), generator=g, dtype=torch.uint8).to(cuda)
    scale = (torch.rand((k, n_seg), generator=g) * 1e-3).to(cuda)
    zero = (torch.randn((k, n_seg), generator=g) * 0.05).to(cuda)
    x = torch.randn((m, k), generator=g).to(cuda, dtype)
    y = ops.rowquant_matmul(x, codes, scale, zero).float()
    yr = ref.rowquant_matmul_ref(x, codes, scale, zero).float()
    assert (y - yr).abs().max().item() <= tol * yr.abs().max().item()


def test_wrapper_checks_shapes_on_the_card(cuda):
    with pytest.raises(ValueError, match="rand"):
        ops.quantize_pack(torch.zeros((2, 8), device=cuda),
                          torch.zeros((2, 3), device=cuda), 255, 8, "shift")


@pytest.mark.parametrize("m,k,n", [(4, 2048, 8192), (4, 8192, 2048), (1, 7, 5),
                                   (64, 100000, 3)])
def test_rowquant_split_covers_k(cuda, m, k, n):
    """Every split-K chunk the kernel source picks is non-empty and at most
    1024 rows (its shared-memory tile)."""
    split = ops.rowquant_split(m, k, n)
    chunk = -(-k // split)
    assert chunk <= 1024 and (split - 1) * chunk < k


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("levels", [3, 15, 63, 255])
@pytest.mark.parametrize("nb,bucket", [(37, 1024), (5, 256), (3, 100)])
def test_quantize_dequantize_buckets_byte_equal(cuda, levels, stochastic, nb, bucket):
    """K4/K5: the unpacked forms, one code per byte, against their plain
    versions (codes, scale, zero and the decode byte-equal)."""
    x = torch.randn((nb, bucket), generator=torch.Generator().manual_seed(levels)).to(cuda)
    rand = prng.uniform(prng.PRNGKey(levels), (nb, bucket), cuda)
    before = dict(ops.LAUNCHES)
    got = ops.quantize_buckets(x, rand, levels, stochastic)
    for g, w in zip(got, ref.quantize_buckets_ref(x, rand, levels, stochastic)):
        assert torch.equal(g, w)
    assert int(got[0].max()) <= levels
    for dt in (torch.float32, torch.bfloat16):
        d = ops.dequantize_buckets(*got, dt)
        w = ref.dequantize_buckets_ref(*got, dt)
        assert torch.equal(d.view(torch.uint8), w.view(torch.uint8))
    assert ops.LAUNCHES["quantize_buckets"] == before["quantize_buckets"] + 1
    assert ops.LAUNCHES["dequantize_buckets"] == before["dequantize_buckets"] + 2


@pytest.mark.parametrize("nb", [1, 33, 4096])
def test_gradient_modes_byte_equal(cuda, nb):
    """The gradient path's modes: K1 stochastic with full-size (nb, 1024)
    thresholds (Def. 12) and K2 decoding to f32 (the dequant-sum)."""
    x = (torch.randn((nb, 1024), generator=torch.Generator().manual_seed(nb)) * 1e-3).to(cuda)
    rand = prng.uniform(prng.PRNGKey(nb), (nb, 1024), cuda)
    got = ops.quantize_pack(x, rand, 255, 8, "stochastic")
    for g, w in zip(got, ref.quantize_pack_ref(x, rand, 255, 8, "stochastic")):
        assert torch.equal(g, w)
    d = ops.unpack_dequantize(*got, 8, torch.float32)
    assert torch.equal(d, ref.unpack_dequantize_ref(*got, 8, torch.float32))


def test_buckets_wrappers_check_inputs_on_the_card(cuda):
    with pytest.raises(ValueError, match="rand"):
        ops.quantize_buckets(torch.zeros((2, 8), device=cuda), torch.zeros((2, 1), device=cuda))
    with pytest.raises(ValueError, match="levels"):
        ops.quantize_buckets(torch.zeros((2, 8), device=cuda), torch.zeros((2, 8), device=cuda),
                             256)
