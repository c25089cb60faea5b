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


@pytest.mark.parametrize("rand_bits", [16, 32])
@pytest.mark.parametrize("mode", ["nearest", "stochastic", "shift"])
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("bucket", [1024, 256, 100])
def test_quantize_pack_and_dequantize_byte_equal(cuda, bits, mode, bucket, rand_bits):
    """K1 drawing from the key against its plain version (threefry twin +
    quantize_pack_ref), then K2 on its codes."""
    nb = 37
    x = torch.randn((nb, bucket), generator=torch.Generator().manual_seed(bits)).to(cuda)
    key = prng.fold_in(prng.PRNGKey(bits), rand_bits)
    levels = (1 << bits) - 1
    before = ops.LAUNCHES["quantize_pack"]
    got = ops.quantize_pack(x, key, levels, bits, mode, rand_bits)
    assert ops.LAUNCHES["quantize_pack"] == before + 1
    for g, w in zip(got, ref.quantize_pack_key_ref(x, key, levels, bits, mode, rand_bits)):
        assert torch.equal(g, w)
    for dt in (torch.float32, torch.bfloat16):
        d = ops.unpack_dequantize(*got, bits, dt)
        w = ref.unpack_dequantize_ref(*got, bits, dt)
        assert torch.equal(d.view(torch.uint8), w.view(torch.uint8))


def _rowquant_close(cuda, m, k, n, n_seg, dtype, tol, offset=0):
    """K3 within tol * max(max |y|, 1) of its plain version; `offset` moves
    the codes' first byte off the 16-byte alignment of the allocation."""
    g = torch.Generator().manual_seed(m * 7 + k)
    flat = torch.randint(0, 256, (k * n + offset,), generator=g, dtype=torch.uint8).to(cuda)
    codes = flat[offset:].view(k, n)
    scale = (torch.rand((k, n_seg), generator=g) * 1e-3).to(cuda)
    zero = (torch.randn((k, n_seg), generator=g) * 0.05).to(cuda)
    x = torch.randn((m, k), generator=g).to(cuda, dtype)
    before = ops.LAUNCHES["rowquant_matmul"]
    y = ops.rowquant_matmul(x, codes, scale, zero).float()
    assert ops.LAUNCHES["rowquant_matmul"] == before + 1
    yr = ref.rowquant_matmul_ref(x, codes, scale, zero).float()
    assert y.shape == (m, n) and bool(torch.isfinite(y).all())
    assert (y - yr).abs().max().item() <= tol * max(yr.abs().max().item(), 1.0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n,n_seg", [(4, 2048, 8192, 8), (4, 8192, 2048, 2),
                                         (1, 2048, 8192, 8), (8, 8192, 2048, 2),
                                         (33, 100, 77, 1), (9, 3000, 2048, 2)])
def test_rowquant_matmul_close(cuda, m, k, n, n_seg, dtype, tol):
    _rowquant_close(cuda, m, k, n, n_seg, dtype, tol)


def test_wrapper_checks_shapes_on_the_card(cuda):
    with pytest.raises(ValueError, match="rand"):
        ops.quantize_pack(torch.zeros((2, 8), device=cuda), (0, 1), 255, 8, "shift",
                          rand_bits=12)
    with pytest.raises(ValueError, match="key"):
        ops.quantize_pack(torch.zeros((2, 8), device=cuda), None, 255, 8, "stochastic")


@pytest.mark.parametrize("m,k,n,n_seg,offset", [
    (4, 1000, 8208, 3, 0),     # ragged last column tile, K not a multiple of the cluster
    (4, 7, 48, 3, 0),          # fewer K-rows than cluster blocks could take
    (5, 33, 16, 1, 0),         # one 16-column tile
    (4, 3000, 4096, 256, 0),   # 16-column segments: 16 of them per tile in the table
    (9, 12000, 64, 4, 0),      # two M-tiles, the longest K-range that fits
    (4, 100000, 48, 1, 0),     # K-range too long for shared memory: generic kernel
    (4, 2048, 8192, 8, 1),     # codes off 16-byte alignment: generic kernel
    (4, 50, 40, 5, 0),         # N not a multiple of 16: generic kernel
])
def test_rowquant_tiling_edges(cuda, m, k, n, n_seg, offset):
    """The edges of K3's tiling (dequant_matmul.cu: tiling_for), f32 x."""
    _rowquant_close(cuda, m, k, n, n_seg, torch.float32, 2e-4, offset)


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
    """The gradient path's modes: K1 stochastic with one drawn threshold per
    value (Def. 12) and K2 decoding to f32 (the dequant-sum)."""
    x = (torch.randn((nb, 1024), generator=torch.Generator().manual_seed(nb)) * 1e-3).to(cuda)
    key = prng.PRNGKey(nb)
    got = ops.quantize_pack(x, key, 255, 8, "stochastic")
    for g, w in zip(got, ref.quantize_pack_key_ref(x, key, 255, 8, "stochastic")):
        assert torch.equal(g, w)
    d = ops.unpack_dequantize(*got, 8, torch.float32)
    assert torch.equal(d, ref.unpack_dequantize_ref(*got, 8, torch.float32))


def test_buckets_wrappers_check_inputs_on_the_card(cuda):
    with pytest.raises(ValueError, match="rand"):
        ops.quantize_buckets(torch.zeros((2, 8), device=cuda), torch.zeros((2, 1), device=cuda))
    with pytest.raises(ValueError, match="levels"):
        ops.quantize_buckets(torch.zeros((2, 8), device=cuda), torch.zeros((2, 8), device=cuda),
                             256)
