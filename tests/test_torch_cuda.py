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


def _wire(p, meta, seed):
    """P rows of a mixed wire layout, encoded on the CPU (plain versions):
    bits 2/3/4/8, buckets 1024/100/256, odd nb (the next segment 8 bytes off
    16-byte alignment), odd-length fp payloads in f32 and bf16."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.quant import QuantConfig
    layout = coll.WireLayout((
        coll.WireSegment(2048, None, "float32"),
        coll.WireSegment(5 * 1024 - 3, QuantConfig(bits=8, meta_dtype=meta)),
        coll.WireSegment(77, None, "bfloat16"),
        coll.WireSegment(3 * 1024, QuantConfig(bits=4, meta_dtype=meta)),
        coll.WireSegment(7 * 1024 + 1, QuantConfig(bits=2, meta_dtype=meta)),
        coll.WireSegment(2000, QuantConfig(bits=3, bucket_size=100, meta_dtype=meta)),
        coll.WireSegment(3000, QuantConfig(bits=8, bucket_size=256, meta_dtype=meta)),
        coll.WireSegment(33 * 1024, QuantConfig(bits=8, meta_dtype=meta))))
    g = torch.Generator().manual_seed(seed)
    rows = []
    for r in range(p):
        xs = [torch.randn(s.n, generator=g) * 0.02 for s in layout.segments]
        keys = [prng.fold_in(prng.PRNGKey(seed), 10 * r + i) if s.cfg is not None else None
                for i, s in enumerate(layout.segments)]
        rows.append(coll.encode_wire(xs, layout, keys))
    return layout, torch.cat(rows)


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("meta", ["float32", "bfloat16"])
def test_unpack_dequantize_wire_byte_equal(cuda, meta, p):
    """K2 over a wire buffer's table (P rows x 6 quantized segments, aligned
    and not) in one launch, byte-equal to its plain version, per-segment
    out dtypes bf16 and f32."""
    from repro_torch.core import collectives as coll
    layout, buf = _wire(p, meta, seed=p)
    for out in ([torch.bfloat16] * 8, [torch.float32] * 8, [torch.bfloat16, torch.float32] * 4):
        table, dts = coll.wire_table(layout, p, out)
        gbuf = buf.to(cuda)
        assert any((gbuf.data_ptr() + t.codes) % 16 for t in table)
        before = ops.LAUNCHES["unpack_dequantize"]
        got = ops.unpack_dequantize_wire(gbuf, table, dts)
        assert ops.LAUNCHES["unpack_dequantize"] == before + 1
        for t, g, w in zip(table, got, ref.unpack_dequantize_wire_ref(buf, table, dts),
                           strict=True):
            assert g.dtype == w.dtype and g.shape == (t.nb, t.bucket)
            assert torch.equal(g.cpu().view(torch.uint8), w.view(torch.uint8)), t


def _random_segment(g, shift, nb, bucket, bits, meta):
    """One wire segment of random codes at byte `shift` of a buffer (5 bytes
    to spare after it), with scale/zero of magnitude 0.1."""
    from repro_torch.core.quant import QuantConfig, wire_codes, wire_segment_bytes
    cfg = QuantConfig(bits=bits, bucket_size=bucket,
                      meta_dtype="bfloat16" if meta == torch.bfloat16 else "float32")
    seg = wire_codes(shift, nb * bucket, cfg)
    buf = torch.randint(0, 256, (shift + wire_segment_bytes(nb * bucket, cfg) + 5,),
                        generator=g, dtype=torch.uint8)
    buf[seg.scale:seg.zero + nb * meta.itemsize] = (torch.rand(2 * nb, generator=g) * 0.1).to(
        meta).view(torch.uint8)
    return seg, buf


@pytest.mark.parametrize("shift", range(16))
def test_unpack_dequantize_wire_any_offset(cuda, shift):
    """One segment at every byte offset mod 16 of the buffer: codes and
    scale/zero at every alignment; random codes (3-bit segments keep the
    high bits of each byte, as the reference does)."""
    g = torch.Generator().manual_seed(shift)
    for bits, bucket, meta in ((8, 1024, torch.float32), (4, 256, torch.bfloat16),
                               (3, 64, torch.float32), (8, 4096, torch.bfloat16)):
        seg, buf = _random_segment(g, shift, 9, bucket, bits, meta)
        for dt in (torch.float32, torch.bfloat16):
            got = ops.unpack_dequantize_wire(buf.to(cuda), [seg], [dt])[0]
            want = ref.unpack_dequantize_wire_ref(buf, [seg], [dt])[0]
            assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8)), (bits, dt)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("bucket", [2048, 4096, 1040 * 16, 8192 + 128])
def test_unpack_dequantize_large_buckets(cuda, bits, bucket):
    """Buckets whose codes pass 1 KB take the 16-byte path in 1 KB chunks
    (the last one shorter where the bucket's codes are not a whole number
    of KB), through both entry points, byte-equal."""
    g = torch.Generator().manual_seed(bucket + bits)
    seg, buf = _random_segment(g, 0, 7, bucket, bits, torch.float32)
    codes = buf[:seg.scale].view(7, -1).to(cuda)
    scale = (torch.rand((7, 1), generator=g) * 0.1).to(cuda)
    zero = (torch.randn((7, 1), generator=g) * 0.1).to(cuda)
    for dt in (torch.float32, torch.bfloat16):
        got = ops.unpack_dequantize_wire(buf.to(cuda), [seg], [dt])[0]
        want = ref.unpack_dequantize_wire_ref(buf, [seg], [dt])[0]
        assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8)), dt
        got = ops.unpack_dequantize(codes, scale, zero, bits, dt)
        want = ref.unpack_dequantize_ref(codes, scale, zero, bits, dt)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), dt


def test_unpack_dequantize_wire_table_limits(cuda):
    """A table of up to 64 segments is one launch; 130 segments take three
    (64 + 64 + 2), byte-equal; empty segments take no entry and an
    all-empty table launches nothing."""
    from repro_torch.core.quant import QuantConfig, wire_codes, wire_segment_bytes
    cfg = QuantConfig(bits=8)
    seg_bytes = wire_segment_bytes(2048, cfg)
    g = torch.Generator().manual_seed(130)
    buf = torch.randint(0, 256, (130 * seg_bytes,), generator=g, dtype=torch.uint8)
    table = [wire_codes(i * seg_bytes, 2048, cfg) for i in range(130)]
    for t in table:
        buf[t.scale:t.zero + 8] = (torch.rand(4, generator=g) * 0.1).view(torch.uint8)
    gbuf = buf.to(cuda)
    empty = wire_codes(0, 0, cfg)
    for n, launches in ((64, 1), (130, 3)):
        dts = [torch.float32, torch.bfloat16] * (n // 2) + [torch.float32]
        before = ops.LAUNCHES["unpack_dequantize"]
        outs = ops.unpack_dequantize_wire(gbuf, table[:n] + [empty], dts)
        assert ops.LAUNCHES["unpack_dequantize"] == before + launches
        assert outs[-1].shape == (0, 1024)
        for o, w in zip(outs, ref.unpack_dequantize_wire_ref(buf, table[:n] + [empty], dts),
                        strict=True):
            assert torch.equal(o.cpu().view(torch.uint8), w.view(torch.uint8))
    before = ops.LAUNCHES["unpack_dequantize"]
    ops.unpack_dequantize_wire(gbuf, [empty], [torch.bfloat16])
    assert ops.LAUNCHES["unpack_dequantize"] == before


def test_unpack_dequantize_wire_checks_inputs_on_the_card(cuda):
    from repro_torch.core.quant import QuantConfig, wire_codes
    buf = torch.zeros(4096, dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError, match="f32 or bf16"):
        ops.unpack_dequantize_wire(buf, [wire_codes(0, 1024, QuantConfig())], [torch.float16])
    with pytest.raises(ValueError, match="past"):
        ops.unpack_dequantize_wire(buf, [wire_codes(3500, 1024, QuantConfig())],
                                   [torch.float32])
    with pytest.raises(ValueError, match="unsupported"):
        ops.unpack_dequantize_wire(buf, [ops.WireCodes(0, 1000, 1004, 1, 1023, 4)],
                                   [torch.float32])
