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


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_unpack_dequantize_wire_one_buffer_per_segment(cuda, dt):
    """The speculative draft's layer decode: segments that each lie in their
    own buffer (at assorted offsets, widths and buckets) decoded in one
    launch, byte-equal to the plain version."""
    g = torch.Generator().manual_seed(7)
    segs, bufs = zip(*(_random_segment(g, shift, nb, bucket, bits, meta)
                       for shift, nb, bucket, bits, meta in (
                           (0, 64, 256, 4, torch.float32), (3, 9, 256, 4, torch.float32),
                           (8, 5, 1024, 8, torch.bfloat16), (1, 7, 64, 3, torch.float32))))
    before = ops.LAUNCHES["unpack_dequantize"]
    got = ops.unpack_dequantize_wire([b.to(cuda) for b in bufs], segs, [dt] * len(segs))
    assert ops.LAUNCHES["unpack_dequantize"] == before + 1
    for g_, w in zip(got, ref.unpack_dequantize_wire_ref(list(bufs), segs, [dt] * len(segs)),
                     strict=True):
        assert torch.equal(g_.cpu().view(torch.uint8), w.view(torch.uint8))


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


@pytest.mark.parametrize("rows,n", [(1, 1), (3, 255), (4, 50304), (7, 100000)])
def test_random_bits_byte_equal(cuda, rows, n):
    """The sampler's draw against its plain version (prng.bits per row)."""
    keys = prng.as_i32(prng.fold_in_rows(torch.tensor([prng.PRNGKey(r) for r in range(rows)]),
                                         torch.arange(rows) * 7 + 3))
    before = ops.LAUNCHES["random_bits"]
    got = ops.random_bits(keys.to(cuda), n)
    assert ops.LAUNCHES["random_bits"] == before + 1
    assert got.dtype == torch.int32 and got.shape == (rows, n)
    assert torch.equal(got.cpu(), ref.random_bits_ref(keys, n))


def test_random_bits_checks_inputs_on_the_card(cuda):
    with pytest.raises(TypeError):
        ops.random_bits(torch.zeros((2, 2), dtype=torch.int64, device=cuda), 8)
    with pytest.raises(ValueError):
        ops.random_bits(torch.zeros((2, 3), dtype=torch.int32, device=cuda), 8)
    with pytest.raises(ValueError):
        ops.random_bits(torch.zeros((2, 2), dtype=torch.int32, device=cuda), 0)


def test_sampler_on_the_card_matches_the_cpu(cuda):
    """sample_vocab_parallel on the card (random_bits + torch ops) against
    the same call on the CPU (plain draw): greedy rows bit for bit, sampled
    rows wherever their top two perturbed logits lie apart by more than the
    noise's tolerance (the CPU test's 2e-5)."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((16, 50304), generator=g) * 3
    temp = torch.tensor([0.0, 0.8, 1.3, 0.5] * 4)
    top_k = torch.tensor([0, 40, 1, 0, 5, 0, 40, 0] * 2)
    keys = torch.tensor([prng.PRNGKey(i) for i in range(16)])
    on_card = L.sample_vocab_parallel(logits.to(cuda), 50304, temp, top_k, keys).cpu()
    on_cpu = L.sample_vocab_parallel(logits, 50304, temp, top_k, keys)
    greedy = (temp <= 0) | (top_k == 1)
    assert torch.equal(on_card[greedy], on_cpu[greedy])
    noise = prng.gumbel_from_bits(ref.random_bits_ref(prng.as_i32(keys), 50304))
    z = logits / temp.clamp(min=1e-6)[:, None] + noise
    top2 = torch.sort(z, dim=-1).values[:, -2:]
    clear = ~greedy & (top_k == 0) & (top2[:, 1] - top2[:, 0] > 2e-5)
    assert clear.any()
    assert torch.equal(on_card[clear], on_cpu[clear])


@pytest.mark.parametrize("no_drop", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_backward_on_the_card(cuda, dtype, no_drop):
    """The MoE layer's forward and backward (capacity drops included) on the
    card: two runs bit-equal (no atomics in the dispatch, the combine or
    their transposes); in f32, outputs and gradients within 1e-5 of the
    largest of the CPU's."""
    from repro_torch.models import moe
    t, e, k, d, ff = 96, 8, 2, 64, 32
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn((t, d), generator=g)
    w0 = {"router": torch.randn((d, e), generator=g) * 0.3,
          "w_gate": torch.randn((e, d, ff), generator=g) * 0.1,
          "w_up": torch.randn((e, d, ff), generator=g) * 0.1,
          "w_down": torch.randn((e, ff, d), generator=g) * 0.1}
    w0["router"][0] = torch.linspace(1.5, -1.5, e)  # uneven load: drops
    x0[:, 0] = 1.0
    gout = torch.randn((t, d), generator=g)
    cfg = moe.MoEConfig(n_experts=e, top_k=k, d_model=d, d_ff=ff, tp=1)

    def run(dev, dt):
        x = x0.to(dev, dt).requires_grad_()
        w = {n: v.to(dev, torch.float32 if n == "router" else dt).requires_grad_()
             for n, v in w0.items()}
        out, aux = moe.moe_layer(x, w, cfg, no_drop=no_drop)
        torch.autograd.backward([out, aux], [gout.to(dev, dt), torch.tensor(0.5, device=dev)])
        return [out.detach(), aux.detach(), x.grad] + [w[n].grad for n in sorted(w)]

    a, b = run(cuda, dtype), run(cuda, dtype)
    for u, v in zip(a, b):
        assert torch.equal(u.reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8))
    if dtype == torch.float32:
        for u, v in zip(a, run("cpu", dtype)):
            assert (u.cpu() - v).abs().max().item() <= 1e-5 * max(v.abs().max().item(), 1.0)


def _mamba_case(seed, dtype, device):
    """A Mamba2 mixer of d_model 64 (d_inner 128, 8 heads of 16, N 16, conv
    4, chunk 16) with random weights in `dtype` and a 40-token input (pads
    to whole chunks), built on the CPU and moved to `device`."""
    from repro_torch.models.mamba import MambaConfig
    g = torch.Generator().manual_seed(seed)
    cfg = MambaConfig(d_model=64, d_state=16, head_dim=16, expand=2, conv_k=4, chunk=16, tp=1)
    d, din, h, n = 64, 128, 8, 16

    def nrm(*shape, s):
        return (torch.randn(shape, generator=g) * s).to(device, dtype)

    w = {"w_z": nrm(d, din, s=d ** -0.5), "w_x": nrm(d, din, s=d ** -0.5),
         "w_bc": nrm(d, 2 * n, s=d ** -0.5), "w_dt": nrm(d, h, s=d ** -0.5),
         "conv_x": nrm(din, 4, s=0.3), "conv_bc": nrm(2 * n, 4, s=0.3),
         "a_log": nrm(h, s=0.1) + 0.5, "dt_bias": nrm(h, s=0.3) - 1.0,
         "d_skip": nrm(h, s=0.1) + 1.0, "norm": nrm(din, s=0.1) + 1.0,
         "w_out": nrm(din, d, s=din ** -0.5)}
    x = torch.randn((2, 40, d), generator=g).to(device, dtype)
    return cfg, w, x


# card vs CPU: cuBLAS/cuDNN sum in other orders than the CPU (f32), and a
# 1-ulp difference upstream can flip a bf16 rounding (one ulp of ~4 is 3e-2)
MAMBA_CARD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_block_and_decode_on_the_card(cuda, dtype):
    """``mamba2_block(return_state=True)`` and three ``mamba2_decode`` steps
    from its state, on the card against the CPU, within MAMBA_CARD_ATOL."""
    from repro_torch.models.mamba import mamba2_block, mamba2_decode
    cfg, w_c, x_c = _mamba_case(0, dtype, "cpu")
    w_g, x_g = {k: v.to(cuda) for k, v in w_c.items()}, x_c.to(cuda)
    atol = MAMBA_CARD_ATOL[dtype]
    outs = []
    for w, x in ((w_g, x_g), (w_c, x_c)):
        out, (cx, cbc, h) = mamba2_block(x, w, cfg, return_state=True)
        conv = torch.cat([cx, cbc.to(cx.dtype)], -1).float()
        steps = []
        for t in range(3):
            y, conv, h = mamba2_decode(x[:, t], w, cfg, conv, h)
            steps.append(y)
        outs.append([out, conv, h, *steps])
    for i, (g, c) in enumerate(zip(*outs)):
        assert g.device.type == "cuda" and bool(torch.isfinite(g).all()), i
        scale = max(1.0, c.float().abs().max().item())
        assert (g.cpu().float() - c.float()).abs().max().item() <= atol * scale, i


def test_zamba2_smoke_decode_step_bit_stable(cuda):
    """One decode step of zamba2's smoke config (Mamba2 layers, the shared
    block, a tail layer) on the card, twice from the same prefill cache:
    tokens and every cache leaf bit-equal."""
    from repro_torch.core.qsdp import QSDPConfig
    from repro_torch.serve import build_serve_setup
    setup = build_serve_setup("zamba2-7b", smoke=True, qsdp=QSDPConfig(), batch=2,
                              prompt_len=16, gen=4, device="cuda")
    tokens = torch.randint(0, 1024, (2, 16), generator=torch.Generator().manual_seed(1))
    key = prng.PRNGKey(3)
    nxt, cache = setup.engine.prefill_step()(setup.params, {"tokens": tokens.to(cuda)}, key)
    pos = torch.full((2,), 16, dtype=torch.int64)
    runs = []
    for _ in range(2):
        c = {k: v.clone() for k, v in cache.items()}
        out, c = setup.engine.decode_step()(setup.params, c, nxt, pos, key)
        runs.append((out.cpu(), {k: v.cpu() for k, v in c.items()}))
    (t1, c1), (t2, c2) = runs
    assert torch.equal(t1, t2)
    assert set(c1) == {"conv", "ssm", "shared_k", "shared_v"}
    for k in c1:
        assert torch.equal(c1[k].view(torch.uint8), c2[k].view(torch.uint8)), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_block_backward_on_the_card(cuda, dtype):
    """The Mamba2 mixer's backward (the SSD scan's chunk loop, the causal
    conv's shifted-product backward, softplus's own) on the card: two runs
    bit-equal (a train step must repeat), and against the CPU's gradients
    within MAMBA_CARD_ATOL of the largest of each."""
    from repro_torch.models.mamba import mamba2_block
    cfg, w_c, x_c = _mamba_case(1, dtype, "cpu")
    gout = torch.randn(x_c.shape, generator=torch.Generator().manual_seed(2)).to(dtype)

    def run(dev):
        x = x_c.to(dev).requires_grad_()
        w = {k: v.to(dev).requires_grad_() for k, v in w_c.items()}
        mamba2_block(x, w, cfg).backward(gout.to(dev))
        return [x.grad] + [w[k].grad for k in sorted(w)]

    a, b, c = run(cuda), run(cuda), run("cpu")
    atol = MAMBA_CARD_ATOL[dtype]
    for i, (u, v, w) in enumerate(zip(a, b, c)):
        assert torch.equal(u.reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8)), i
        assert bool(torch.isfinite(u).all()), i
        scale = max(1.0, w.float().abs().max().item())
        assert (u.cpu().float() - w.float()).abs().max().item() <= atol * scale, i


def test_zamba2_smoke_train_step_on_the_card(cuda):
    """One f32 train step of zamba2's smoke config (Mamba2 layers, the shared
    block, a tail layer) on the card, twice from the same state: loss, grad
    norm and every updated parameter bit-equal; against the CPU's step within
    the CPU tests' step tolerances (1e-5 / 1e-4)."""
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, make_adamw
    from repro_torch.train.checkpoint import state_from_flat, state_to_flat
    from repro_torch.train.step import build_train_step, init_train_state
    model = Model(configs.get_smoke("zamba2-7b"), MeshSpec(("data", "model"), (1, 1)),
                  QSDPConfig(compute_dtype="float32"))
    opt = make_adamw(AdamWConfig(lr=1e-3))
    flat = state_to_flat(init_train_state(model, opt, 0, "cpu"))
    tokens = torch.randint(0, 1024, (2, 2, 32), generator=torch.Generator().manual_seed(4))
    batch = {"tokens": tokens[0], "labels": tokens[1]}

    def run(dev):
        step = build_train_step(model, opt, n_micro=2, device=dev)
        st, m = step(state_from_flat(*flat, device=dev), batch, prng.PRNGKey(1))
        return float(m["loss"]), float(m["grad_norm"]), {k: v.cpu() for k, v in st.params.items()}

    (la, ga, pa), (lb, gb, pb), (lc, gc, _) = run(cuda), run(cuda), run("cpu")
    assert (la, ga) == (lb, gb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert abs(la - lc) <= 1e-5 * abs(lc) and abs(ga - gc) <= 1e-4 * abs(gc)


# the VLM and audio families: cross-attention on the card against the CPU
# (f32: summation order; bf16: the projections round at other places)
CROSS_CARD_ATOL = {torch.float32: 1e-5, torch.bfloat16: 4e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_on_the_card(cuda, dtype):
    """``cross_attention`` (12 queries over 6 frames) and
    ``decode_cross_attention`` over a bf16 cross KV with its last 3 of 10
    frames masked, card against CPU, GQA 8 / 2 heads."""
    from repro_torch.models.attention import (AttnConfig, cross_attention,
                                              decode_cross_attention)
    cfg = AttnConfig(n_heads=8, n_kv=2, head_dim=16, tp=1)
    g = torch.Generator().manual_seed(5)

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g) * s

    w = {"wq": rnd(32, 128, s=32 ** -0.5), "wk": rnd(32, 32, s=32 ** -0.5),
         "wv": rnd(32, 32, s=32 ** -0.5), "wo": rnd(128, 32, s=0.1)}
    x, mem, x1 = rnd(2, 12, 32), rnd(2, 6, 32), rnd(3, 32)
    ck, cv = rnd(3, 10, 2, 16).to(torch.bfloat16), rnd(3, 10, 2, 16).to(torch.bfloat16)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        wd = {k: v.to(dev, dtype) for k, v in w.items()}
        outs.append((cross_attention(x.to(dev, dtype), mem.to(dev, dtype), wd, cfg),
                     decode_cross_attention(x1.to(dev, dtype), wd, cfg, ck.to(dev), cv.to(dev),
                                            7)))
    for gpu, cpu in zip(*outs):
        assert gpu.device.type == "cuda" and gpu.dtype == dtype
        assert (gpu.cpu().float() - cpu.float()).abs().max().item() <= CROSS_CARD_ATOL[dtype]


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "seamless-m4t-large-v2"])
def test_mm_smoke_decode_step_bit_stable(cuda, arch):
    """One decode step of the VLM (after a prompt with an image block) and
    the audio (the encoder's cross KV) smoke configs on the card, twice from
    the same prefill cache: tokens and every cache leaf bit-equal."""
    from repro_torch.core.qsdp import QSDPConfig
    from repro_torch.serve import build_serve_setup, make_prompt_batch
    setup = build_serve_setup(arch, smoke=True, qsdp=QSDPConfig(), batch=2, prompt_len=16,
                              gen=4, device="cuda")
    tokens = torch.randint(0, 1024, (2, 16), generator=torch.Generator().manual_seed(1))
    batch = make_prompt_batch(setup.cfg, setup.spec, setup.ms, tokens, cuda)
    if setup.cfg.arch_type == "vlm":
        batch["vision_mask"][:, 4:12] = True
        batch["vision_embeds"][:, 4:12] = (torch.randn((2, 8, setup.cfg.d_model),
                                                       generator=torch.Generator().manual_seed(2))
                                           * 0.02).to(cuda, torch.bfloat16)
        batch["positions"] = batch["positions"].clone()
        batch["positions"][1:, :, 4:12] = 4 + torch.arange(8, device=cuda) % 4
    key = prng.PRNGKey(3)
    nxt, cache = setup.engine.prefill_step()(setup.params, batch, key)
    pos = torch.full((2,), 16, dtype=torch.int64)
    runs = []
    for _ in range(2):
        c = {k: v.clone() for k, v in cache.items()}
        out, c = setup.engine.decode_step()(setup.params, c, nxt, pos, key)
        runs.append((out.cpu(), {k: v.cpu() for k, v in c.items()}))
    (t1, c1), (t2, c2) = runs
    assert torch.equal(t1, t2)
    assert set(c1) == ({"k", "v", "ck", "cv"} if setup.cfg.arch_type == "audio" else {"k", "v"})
    for k in c1:
        assert torch.equal(c1[k].view(torch.uint8), c2[k].view(torch.uint8)), k
