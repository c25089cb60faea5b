"""The port's quantize→pack / unpack→dequantize (plain versions, CPU)
against the JAX package: byte-equal codes, scale, zero, wire buffers and
dequantized values, with the same PRNG key on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import ops as jops
from repro_torch.core import prng
from repro_torch.core import quant as tq
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import fma_f32

MODES = ("nearest", "shift", "stochastic")


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bytes_equal(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def _x(n, seed):
    return (np.random.default_rng(seed).standard_normal(n) * 1.7).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 8])
def test_quantize_dequantize_byte_equal(bits, mode):
    """bits x modes over sizes that are not a bucket multiple."""
    for n, seed in ((3000, 0), (1024, 1), (100, 2)):
        x = _x(n, seed)
        jcfg = jq.QuantConfig(bits=bits, bucket_size=256, mode=mode, backend="jnp")
        tcfg = tq.QuantConfig(bits=bits, bucket_size=256, mode=mode)
        qj = jq.quantize(jnp.asarray(x), jcfg, jax.random.PRNGKey(seed + 7))
        qt = tq.quantize(torch.from_numpy(x), tcfg, prng.PRNGKey(seed + 7))
        _bytes_equal(qj.codes, qt.codes)
        _bytes_equal(qj.scale, qt.scale)
        _bytes_equal(qj.zero, qt.zero)
        assert qj.wire_bytes == qt.wire_bytes
        _bytes_equal(jq.dequantize(qj, backend="jnp"), tq.dequantize(qt))


@pytest.mark.parametrize("meta", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_wire_buffers_byte_equal(bits, meta):
    """wire_pack/wire_unpack/fp_pack/fp_unpack and the byte formulas."""
    x = _x(5000, bits)
    jcfg = jq.QuantConfig(bits=bits, bucket_size=1024, mode="shift",
                          meta_dtype=meta, backend="jnp")
    tcfg = tq.QuantConfig(bits=bits, bucket_size=1024, mode="shift", meta_dtype=meta)
    qj = jq.quantize(jnp.asarray(x), jcfg, jax.random.PRNGKey(3))
    qt = tq.quantize(torch.from_numpy(x), tcfg, prng.PRNGKey(3))
    wj, wt = jq.wire_pack(qj), tq.wire_pack(qt)
    _bytes_equal(wj, wt)
    assert wt.numel() == tq.wire_segment_bytes(x.size, tcfg) \
        == jq.wire_segment_bytes(x.size, jcfg)
    uj = jq.wire_unpack(wj, x.size, jcfg)
    ut = tq.wire_unpack(wt, x.size, tcfg)
    for a, b in ((uj.codes, ut.codes), (uj.scale, ut.scale), (uj.zero, ut.zero)):
        _bytes_equal(a, b)
    _bytes_equal(jq.dequantize(uj, backend="jnp"), tq.dequantize(ut))
    for dt in ("float32", "bfloat16", "float16"):
        fj, ft = jq.fp_pack(jnp.asarray(x), dt), tq.fp_pack(torch.from_numpy(x), dt)
        _bytes_equal(fj, ft)
        assert ft.numel() == tq.fp_segment_bytes(x.size, dt)
        _bytes_equal(jq.fp_unpack(fj, x.size, dt), tq.fp_unpack(ft, x.size, dt))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pallas_interpret_one_case_per_kernel(bits):
    """One small case against the Pallas kernels themselves (interpret)."""
    nb, bucket = 8, 256
    x = _x(nb * bucket, bits).reshape(nb, bucket)
    rand = np.array(jax.random.uniform(jax.random.PRNGKey(1), (nb, 1),
                                       minval=-0.5, maxval=0.5))
    levels = (1 << bits) - 1
    cj, sj, zj = jops.quantize_packed(jnp.asarray(x), jnp.asarray(rand), levels,
                                      bits, "shift", 1.0, interpret=True)
    ct, st, zt = tops.quantize_pack(torch.from_numpy(x), prng.PRNGKey(1), levels, bits,
                                    "shift")
    for a, b in ((cj, ct), (sj, st), (zj, zt)):
        _bytes_equal(a, b)
    dj = jops.dequantize_packed(cj, sj, zj, bits, interpret=True)
    _bytes_equal(dj, tops.unpack_dequantize(ct, st, zt, bits))
    dj16 = jops.dequantize_packed(cj, sj, zj, bits, jnp.bfloat16, interpret=True)
    dt16 = tops.unpack_dequantize(ct, st, zt, bits, torch.bfloat16)
    _bytes_equal(np.asarray(dj16).view(np.uint16), dt16.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("meta", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_coalesced_wire_byte_equal(bits, meta):
    """encode_wire/decode_gathered_wire of one layer (two quantized tensors
    and an fp payload) against the JAX package's, each tensor rounded under
    fold_in(key, stable_hash(name))."""
    from repro.core import collectives as jc
    from repro.core.qsdp import _stable_hash
    from repro_torch.core import collectives as tc
    jcfg = jq.QuantConfig(bits=bits, bucket_size=256, mode="shift", meta_dtype=meta,
                          backend="jnp")
    tcfg = tq.QuantConfig(bits=bits, bucket_size=256, mode="shift", meta_dtype=meta)
    names, sizes = ("layers/wq", "layers/norm", "layers/w_up"), (3000, 64, 1024)
    xs = [_x(n, i) for i, n in enumerate(sizes)]
    quantized = (True, False, True)
    jl = jc.WireLayout(tuple(jc.WireSegment(n, jcfg if q else None, "bfloat16")
                             for n, q in zip(sizes, quantized)))
    tl = tc.WireLayout(tuple(tc.WireSegment(n, tcfg if q else None, "bfloat16")
                             for n, q in zip(sizes, quantized)))
    assert jl.nbytes == tl.nbytes and jl.offsets() == tl.offsets()
    jkey, tkey = jax.random.PRNGKey(5), prng.PRNGKey(5)
    jkeys = [jax.random.fold_in(jkey, _stable_hash(n)) if q else None
             for n, q in zip(names, quantized)]
    tkeys = [prng.fold_in(tkey, prng.stable_hash(n)) if q else None
             for n, q in zip(names, quantized)]
    wj = jc.encode_wire([jnp.asarray(x) for x in xs], jl, jkeys)
    wt = tc.encode_wire([torch.from_numpy(x) for x in xs], tl, tkeys)
    _bytes_equal(wj, wt)
    dts = [jnp.float32] * 3
    for a, b in zip(jc.decode_gathered_wire(wj, jl, 1, dts),
                    tc.decode_gathered_wire(tc.gather_wire(wt), tl, 1, [torch.float32] * 3)):
        _bytes_equal(a, b)


def test_fma_f32_is_single_rounding():
    """fma_f32 equals an exact rational a*b + c rounded once to f32."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    a = rng.standard_normal(300).astype(np.float32)
    b = (rng.standard_normal(300) * 1e-3).astype(np.float32)
    c = (rng.standard_normal(300) * np.exp2(rng.integers(-30, 5, 300))).astype(np.float32)
    got = fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(300):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))  # nearest double, then f32 (may double-round)
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.uint32)) & 1))
        assert got[i] == best, i
    # a*b = 1 + 2^-11 + 2^-24 is an f32 midpoint; c = 2^-80 breaks the tie
    # upward.  Rounding through f64 first would land on the midpoint and
    # then round to even (down); a single rounding goes up.
    a = torch.tensor([1 + 2.0**-12], dtype=torch.float32)
    c = torch.tensor([2.0**-80], dtype=torch.float32)
    naive = (a.double() * a.double() + c.double()).float()
    assert naive.item() == 1 + 2.0**-11
    assert fma_f32(a, a, c).item() == 1 + 2.0**-11 + 2.0**-23


def test_quantize_needs_key_and_validates_config():
    with pytest.raises(ValueError):
        tq.quantize(torch.zeros(10), tq.QuantConfig(mode="shift"))
    with pytest.raises(ValueError):
        tq.QuantConfig(bits=9)
    with pytest.raises(ValueError):
        tq.QuantConfig(meta_dtype="float16")
