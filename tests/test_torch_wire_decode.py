"""The layer decode on K2's wire path (plain versions, CPU) against the JAX
package: a gathered buffer's quantized segments decoded in one
``unpack_dequantize_wire`` call, each into the dtype its consumer reads.
Tolerance 0 throughout: every comparison is byte for byte.

  (a) ``decode_gathered_wire`` and the reduce-scatter decode against the
      JAX package's ``decode_gathered_wire`` / ``_decode_segments`` over a
      mixed layout: bits 2/3/4/8, f32 and bf16 scale/zero, odd nb (the next
      segment off 16-byte alignment), fp segments in f32 and bf16, ragged n,
      one and two rows;
  (b) the bf16 decode equal to the f32 decode cast to bf16;
  (c) one gpt-125m smoke layer gathered by ``QSDPEngine.gather_layer``
      (bf16 compute) equal to the reference's gathered weights, through
      one K2 call;
  (d) the K2 launches of ``generate()`` equal to what ``chip_smoke.py``
      derives from the code's structure (one per decoded buffer), dense and
      rowquant, with and without K3-tiling MLP rows;
  (e) a buffer of more (row, segment) entries than one launch's table
      holds, and ``qparam_decode`` of several cells in one K2 call.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.core.collectives as jc
from repro.compat import shard_map
from repro.configs import gpt_125m as jcfg125
from repro.core import quant as jq
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.transformer import Model as JModel
import repro_torch.core.collectives as tc
from repro_torch.configs import gpt_125m as tcfg125
from repro_torch.core import prng
from repro_torch.core import quant as tq
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model

ROOT = Path(__file__).resolve().parents[1]

# (n, bits or None for an fp payload, bucket, fp wire dtype)
MIXED = ((300, None, 0, "float32"),
         (5 * 1024 - 3, 8, 1024, ""),   # nb 5: the next segment is 8 bytes off 16
         (77, None, 0, "bfloat16"),      # 154 bytes: off 4-byte alignment
         (3000, 4, 256, ""),
         (3 * 1024 + 1, 2, 1024, ""),
         (999, 3, 100, ""),              # one code per byte
         (4096, 8, 1024, ""))


def _layouts(meta):
    jsegs, tsegs = [], []
    for n, bits, bucket, fp in MIXED:
        if bits is None:
            jsegs.append(jc.WireSegment(n, None, fp))
            tsegs.append(tc.WireSegment(n, None, fp))
        else:
            jsegs.append(jc.WireSegment(n, jq.QuantConfig(
                bits=bits, bucket_size=bucket, mode="shift", meta_dtype=meta, backend="jnp")))
            tsegs.append(tc.WireSegment(n, tq.QuantConfig(
                bits=bits, bucket_size=bucket, mode="shift", meta_dtype=meta)))
    return jc.WireLayout(tuple(jsegs)), tc.WireLayout(tuple(tsegs))


def _rows(jl, p, seed):
    """P rows encoded by the JAX package: (P * nbytes,) u8 numpy."""
    rng = np.random.default_rng(seed)
    rows = []
    for r in range(p):
        xs = [jnp.asarray((rng.standard_normal(s.n) * 10.0 ** rng.uniform(-3, 1)).astype(
            np.float32)) for s in jl.segments]
        keys = [jax.random.fold_in(jax.random.PRNGKey(seed), 10 * r + i)
                if s.cfg is not None else None for i, s in enumerate(jl.segments)]
        rows.append(np.asarray(jc.encode_wire(xs, jl, keys)))
    return np.concatenate(rows)


def _bits(a):
    """Raw bytes of a JAX/numpy or torch array, bf16 included."""
    if isinstance(a, torch.Tensor):
        return a.dtype, a.contiguous().view(torch.uint8).numpy().tobytes()
    a = np.ascontiguousarray(np.asarray(a))
    return str(a.dtype), a.tobytes()


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("meta", ["float32", "bfloat16"])
def test_decode_gathered_wire_matches_jax(meta, p):
    jl, tl = _layouts(meta)
    assert jl.nbytes == tl.nbytes and jl.offsets() == tl.offsets()
    gbuf = _rows(jl, p, seed=p + (meta == "bfloat16"))
    odd = [(off % 16) for off, s in zip(tl.offsets(), tl.segments) if s.cfg is not None]
    assert any(odd), "the layout should put a quantized segment off 16-byte alignment"
    tdts = ([torch.float32, torch.bfloat16] * 4)[:len(MIXED)]
    jdts = [jnp.float32 if dt == torch.float32 else jnp.bfloat16 for dt in tdts]
    got = tc.decode_gathered_wire(torch.from_numpy(gbuf.copy()), tl, p, tdts)
    want = jc.decode_gathered_wire(jnp.asarray(gbuf), jl, p, jdts)
    for g, w, dt in zip(got, want, tdts, strict=True):
        assert g.dtype == dt and g.shape == w.shape
        assert _bits(g)[1] == _bits(w)[1]
    # the reduce-scatter's decode: every (row, segment) in f32
    rows = gbuf.reshape(p, -1)
    tseg = tc._decode_segments(torch.from_numpy(rows.copy()), tl, [torch.float32] * len(MIXED))
    jseg = jc._decode_segments(jnp.asarray(rows), jl)
    for tv, jv in zip(tseg, jseg, strict=True):
        assert len(tv) == p
        for r in range(p):
            assert tv[r].dtype == torch.float32
            assert _bits(tv[r])[1] == _bits(np.asarray(jv)[r])[1]


@pytest.mark.parametrize("meta", ["float32", "bfloat16"])
def test_bf16_decode_is_the_f32_decode_cast(meta):
    """bf16 straight from K2's plain version == f32 decode then .to(bf16),
    over values spanning six decades (the one f32 rounding, then the one
    bf16 rounding)."""
    jl, tl = _layouts(meta)
    buf = torch.from_numpy(_rows(jl, 1, seed=7))
    f32 = tc.decode_gathered_wire(buf, tl, 1, [torch.float32] * len(MIXED))
    b16 = tc.decode_gathered_wire(buf, tl, 1, [torch.bfloat16] * len(MIXED))
    for a, b in zip(f32, b16, strict=True):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16).view(torch.int16), b.view(torch.int16))
    table, _ = tc.wire_table(tl, 1, [torch.float32] * len(MIXED))
    for a, b in zip(ops.unpack_dequantize_wire(buf, table, [torch.float32] * len(table)),
                    ops.unpack_dequantize_wire(buf, table, [torch.bfloat16] * len(table))):
        assert torch.equal(a.to(torch.bfloat16).view(torch.int16), b.view(torch.int16))


def test_wire_table_rows_and_segments():
    """The table is segment-major over P rows, each entry's bytes inside its
    row, quantized segments only."""
    _, tl = _layouts("bfloat16")
    table, dts = tc.wire_table(tl, 3, [torch.float16] * len(MIXED))
    q = [(s, off) for s, off in zip(tl.segments, tl.offsets()) if s.cfg is not None]
    assert len(table) == 3 * len(q) and dts == [torch.float32] * len(table)
    for i, t in enumerate(table):
        seg, off = q[i // 3]
        r = i % 3
        assert t.codes == r * tl.nbytes + off
        assert t.scale - t.codes == np.prod(tq.quantized_shapes(seg.n, seg.cfg)["codes"])
        assert t.zero - t.scale == 2 * t.nb and t.zero + 2 * t.nb - t.codes == seg.nbytes
        assert t.nb * t.bucket >= seg.n > (t.nb - 1) * t.bucket
        assert t.meta_dtype == torch.bfloat16


@pytest.mark.parametrize("meta", ["float32", "bfloat16"])
def test_decode_more_than_64_table_entries_matches_jax(meta):
    """14 rows x 5 quantized segments = 70 (row, segment) entries, more than
    one launch's table holds (``ops.WIRE_MAX_SEGS``): the gather decode and
    the reduce-scatter decode still equal the JAX package's."""
    p = 14
    jl, tl = _layouts(meta)
    table, _ = tc.wire_table(tl, p, [torch.float32] * len(MIXED))
    assert len(table) == 70 > ops.WIRE_MAX_SEGS
    gbuf = _rows(jl, p, seed=64)
    tdts = ([torch.bfloat16, torch.float32] * 4)[:len(MIXED)]
    jdts = [jnp.float32 if dt == torch.float32 else jnp.bfloat16 for dt in tdts]
    got = tc.decode_gathered_wire(torch.from_numpy(gbuf.copy()), tl, p, tdts)
    want = jc.decode_gathered_wire(jnp.asarray(gbuf), jl, p, jdts)
    for g, w, dt in zip(got, want, tdts, strict=True):
        assert g.dtype == dt and g.shape == w.shape
        assert _bits(g)[1] == _bits(w)[1]
    rows = gbuf.reshape(p, -1)
    tseg = tc._decode_segments(torch.from_numpy(rows.copy()), tl, [torch.float32] * len(MIXED))
    for tv, jv in zip(tseg, jc._decode_segments(jnp.asarray(rows), jl), strict=True):
        assert [_bits(v)[1] for v in tv] == [_bits(np.asarray(jv)[r])[1] for r in range(p)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,bits,meta", [((2, 3, 1500), 8, "float32"),
                                             ((2, 2, 3, 1000), 4, "bfloat16")])
def test_qparam_decode_is_one_wire_call(shape, bits, meta, dtype, monkeypatch):
    """``qparam_decode`` of a leaf of several cells: one
    ``unpack_dequantize_wire`` call over the whole wire (no single-tensor
    K2 call), byte-equal to the JAX package's ``qparam_decode``."""
    x = np.random.default_rng(bits).standard_normal(shape).astype(np.float32)
    jqp = jq.qparam_encode(jnp.asarray(x), jq.QuantConfig(bits=bits, mode="shift",
                                                          meta_dtype=meta, backend="jnp"),
                           jax.random.PRNGKey(3))
    tqp = tq.qparam_encode(torch.from_numpy(x), tq.QuantConfig(bits=bits, mode="shift",
                                                               meta_dtype=meta), prng.PRNGKey(3))
    assert tqp.wire.numpy().tobytes() == np.asarray(jqp.wire).tobytes()
    calls = {"wire": 0, "one": 0}
    for fn, tag in (("unpack_dequantize_wire", "wire"), ("unpack_dequantize", "one")):
        def counted(*a, _orig=getattr(ops, fn), _tag=tag, **k):
            calls[_tag] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, fn, counted)
    got = tq.qparam_decode(tqp, dtype)
    assert calls == {"wire": 1, "one": 0}
    want = jq.qparam_decode(jqp, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    assert got.dtype == dtype and tuple(got.shape) == shape == want.shape
    assert _bits(got)[1] == _bits(want)[1]


def test_gpt125m_layer_gather_matches_reference(mesh11, monkeypatch):
    """One gpt-125m smoke layer through ``gather_layer`` (default config:
    W8 shift, bf16 compute): every weight the model reads is the
    reference's, byte for byte, and the layer's buffer is decoded by one
    K2 call (no single-tensor K2 call)."""
    jm = JModel(jcfg125.smoke(), JMeshSpec(("data", "model"), (1, 1)), JQSDPConfig())
    tm = Model(tcfg125.smoke(), MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
    params = jm.init_params(jax.random.PRNGKey(0))
    names = sorted(n[len("layers/"):] for n in jm.specs if n.startswith("layers/"))
    leaves = {n: np.asarray(params[f"layers/{n}"][1]) for n in names}
    key = jax.random.PRNGKey(4)
    jw = jax.jit(shard_map(lambda lv: jm.engine.gather_layer("layers/", lv, key), mesh=mesh11,
                           in_specs=(P(),), out_specs=P(), check_vma=False))(
        {n: jnp.asarray(v) for n, v in leaves.items()})
    calls = {"wire": 0, "one": 0}
    for fn, tag in (("unpack_dequantize_wire", "wire"), ("unpack_dequantize", "one")):
        def counted(*a, _orig=getattr(ops, fn), _tag=tag, **k):
            calls[_tag] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, fn, counted)
    tw = tm.engine.gather_layer("layers/", {n: torch.from_numpy(v.copy())
                                            for n, v in leaves.items()}, prng.PRNGKey(4))
    assert calls == {"wire": 1, "one": 0}
    assert sum(tm.engine._is_quantized(tm.specs[f"layers/{n}"]) for n in names) == 7
    for n in names:
        assert tw[n].dtype == torch.bfloat16 and tuple(tw[n].shape) == jw[n].shape, n
        assert _bits(tw[n])[1] == _bits(jw[n])[1], n


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("bucket", [256, 1024])
@pytest.mark.parametrize("rowquant", [False, True])
def test_serve_launches_match_chip_smoke_formula(rowquant, bucket, monkeypatch):
    """``chip_smoke.expected_launches`` against the wrappers' calls in a
    gpt-1.3b smoke ``generate`` (the wrappers count only kernel launches, so
    this counts calls): at bucket 256 the smoke MLP rows tile and go through
    K3, at 1024 they fall back to buffers of their own."""
    import repro_torch.models.layers as tlayers
    from repro_torch.data import SyntheticLM
    from repro_torch.serve import build_serve_setup, make_prompt_batch

    cs = _chip_smoke()
    counts = dict.fromkeys(ops.KERNELS, 0)
    for mod, fn, kernel in ((ops, "quantize_pack", "quantize_pack"),
                            (ops, "unpack_dequantize", "unpack_dequantize"),
                            (ops, "unpack_dequantize_wire", "unpack_dequantize"),
                            (tlayers, "rowquant_matmul", "rowquant_matmul")):
        def counted(*a, _orig=getattr(mod, fn), _kernel=kernel, **k):
            counts[_kernel] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, counted)
    gen = 3
    setup = build_serve_setup("gpt-1.3b", smoke=True, qsdp=QSDPConfig(bucket_size=bucket),
                              rowquant_mlp=rowquant, device="cpu", batch=2, prompt_len=8,
                              gen=gen)
    tokens, _ = SyntheticLM(setup.cfg.vocab_size, 8, 2, seed=0).sample(0)
    prompt = make_prompt_batch(setup.cfg, setup.spec, setup.ms, tokens, setup.device)
    with torch.inference_mode():
        setup.engine.generate(setup.params, prompt, n_tokens=gen)
    want = cs.expected_launches(setup.model, gen, rowquant)
    assert counts == {k: want.get(k, 0) for k in ops.KERNELS}
    eligible = rowquant and bucket == 256
    # smoke: embed + 2 layers per pass; 6 MLP weights through K3 per step
    assert want["per_step"] == (15, 3 + (0 if eligible or not rowquant else 6),
                                6 if eligible else 0)
