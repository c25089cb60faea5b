"""Wire-form serving and the pieces of self-speculative decoding, the port
against the JAX package on the CPU: ``qparam_split_stack``,
``make_draft_params``, ``prepare_wire_params`` with the engine's wire-form
gathers (``gather_rowquant_wire`` into K3, ``gather_wire_dequant`` through
K2), ``DecodeModel.verify_fn`` (tokens and KV cache) and the validation of
speculative specs.  The model is the scheduler suite's
(``tests/_torch_serve_common.py``), its weights carried across with
``weights.params_from_jax``; other inputs are made from a numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_serve_common import GATHER_SEED, MESH, RING, models, spec_kw
from repro.compat import shard_map
from repro.core import quant as jquant
from repro.kernels import ref as jref
from repro.models.decode import DecodeSpec as JDecodeSpec
from repro.serve import ServeEngine as JServeEngine
from repro.serve import engine as jengine
from repro_torch.core import prng, quant
from repro_torch.core.quant import QuantizedParam
from repro_torch.kernels import ops
from repro_torch.models.decode import DecodeModel, DecodeSpec
from repro_torch.serve import ServeEngine, engine, make_sample_params

# tests/test_kernels.py:61-96 (K3 with f32 x)
K3_TOL = 2e-4
# bf16 KV of f32 compute: one bf16 rounding apart at most
KV_ATOL = 2e-2


def _wire(jqp) -> np.ndarray:
    return np.asarray(jqp.wire)


def _same_qparam(jqp, tqp):
    assert isinstance(tqp, QuantizedParam)
    assert tuple(jqp.cell_shape) == tuple(tqp.cell_shape)
    assert (jqp.cfg.bits, jqp.cfg.bucket_size, jqp.cfg.mode, jqp.cfg.meta_dtype) == \
        (tqp.cfg.bits, tqp.cfg.bucket_size, tqp.cfg.mode, tqp.cfg.meta_dtype)
    np.testing.assert_array_equal(tqp.wire.numpy(), _wire(jqp))


@pytest.mark.parametrize("bits,mode,meta", [(8, "shift", "float32"), (4, "nearest", "float32"),
                                            (2, "shift", "bfloat16"), (3, "nearest", "float32")])
def test_qparam_split_stack_byte_equal(bits, mode, meta):
    """A stacked leaf (3 layers, 512 values each, buckets of 128) split into
    one wire segment per layer: the same bytes as the JAX package, and each
    slice decodes to its rows of the whole leaf."""
    x = (np.random.default_rng(bits).standard_normal((3, 1, 1, 512)) * 0.05).astype(np.float32)
    jcfg = jquant.QuantConfig(bits=bits, bucket_size=128, mode=mode, meta_dtype=meta)
    tcfg = quant.QuantConfig(bits=bits, bucket_size=128, mode=mode, meta_dtype=meta)
    jqp = jquant.qparam_encode(jnp.asarray(x), jcfg, jax.random.PRNGKey(5))
    tqp = quant.qparam_encode(torch.from_numpy(x), tcfg, prng.PRNGKey(5))
    _same_qparam(jqp, tqp)
    split = quant.qparam_split_stack(tqp)
    _same_qparam(jquant.qparam_split_stack(jqp), split)
    assert split.wire.shape[:3] == (3, 1, 1) and split.cell_shape == (512,)
    whole = quant.qparam_decode(tqp)
    for i in range(3):
        one = QuantizedParam(split.wire[i], split.cell_shape, tcfg)
        assert torch.equal(quant.qparam_decode(one), whole[i])


def test_qparam_split_stack_needs_whole_buckets():
    tqp = quant.qparam_encode(torch.zeros(2, 1, 1, 96), quant.QuantConfig(bucket_size=64,
                                                                          mode="nearest"))
    with pytest.raises(ValueError, match="whole buckets"):
        quant.qparam_split_stack(tqp)
    with pytest.raises(ValueError, match="not a stacked"):
        quant.qparam_split_stack(quant.qparam_encode(torch.zeros(1, 1, 64),
                                                     quant.QuantConfig(mode="nearest")))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_make_draft_params_byte_equal(bits):
    """The draft's re-quantized layer matmuls: codes, scale and zero
    byte-equal to the JAX package's, split per layer; every other leaf is
    the serving params' own tensor."""
    (jm, jp), (tm, tp) = models()
    jd = jengine.make_draft_params(jm, jp, bits)
    td = engine.make_draft_params(tm, tp, bits)
    assert set(jd) == set(td) == set(tp)
    wire = [n for n, v in jd.items() if isinstance(v, jquant.QuantizedParam)]
    assert sorted(wire) == sorted(n for n, v in td.items() if isinstance(v, QuantizedParam))
    assert {n.split("/")[-1] for n in wire} == set(engine.DRAFT_WEIGHTS)
    for n in wire:
        _same_qparam(jd[n], td[n])
        assert td[n].cfg.bits == bits and td[n].cfg.mode == "nearest"
        assert td[n].wire.shape[0] == tm.cfg.n_layers  # one segment per layer
    for n in set(td) - set(wire):
        assert td[n] is tp[n], n


@pytest.mark.parametrize("bits", [1, 9])
def test_make_draft_params_rejects_bad_bits(bits):
    _, (tm, tp) = models()
    with pytest.raises(ValueError, match="draft_bits"):
        engine.make_draft_params(tm, tp, bits)


def _quantized_state(jm, jp):
    """The MLP weights as wire codes, as a quantized train state holds them:
    w_gate/w_up/w_down at 8 bits in buckets that tile their rows (64), and
    one leaf whose buckets do not (wq, buckets of 256 over rows of 64)."""
    out = dict(jp)
    for n, cfg in (("layers/w_gate", jquant.QuantConfig(bucket_size=64)),
                   ("layers/w_up", jquant.QuantConfig(bucket_size=64)),
                   ("layers/w_down", jquant.QuantConfig(bucket_size=64)),
                   ("layers/wq", jquant.QuantConfig(bucket_size=256))):
        out[n] = jquant.qparam_encode(jp[n], cfg, jax.random.PRNGKey(3))
    return out


def _to_port(tree) -> dict:
    return {n: (QuantizedParam(torch.from_numpy(np.array(v.wire)), tuple(v.cell_shape),
                               quant.QuantConfig(**{f: getattr(v.cfg, f) for f in (
                                   "bits", "bucket_size", "mode", "rand_bits", "meta_dtype")}))
                if isinstance(v, jquant.QuantizedParam) else torch.from_numpy(np.array(v)))
            for n, v in tree.items()}


def test_prepare_wire_params_and_wire_gathers():
    """prepare_wire_params keeps the MLP weights' codes (split per layer) and
    decodes the rest exactly; per layer, gather_rowquant_wire gives the JAX
    engine's codes/scale/zero byte for byte and K3 over them is within K3's
    tolerance of the reference's matmul; gather_wire_dequant's dense
    weights equal the JAX engine's (one K2 call for the layer's)."""
    (jm, jp), (tm, _) = models()
    jq = _quantized_state(jm, jp)
    jw = jengine.prepare_wire_params(jm, jq)
    tw = engine.prepare_wire_params(tm, _to_port(jq))
    assert set(jw) == set(tw)
    for n in jw:
        if isinstance(jw[n], jquant.QuantizedParam):
            _same_qparam(jw[n], tw[n])
            assert n.split("/")[-1] in ("w_gate", "w_up", "w_down")
        else:
            np.testing.assert_array_equal(tw[n].numpy(), np.asarray(jw[n]), err_msg=n)
    assert not isinstance(tw["layers/wq"], QuantizedParam)  # decoded: buckets do not tile
    # the reference's wire-form gathers run inside shard_map on the (1, 1) mesh
    je, te = jm.engine, tm.engine
    rng = np.random.default_rng(0)
    draft = engine.make_draft_params(tm, _to_port(jp), 4)
    jdraft = jengine.make_draft_params(jm, jp, 4)
    for layer in range(tm.cfg.n_layers):
        for n in ("w_gate", "w_up", "w_down"):
            name = f"layers/{n}"
            jqp = jw[name]
            jone = jquant.QuantizedParam(jqp.wire[layer], jqp.cell_shape, jqp.cfg)
            tone = QuantizedParam(tw[name].wire[layer], tw[name].cell_shape, tw[name].cfg)
            assert je.rowquant_wire_eligible(name, jone) and te.rowquant_wire_eligible(name, tone)
            jrq = shard_map(lambda w, jone=jone, name=name: je.gather_rowquant_wire(
                name, jquant.QuantizedParam(w, jone.cell_shape, jone.cfg)), mesh=MESH,
                in_specs=P(), out_specs=P(), check_vma=False)(jone.wire)
            trq = te.gather_rowquant_wire(name, tone)
            for a, b in zip(jrq, trq):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            x = rng.standard_normal((3, trq.codes.shape[0])).astype(np.float32)
            want = np.asarray(jref.rowquant_matmul_ref(jnp.asarray(x), *map(jnp.asarray, jrq)))
            got = ops.rowquant_matmul(torch.from_numpy(x), *trq).numpy()
            np.testing.assert_allclose(got, want, rtol=K3_TOL, atol=K3_TOL * np.abs(want).max())
        # the draft's dense wire decode: wq..wo at 4 bits, buckets of 64
        names = ("wk", "wo", "wq", "wv")
        tlay = {n: QuantizedParam(draft[f"layers/{n}"].wire[layer], draft[f"layers/{n}"].cell_shape,
                                  draft[f"layers/{n}"].cfg) for n in names}
        dense = te.gather_wire_dequant("layers/", tlay)
        for n in names:
            jqp = jdraft[f"layers/{n}"]
            jone = jquant.QuantizedParam(jqp.wire[layer], jqp.cell_shape, jqp.cfg)
            want = shard_map(lambda w, jone=jone, n=n: je.gather_wire_dequant(
                f"layers/{n}", jquant.QuantizedParam(w, jone.cell_shape, jone.cfg)), mesh=MESH,
                in_specs=P(), out_specs=P(), check_vma=False)(jone.wire)
            assert dense[n].dtype == te.compute_dtype
            np.testing.assert_array_equal(dense[n].numpy(), np.asarray(want), err_msg=n)


def _verify_inputs():
    """Two chunked-prefill launches filling 3 lanes (ring of 32), then a
    verify window: lane 0 runs 3 tokens, lane 1 one, lane 2 is dead."""
    rng = np.random.default_rng(9)
    chunks = [(rng.integers(0, 256, (3, 4)), [0, 0, 0], [4, 4, 3]),
              (rng.integers(0, 256, (3, 4)), [4, 4, 0], [4, 2, 0])]
    window = rng.integers(0, 256, (3, 3))
    return chunks, window, [8, 6, -1], [3, 1, 0]


def test_verify_fn_matches_reference():
    """verify_fn's tokens and KV cache against the JAX package's verify step
    from the same cache, greedy and sampled lanes; and its first token per
    lane is what decode_fn emits from that cache."""
    (jm, jp), (tm, tp) = models()
    skw = spec_kw(slots=3, draft_bits=4, draft_depth=4)
    jeng = JServeEngine(jm, MESH, JDecodeSpec(**skw))
    teng = ServeEngine(tm, DecodeSpec(**skw), "cpu")
    chunks, window, pos, n_spec = _verify_inputs()
    samp = [(0.0, 0, 1), (0.9, 7, 2), (0.0, 0, 3)]
    tsample = {k: torch.cat([make_sample_params(t, k_, s)[k] for t, k_, s in samp])
               for k in ("temp", "top_k", "key")}
    jsample = {"temp": jnp.asarray([t for t, _, _ in samp], jnp.float32),
               "top_k": jnp.asarray([k for _, k, _ in samp], jnp.int32),
               "key": jnp.stack([jax.random.PRNGKey(s) for _, _, s in samp])}
    jkey, tkey = jax.random.PRNGKey(GATHER_SEED), prng.PRNGKey(GATHER_SEED)
    with MESH:
        jc = jeng.init_cache()
        for tok, off, nv in chunks:
            _, jc = jeng.prefill_chunk_step(4)(jp, jc, jnp.asarray(tok, jnp.int32),
                                               jnp.asarray(off, jnp.int32),
                                               jnp.asarray(nv, jnp.int32), jkey, jsample)
        jout, jc = jeng.verify_step(3)(jp, jc, jnp.asarray(window, jnp.int32),
                                       jnp.asarray(pos, jnp.int32),
                                       jnp.asarray(n_spec, jnp.int32), jkey, jsample)
    tc = teng.init_cache()
    with torch.inference_mode():
        for tok, off, nv in chunks:
            _, tc = teng.prefill_chunk_step(4)(tp, tc, torch.tensor(tok), torch.tensor(off),
                                               torch.tensor(nv), tkey, tsample)
        before = {k: v.clone() for k, v in tc.items()}
        first, _ = teng.decode_step()(tp, before, torch.tensor(window[:, 0]),
                                      torch.tensor(pos), tkey, tsample)
        tout, tc = teng.verify_step()(tp, tc, torch.tensor(window), torch.tensor(pos),
                                      torch.tensor(n_spec), tkey, tsample)
    jout = np.asarray(jout)
    assert tout.shape == (3, 3)
    for b, k in enumerate(n_spec):
        np.testing.assert_array_equal(tout[b, :k].numpy(), jout[b, :k], err_msg=f"lane {b}")
    assert torch.equal(tout[:2, 0], first[:2])
    for name in ("k", "v"):
        a, b = np.asarray(jc[name].astype(jnp.float32)), tc[name].float().numpy()
        assert ((a != 0) == (b != 0)).all(), name
        np.testing.assert_allclose(b, a, rtol=0, atol=KV_ATOL)


@pytest.mark.parametrize("bits,depth", [(1, 4), (9, 4)])
def test_speculative_spec_validation(bits, depth):
    """draft_bits outside [2, 8] is refused, as by the reference's engine."""
    _, (tm, _) = models()
    spec = DecodeSpec(**spec_kw(slots=2, draft_bits=bits, draft_depth=depth))
    with pytest.raises(ValueError, match="draft_bits"):
        ServeEngine(tm, spec, "cpu")
    with pytest.raises(ValueError, match="draft_bits"):
        DecodeModel(tm, spec)


def test_decode_spec_speculative_property():
    kw = dict(cache_len=RING, batch_global=4, batch_sharded=False)
    assert DecodeSpec(**kw, draft_bits=4, draft_depth=4).speculative
    assert not DecodeSpec(**kw).speculative
    assert not DecodeSpec(**kw, draft_bits=4, draft_depth=1).speculative
    assert not DecodeSpec(**kw, draft_bits=0, draft_depth=4).speculative
