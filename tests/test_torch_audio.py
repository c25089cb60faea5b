"""The audio family (encoder-decoder) of the port against the JAX package on
the CPU, module by module, on the same inputs made from a numpy seed:

  (a) the prompt's audio stub, ``0.1 * jax.random.normal(PRNGKey(seed), (B,
      enc_len, d), bfloat16)``, byte-equal (the port draws it with its
      threefry twin: 8 bits a value, every step a bf16 operation);
  (b) ``cross_attention`` (queries and keys of different lengths, full
      mask) and ``decode_cross_attention`` over a bf16 cross KV, with
      ``enc_len`` equal to and shorter than the cached frames, GQA and
      plain, f32 and bf16 compute (the JAX functions through ``shard_map``
      on the (1, 1) mesh, whose psums are the identity);
  (c) the encoder layer (non-causal self-attention, then the MLP);
  (d) seamless-m4t's smoke config through both packages'
      ``build_serve_setup`` -> prefill at the default QSDPConfig in f32
      compute: every gathered weight byte-equal per tensor (the encoder's
      under ``fold_in(key, 3000)``, ``enc_final_norm`` under the parent
      key), the prefill's next tokens equal, its caches k/v/ck/cv within
      one bf16 ulp of the reference's and at least 98 % of them byte-equal
      (both sum f32 products in their own orders before the bf16 cast);
  (e) ``weights.params_from_jax`` on the family's names (``enc/``,
      ``dec/``, ``dec/x*``, ``enc_final_norm``, the untied ``lm_head``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models.attention as jattn
import repro.models.layers as jlayers
from repro.compat import shard_map
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.transformer import Model as JModel
from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as L
from repro_torch.models.transformer import Model
from repro_torch.weights import params_from_jax

from _torch_mm_common import jax_run, port_run, prompts, setups

torch.set_num_threads(1)
MESH = jax.make_mesh((1, 1), ("data", "model"))
ARCH = "seamless_m4t_large_v2"
# f32: summation order and exp (measured ~1e-6 on outputs of magnitude ~1);
# bf16: the projections round to bf16 on both sides at other places, one
# ulp of values up to ~2 is 1.6e-2
ATOL = {"float32": 2e-5, "bfloat16": 4e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the prefill's bf16 caches at f32 compute: the two packages sum their f32
# products in different orders (~1e-6 absolute), and a few entries round to
# the neighbouring bf16 value (one ulp: at most 2^-7 relative; near zero the
# f32 difference itself, CACHE_ATOL); the rest are byte-equal
CACHE_ULP = 2.0 ** -7
CACHE_ATOL = 1e-5
CACHE_EQUAL_SHARE = 0.98


def _smap(fn, n_in):
    return jax.jit(shard_map(fn, mesh=MESH, in_specs=(P(),) * n_in, out_specs=P(),
                             check_vma=False))


def _acfgs(n_heads, n_kv, hd):
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=hd, tp=1)
    return jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)


def _np(seed, *shape, s=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * s).astype(np.float32)


# -- (a) the audio stub -------------------------------------------------------------

def test_bf16_normal_byte_equal_to_jax():
    """All 256 values of the draw's low byte occur; every value byte-equal."""
    for seed, shape in ((1, (4, 64, 256)), (5, (3, 1000))):
        j = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.bfloat16))
        t = prng.normal(prng.PRNGKey(seed), shape, dtype=torch.bfloat16)
        low = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)) & 0xFF
        assert len(np.unique(low)) == 256
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                      j.view(np.uint16))


def test_audio_stub_byte_equal():
    js, ts = setups(ARCH)
    jb, _, tb = prompts(js, ts)
    assert ts.spec.enc_len == js.spec.enc_len == 8
    j = np.asarray(jb["audio_embeds"])
    t = tb["audio_embeds"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape == (2, 8, 256)
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  j.view(np.uint16))


# -- (b) cross-attention ------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_heads,n_kv", [(8, 8), (8, 2)])
def test_cross_attention_matches_jax(dt, n_heads, n_kv):
    hd, d, s, s_enc = 16, 32, 12, 6
    jcfg, tcfg = _acfgs(n_heads, n_kv, hd)
    jdt, tdt = DTYPES[dt]
    x, mem = _np(1, 2, s, d), _np(2, 2, s_enc, d)
    w = {"wq": _np(3, d, n_heads * hd, s=d ** -0.5), "wk": _np(4, d, n_kv * hd, s=d ** -0.5),
         "wv": _np(5, d, n_kv * hd, s=d ** -0.5), "wo": _np(6, n_heads * hd, d, s=0.1)}
    want = _smap(lambda a, m, ww: jattn.cross_attention(a, m, ww, jcfg), 3)(
        jnp.asarray(x, jdt), jnp.asarray(mem, jdt),
        {k: jnp.asarray(v, jdt) for k, v in w.items()})
    got = tattn.cross_attention(torch.from_numpy(x).to(tdt), torch.from_numpy(mem).to(tdt),
                                {k: torch.from_numpy(v).to(tdt) for k, v in w.items()}, tcfg)
    assert got.dtype == tdt and tuple(got.shape) == (2, s, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=ATOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_heads,n_kv,enc_len", [(8, 8, 10), (8, 2, 10), (8, 2, 7)])
def test_decode_cross_attention_matches_jax(dt, n_heads, n_kv, enc_len):
    """Against the bf16 cross KV of 10 frames; enc_len 7 masks the last 3."""
    hd, d, s_enc = 16, 32, 10
    jcfg, tcfg = _acfgs(n_heads, n_kv, hd)
    jdt, tdt = DTYPES[dt]
    x = _np(1, 3, d)
    ck, cv = _np(2, 3, s_enc, n_kv, hd), _np(3, 3, s_enc, n_kv, hd)
    w = {"wq": _np(4, d, n_heads * hd, s=d ** -0.5), "wo": _np(5, n_heads * hd, d, s=0.1)}
    want = _smap(lambda a, ww, k, v, e: jattn.decode_cross_attention(a, ww, jcfg, k, v, e), 5)(
        jnp.asarray(x, jdt), {k: jnp.asarray(v, jdt) for k, v in w.items()},
        jnp.asarray(ck, jnp.bfloat16), jnp.asarray(cv, jnp.bfloat16), jnp.int32(enc_len))
    tck, tcv = (torch.from_numpy(a).to(torch.bfloat16) for a in (ck, cv))
    tw = {k: torch.from_numpy(v).to(tdt) for k, v in w.items()}
    got = tattn.decode_cross_attention(torch.from_numpy(x).to(tdt), tw, tcfg, tck, tcv, enc_len)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=ATOL[dt])
    if enc_len < s_enc:  # the masked frames do not matter
        tck[:, enc_len:] = 7.0
        tcv[:, enc_len:] = -7.0
        again = tattn.decode_cross_attention(torch.from_numpy(x).to(tdt), tw, tcfg, tck, tcv,
                                             enc_len)
        assert torch.equal(again, got)


# -- (c) the encoder layer -------------------------------------------------------------

def _enc_weights(cfg, seed):
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    hq, hk = cfg.n_heads * hd, cfg.n_kv_heads * hd
    s = d ** -0.5
    return {"wq": _np(seed, d, hq, s=s), "wk": _np(seed + 1, d, hk, s=s),
            "wv": _np(seed + 2, d, hk, s=s), "wo": _np(seed + 3, hq, d, s=0.05),
            "w_gate": _np(seed + 4, d, ff, s=s), "w_up": _np(seed + 5, d, ff, s=s),
            "w_down": _np(seed + 6, ff, d, s=ff ** -0.5),
            "attn_norm": 1 + _np(seed + 7, d, s=0.1), "mlp_norm": 1 + _np(seed + 8, d, s=0.1)}


def test_encoder_layer_matches_jax():
    """f32: the same weights and frames through ``Model._enc_layer`` of each
    package, 1-D RoPE over 8 frames; non-causal (the first frame sees the
    last)."""
    jc = jconfigs.get_smoke(ARCH)
    jm = JModel(jc, JMeshSpec(("data", "model"), (1, 1)), JQSDPConfig(compute_dtype="float32"))
    tm = Model(configs.get_smoke(ARCH), MeshSpec(("data", "model"), (1, 1)),
               QSDPConfig(compute_dtype="float32"))
    w = _enc_weights(jc, 20)
    x, s_enc = _np(9, 2, 8, jc.d_model), 8
    pos = np.arange(s_enc)

    def jf(a, ww):
        c, s_ = jlayers.rope_cos_sin(jnp.arange(s_enc), jc.head_dim, jc.rope_theta)
        return jm._enc_layer(a, ww, c, s_, jnp.arange(s_enc))

    want = np.asarray(_smap(jf, 2)(jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()}))
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    c, s_ = L.rope_cos_sin(torch.from_numpy(pos), jc.head_dim, jc.rope_theta)
    got = tm._enc_layer(torch.from_numpy(x), tw, c, s_, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    x2 = x.copy()
    x2[:, -1] += 1.0
    got2 = tm._enc_layer(torch.from_numpy(x2), tw, c, s_, torch.from_numpy(pos))
    assert not torch.equal(got2[:, 0], got[:, 0])


# -- (d) the prefill through both engines -----------------------------------------------

@pytest.fixture(scope="module")
def prefill():
    mp = pytest.MonkeyPatch()
    js, ts = setups(ARCH)
    jb, jps, tb = prompts(js, ts)
    return jax_run(js, jb, jps, mp, gen=0), port_run(ts, tb, mp, gen=0), ts


def test_audio_prefill_gathers_byte_equal(prefill):
    (_, _, jf, _, _), (_, _, tf, _, _), ts = prefill
    cfg = ts.cfg
    assert set(jf) == set(tf)
    assert {"embed", "lm_head", "enc_final_norm", "enc/wq", "enc/w_down", "dec/wq", "dec/xwq",
            "dec/xwk", "dec/xwv", "dec/xwo", "dec/xattn_norm", "dec/w_gate"} <= set(tf)
    for name, digests in jf.items():
        per = (cfg.n_enc_layers if name.startswith("enc/")
               else cfg.n_layers if name.startswith("dec/") else 1)
        assert len(digests) == per, name
        assert tf[name] == digests, name


def test_encoder_key_scope():
    """The encoder's layer i is quantized under fold_in(fold_in(key, 3000),
    i): under the decoder's fold_in(key, i) its wq would gather other bytes."""
    _, ts = setups(ARCH, qcfg_kw={})
    eng = ts.model.engine
    grp = {n: ts.params[f"enc/{n}"][0] for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                                   "w_down", "attn_norm", "mlp_norm")}
    key = prng.PRNGKey(3)
    right = eng.gather_layer("enc/", grp, prng.fold_in(prng.fold_in(key, 3000), 0))
    wrong = eng.gather_layer("enc/", grp, prng.fold_in(key, 0))
    assert not torch.equal(right["wq"], wrong["wq"])


def test_audio_prefill_tokens_and_caches(prefill):
    (_, _, _, jc, jn), (_, _, _, tc, tn), ts = prefill
    np.testing.assert_array_equal(tn, jn)
    assert set(jc) == set(tc) == {"k", "v", "ck", "cv"}
    for k in jc:
        # the port's rows are the engine's lanes; the prompt fills the first B
        t = tc[k][:, :jc[k].shape[1]]
        assert t.shape == jc[k].shape, k
        assert np.abs(jc[k]).max() > 0, k
        np.testing.assert_allclose(t, jc[k], rtol=CACHE_ULP, atol=CACHE_ATOL, err_msg=k)
        assert (t == jc[k]).mean() >= CACHE_EQUAL_SHARE, k
    e = ts.spec.enc_len
    assert tc["ck"].shape[2] == e and np.abs(tc["ck"]).max() > 0


# -- (e) weights --------------------------------------------------------------------

def test_params_from_jax_audio_names():
    jc = jconfigs.get_smoke(ARCH)
    jm = JModel(jc, JMeshSpec(("data", "model"), (1, 1)), JQSDPConfig())
    jp = {k: np.asarray(v) for k, v in jm.init_params(jax.random.PRNGKey(4)).items()}
    tm = Model(configs.get_smoke(ARCH), MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
    tp = params_from_jax(jp, "cpu", tm)
    assert list(tp) == list(jp)
    assert {"lm_head", "enc_final_norm", "enc/wq", "enc/mlp_norm", "dec/xwq", "dec/xwo",
            "dec/xattn_norm", "dec/w_down"} <= set(tp)
    for k, v in jp.items():
        np.testing.assert_array_equal(tp[k].numpy(), v)
    with pytest.raises(ValueError, match="enc_final_norm"):
        params_from_jax({k: v for k, v in jp.items() if k != "enc_final_norm"}, "cpu", tm)
    bad = dict(jp, **{"dec/xwk": jp["dec/xwk"][:1]})
    with pytest.raises(ValueError, match="dec/xwk"):
        params_from_jax(bad, "cpu", tm)


def test_audio_specs_equal_reference():
    """The encoder-decoder groups in the reference's order, full and smoke;
    the untied lm_head; every flag of every spec."""
    for smoke in (True, False):
        jc = jconfigs.get_smoke(ARCH) if smoke else jconfigs.get_config(ARCH)
        tm = Model(configs.get_smoke(ARCH) if smoke else configs.get_config(ARCH),
                   MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
        jm = JModel(jc, JMeshSpec(("data", "model"), (1, 1)), JQSDPConfig())
        assert list(tm.specs) == list(jm.specs)
        for n, t in tm.specs.items():
            j = jm.specs[n]
            assert (t.shape, t.tp_axis, t.stack, t.init, t.init_scale, t.quantize) == \
                (j.shape, j.tp_axis, j.stack, j.init, j.init_scale, j.quantize), n
