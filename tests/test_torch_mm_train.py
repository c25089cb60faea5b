"""The pieces of VLM and audio training that the dense family does not run,
the port against the JAX package on the CPU, on the same inputs made from a
numpy seed:

  (a) ``cross_attention``'s VJP: the cotangents of the decoder input, the
      encoder output (memory) and the four projections, against ``jax.vjp``
      of the JAX function under ``shard_map`` on the (1, 1) mesh, f32 and
      bf16, GQA and plain, queries and keys of different lengths;
  (b) ``apply_rope`` with per-row M-RoPE tables (``mrope_cos_sin`` of
      (3, B, S) positions: a (B, S, hd/2) table a row), its VJP against
      ``jax.vjp`` of the JAX function;
  (c) ``weights.train_state_from_jax`` on the audio family's train state
      (``enc/``, ``dec/x*``, ``enc_final_norm``, the untied ``lm_head``),
      f32 and 8-bit moments: every leaf byte-equal.
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
from repro.optim import AdamWConfig as JAdamWConfig, make_adamw as jmake_adamw
from repro.train.checkpoint import _flatten as jflatten
from repro.train.step import init_train_state as jinit
from repro_torch.core.quant import QuantizedParam
from repro_torch.models import attention as tattn
from repro_torch.models import layers as L
from repro_torch.weights import train_state_from_jax

from _torch_train_common import models

torch.set_num_threads(1)
MESH = jax.make_mesh((1, 1), ("data", "model"))
# of each tensor's largest magnitude.  f32: the products and exp sum in
# other orders (<= 3.5e-7 measured); bf16: both packages round the
# projections and the probabilities to bf16 at other places (<= 4.7e-3
# measured, about one ulp, 2^-8 to 2^-7 relative): two ulps
REL_TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -6}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the same f32 tables on both sides: the rotation is the same arithmetic,
# products and sums of values up to ~5 (an ulp is 4.8e-7)
ROPE_ATOL = 1e-6


def _np(seed, *shape, s=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * s).astype(np.float32)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_heads,n_kv", [(8, 8), (8, 2)])
def test_cross_attention_vjp_matches_jax(dt, n_heads, n_kv):
    b, s, s_enc, d, hd = 2, 12, 8, 64, 16
    jdt, tdt = DTYPES[dt]
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=hd, tp=1)
    jc, tc = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    x, mem, ct = _np(0, b, s, d), _np(1, b, s_enc, d), _np(2, b, s, d)
    w = {"wq": _np(3, d, n_heads * hd, s=0.2), "wk": _np(4, d, n_kv * hd, s=0.2),
         "wv": _np(5, d, n_kv * hd, s=0.2), "wo": _np(6, n_heads * hd, d, s=0.2)}

    def jf(x, mem, w, ct):
        out, vjp = jax.vjp(lambda x, mem, w: jattn.cross_attention(x, mem, w, jc), x, mem, w)
        return out, vjp(ct)

    to_j = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    jout, (jdx, jdm, jdw) = jax.jit(shard_map(jf, mesh=MESH, in_specs=(P(),) * 4,
                                              out_specs=P(), check_vma=False))(
        to_j(x), to_j(mem), {k: to_j(v) for k, v in w.items()}, to_j(ct))

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tm = torch.from_numpy(mem).to(tdt).requires_grad_()
    tw = {k: torch.from_numpy(v).to(tdt).requires_grad_() for k, v in w.items()}
    out = tattn.cross_attention(tx, tm, tw, tc)
    out.backward(torch.from_numpy(ct).to(tdt))
    pairs = [(out, jout), (tx.grad, jdx), (tm.grad, jdm)] + [(tw[k].grad, jdw[k]) for k in w]
    for got, want in pairs:
        want = np.asarray(want.astype(jnp.float32))
        top = np.abs(want).max()
        assert top > 0
        err = np.abs(got.detach().float().numpy() - want).max()
        assert err <= REL_TOL[dt] * top, (err, top)


def test_apply_rope_mrope_vjp_matches_jax():
    b, s, h, hd, sections = 2, 10, 4, 32, (8, 4, 4)
    pos = np.random.default_rng(7).integers(0, 512, size=(3, b, s)).astype(np.int32)
    x, ct = _np(8, b, s, h, hd), _np(9, b, s, h, hd)
    # the port's tables on both sides (``test_torch_vlm.py`` holds them to
    # the JAX package's), so that the rotation and its VJP compare alone
    cos, sin = L.mrope_cos_sin(torch.from_numpy(pos), hd, 1e6, sections)
    assert tuple(cos.shape) == (b, s, hd // 2)

    def jf(x, cos, sin, ct):
        out, vjp = jax.vjp(lambda x: jlayers.apply_rope(x, cos, sin), x)
        return out, vjp(ct)[0]

    jout, jdx = jax.jit(jf)(*(jnp.asarray(a) for a in (x, cos.numpy(), sin.numpy(), ct)))
    tx = torch.from_numpy(x).requires_grad_()
    out = L.apply_rope(tx, cos, sin)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=ROPE_ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=0, atol=ROPE_ATOL)
    # each row rotates by its own table: a row's positions move its output only
    pos2 = pos.copy()
    pos2[:, 1] += 3
    c2, s2 = L.mrope_cos_sin(torch.from_numpy(pos2), hd, 1e6, sections)
    out2 = L.apply_rope(torch.from_numpy(x), c2, s2)
    assert torch.equal(out2[0], out.detach()[0]) and not torch.equal(out2[1], out.detach()[1])


def _leaf(v):
    """A leaf's bytes: a dense array's, or a QuantizedParam's wire codes."""
    v = getattr(v, "wire", v)
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v).tobytes()


@pytest.mark.parametrize("moment_bits", [None, 8])
def test_train_state_from_jax_audio_names(moment_bits):
    jm, tm = models(arch="seamless-m4t-large-v2")
    js = jinit(jm, jmake_adamw(JAdamWConfig(moment_bits=moment_bits)), jax.random.PRNGKey(0))
    ts = train_state_from_jax(*jflatten(js), device="cpu", model=tm)
    assert {"enc/wq", "enc/w_down", "enc_final_norm", "dec/xwq", "dec/xattn_norm",
            "lm_head"} <= set(ts.params)
    for jt, tt in ((js.params, ts.params), (js.opt.mu, ts.opt.mu), (js.opt.nu, ts.opt.nu)):
        assert sorted(jt) == sorted(tt) == sorted(tm.specs)
        for k in jt:
            assert _leaf(jt[k]) == _leaf(tt[k]), k
    assert all(isinstance(v, QuantizedParam) for v in ts.opt.mu.values()) == bool(moment_bits)
