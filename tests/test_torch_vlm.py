"""The VLM family (qwen2-vl: the dense stack with M-RoPE and spliced vision
embeddings) of the port against the JAX package on the CPU:

  (a) ``mrope_cos_sin`` for the smoke config's sections (8, 4, 4) and the
      full config's (16, 24, 24) at head_dim 32 / 128, positions up to 4096
      in three different streams: within MROPE_ATOL (the two libms' cos and
      sin, and XLA's pow against torch's, a few f32 ulps); and the decode
      path's identity: M-RoPE at one position broadcast to all three streams
      is 1-D RoPE bit for bit;
  (b) the vision splice: ``vision_embeds`` replace the token embeddings
      exactly where ``vision_mask`` is set (embeddings outside the mask do
      not reach the model);
  (c) qwen2-vl's smoke config through both packages' ``build_serve_setup``
      -> prefill on a prompt with a 2 x 4 image block (Qwen2-VL's (t, h, w)
      positions, per-row cos/sin tables through ``self_attention`` and the
      flash chunks), default QSDPConfig at f32 compute: every gathered
      weight byte-equal, the next tokens equal, the logits within
      LOGIT_ATOL_F32, the KV caches within one bf16 ulp and mostly
      byte-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
from repro_torch.core import prng
from repro_torch.models import layers as L

from _torch_mm_common import LOGIT_ATOL_F32, jax_run, port_run, prompts, setups

torch.set_num_threads(1)
ARCH = "qwen2_vl_72b"
MROPE_ATOL = 1e-6
# bf16 caches at f32 compute (see test_torch_audio.py): one bf16 ulp, or
# the f32 difference near zero; most entries byte-equal
CACHE_ULP, CACHE_ATOL, CACHE_EQUAL_SHARE = 2.0 ** -7, 1e-5, 0.98


@pytest.mark.parametrize("head_dim,sections", [(32, (8, 4, 4)), (128, (16, 24, 24))])
def test_mrope_cos_sin_matches_jax(head_dim, sections):
    pos = np.random.default_rng(head_dim).integers(0, 4096, size=(3, 2, 9))
    jc, js = jlayers.mrope_cos_sin(jnp.asarray(pos, jnp.int32), head_dim, 1e6, sections)
    tc, ts = L.mrope_cos_sin(torch.from_numpy(pos), head_dim, 1e6, sections)
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (2, 9, head_dim // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=MROPE_ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=MROPE_ATOL)
    # each section rotates with its own stream
    one = pos.copy()
    one[2] += 1
    tc2, _ = L.mrope_cos_sin(torch.from_numpy(one), head_dim, 1e6, sections)
    moved = (tc2 != tc).any(dim=(0, 1))
    assert not moved[:sum(sections[:2])].any() and moved[sum(sections[:2]):].any()
    with pytest.raises(ValueError, match="sections"):
        L.mrope_cos_sin(torch.from_numpy(pos), head_dim + 2, 1e6, sections)


@pytest.mark.parametrize("head_dim,sections", [(32, (8, 4, 4)), (128, (16, 24, 24))])
def test_mrope_broadcast_is_1d_rope(head_dim, sections):
    """The reference's decode rotation (``_decode_rope``): the slot's
    position in all three streams gives 1-D RoPE's tables bit for bit."""
    pos = torch.tensor([0, 5, 127, 4000])
    mc, ms = L.mrope_cos_sin(pos.expand(3, 4), head_dim, 1e6, sections)
    rc, rs = L.rope_cos_sin(pos, head_dim, 1e6)
    assert torch.equal(mc, rc) and torch.equal(ms, rs)


@pytest.fixture(scope="module")
def prefill():
    mp = pytest.MonkeyPatch()
    js, ts = setups(ARCH)
    jb, jps, tb = prompts(js, ts)
    return jax_run(js, jb, jps, mp, gen=0), port_run(ts, tb, mp, gen=0), ts, tb


def test_vision_splice(prefill):
    """Prefill's first-layer input is the embedding with ``vision_embeds``
    where the mask is set: moving the embeddings outside the mask changes
    nothing, inside it changes the logits; the zero stub of
    ``make_prompt_batch`` leaves the text prompt's embeddings."""
    _, _, ts, tb = prefill
    step = ts.engine.prefill_step()
    orig = L.vocab_parallel_logits

    def logits(batch):
        out = []

        def hook(h, w):
            out.append(orig(h, w))
            return out[-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(L, "vocab_parallel_logits", hook)
            step(ts.params, batch, prng.PRNGKey(3))
        return out[0]

    base = logits(tb)
    outside = dict(tb, vision_embeds=torch.where(tb["vision_mask"][..., None],
                                                 tb["vision_embeds"], 0.5))
    assert torch.equal(logits(outside), base)
    inside = dict(tb, vision_embeds=tb["vision_embeds"] * 2)
    assert not torch.equal(logits(inside), base)
    # mask off: the image embeddings are ignored, the result is the text's
    text = dict(tb, vision_mask=torch.zeros_like(tb["vision_mask"]))
    zeros = dict(text, vision_embeds=torch.zeros_like(tb["vision_embeds"]))
    assert torch.equal(logits(text), logits(zeros))


def test_vlm_prefill_gathers_byte_equal(prefill):
    (_, _, jf, _, _), (_, _, tf, _, _), ts, _ = prefill
    assert set(jf) == set(tf)
    assert {"embed", "layers/wq", "layers/wk", "layers/wv", "layers/wo", "layers/bq",
            "layers/w_gate", "layers/w_down", "layers/attn_norm"} <= set(tf)
    for name, digests in jf.items():
        assert len(digests) == (ts.cfg.n_layers if name.startswith("layers/") else 1), name
        assert tf[name] == digests, name


def test_vlm_prefill_tokens_logits_caches(prefill):
    (_, jl, _, jc, jn), (_, tl, _, tc, tn), _, _ = prefill
    np.testing.assert_array_equal(tn, jn)
    assert len(jl) == len(tl) == 1
    np.testing.assert_allclose(tl[0], jl[0], rtol=0, atol=LOGIT_ATOL_F32)
    assert set(jc) == set(tc) == {"k", "v"}
    for k in jc:
        t = tc[k][:, :jc[k].shape[1]]
        assert t.shape == jc[k].shape, k
        np.testing.assert_allclose(t, jc[k], rtol=CACHE_ULP, atol=CACHE_ATOL, err_msg=k)
        assert (t == jc[k]).mean() >= CACHE_EQUAL_SHARE, k
