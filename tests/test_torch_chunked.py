"""Chunked prefill and paged decode of the port against the JAX package, on
the CPU, launch by launch.

The scheduler suite's model (2 layers, d_model 64, vocab 256, 4 heads / 2
KV heads of 16), f32 compute, weights through ``params_from_jax``, one
gather key.  The same sequence of pooled launches runs through the JAX
engine's jitted steps and the port's: two chunk launches over three lanes
(chunks at different offsets, one lane idle in each), then three decode
steps with one lane sampled, over private rings and over the paged pool
with a permuted block table.  Held per launch:

  * tokens equal on every live lane;
  * logits within LOGIT_ATOL (f32; the frameworks sum in other orders);
  * the KV written at exactly the same places (no write for padded chunk
    tokens, idle lanes or dead lanes), with values within KV_ATOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.models.decode import DecodeSpec as JDecodeSpec
from repro.models.transformer import Model as JModel
from repro.serve import ServeEngine as JServeEngine
import repro_torch.models.layers as tlayers
from repro_torch.core import prng
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import DecodeSpec
from repro_torch.models.transformer import Model
from repro_torch.serve import ServeEngine, make_sample_params
from repro_torch.weights import params_from_jax

CFG = dict(name="chunk", arch_type="dense", n_layers=2, d_model=64, vocab_size=256, n_heads=4,
           n_kv_heads=2, head_dim=16, d_ff=128)
RING, BLOCK, LANES, KEY = 32, 8, 3, 7
LOGIT_ATOL = 1e-4  # f32 compute, logits of magnitude ~1: summation order only
KV_ATOL = 2e-2     # bf16 KV: an f32 ulp upstream can flip a bf16 rounding
# (tokens (LANES, L), offset, n_valid) of the chunk launches; then decode
CHUNKS = [([[11, 12, 13, 14], [21, 22, 23, 0], [0, 0, 0, 0]], [0, 0, 0], [4, 3, 0]),
          ([[15, 16, 0], [0, 0, 0], [31, 32, 33]], [4, 0, 0], [2, 0, 3])]
DECODE_POS = [[6, 3, 3], [7, 4, 4], [8, -1, 5]]  # lane 1 retires after two steps
TEMP, TOP_K, SEEDS = [0.0, 0.9, 0.0], [0, 5, 0], [0, 3, 0]
BLOCK_TABLE = [[5, 2, -1, -1], [0, -1, -1, -1], [7, -1, -1, -1]]


def _capture(mod, store):
    orig = mod.vocab_parallel_logits

    def f(h, w):
        out = orig(h, w)
        if isinstance(out, torch.Tensor):
            store.append(out.numpy().copy())
        else:
            jax.debug.callback(lambda v: store.append(np.asarray(v)), out)
        return out
    return f


def _jax_run(paged, monkeypatch, np_params=None):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    model = JModel(JModelConfig(**CFG), JMeshSpec(("data", "model"), (1, 1)),
                   JQSDPConfig(min_quant_size=256, compute_dtype="float32"))
    params = model.init_params(jax.random.PRNGKey(0))
    spec = JDecodeSpec(cache_len=RING, batch_global=LANES, batch_sharded=False, sampling=True,
                       kv_block_size=BLOCK if paged else 0)
    eng = JServeEngine(model, mesh, spec)
    logits, toks, caches = [], [], []
    monkeypatch.setattr(jlayers, "vocab_parallel_logits", _capture(jlayers, logits))
    sample = {"temp": jnp.asarray(TEMP, jnp.float32), "top_k": jnp.asarray(TOP_K, jnp.int32),
              "key": jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])}
    bt = (jnp.asarray(BLOCK_TABLE, jnp.int32),) if paged else ()
    key = jax.random.PRNGKey(KEY)
    with mesh:
        cache = eng.init_cache()
        for tokens, offset, n_valid in CHUNKS:
            tok = jnp.asarray(tokens, jnp.int32)
            nxt, cache = eng.prefill_chunk_step(tok.shape[1])(
                params, cache, tok, jnp.asarray(offset, jnp.int32),
                jnp.asarray(n_valid, jnp.int32), *bt, key, sample)
            toks.append(np.asarray(nxt))
            caches.append({k: np.asarray(v.astype(jnp.float32)) for k, v in cache.items()})
        for pos in DECODE_POS:
            nxt, cache = eng.decode_step()(params, cache, jnp.asarray(toks[-1]),
                                           jnp.asarray(pos, jnp.int32), *bt, key, sample)
            toks.append(np.asarray(nxt))
            caches.append({k: np.asarray(v.astype(jnp.float32)) for k, v in cache.items()})
    monkeypatch.undo()
    return toks, logits, caches, {k: np.asarray(v) for k, v in params.items()}


def _port_run(paged, np_params, monkeypatch, jax_tokens):
    model = Model(ModelConfig(**CFG), MeshSpec(("data", "model"), (1, 1)),
                  QSDPConfig(min_quant_size=256, compute_dtype="float32"))
    params = params_from_jax(np_params, "cpu", model)
    spec = DecodeSpec(cache_len=RING, batch_global=LANES, batch_sharded=False, sampling=True,
                      kv_block_size=BLOCK if paged else 0)
    eng = ServeEngine(model, spec, "cpu")
    logits, toks, caches = [], [], []
    monkeypatch.setattr(tlayers, "vocab_parallel_logits", _capture(tlayers, logits))
    sample = {k: torch.cat([make_sample_params(t, k_, s)[k] for t, k_, s in
                            zip(TEMP, TOP_K, SEEDS)]) for k in ("temp", "top_k", "key")}
    bt = torch.tensor(BLOCK_TABLE) if paged else None
    key = prng.PRNGKey(KEY)
    cache = eng.init_cache()
    with torch.inference_mode():
        for tokens, offset, n_valid in CHUNKS:
            nxt, cache = eng.prefill_chunk_step(len(tokens[0]))(
                params, cache, torch.tensor(tokens), torch.tensor(offset),
                torch.tensor(n_valid), key, sample, block_tables=bt)
            toks.append(nxt.numpy())
            caches.append({k: v.float().numpy().copy() for k, v in cache.items()})
        for i, pos in enumerate(DECODE_POS):  # fed the reference's tokens
            nxt, cache = eng.decode_step()(params, cache, torch.from_numpy(
                jax_tokens[len(CHUNKS) - 1 + i].astype(np.int64)), torch.tensor(pos), key,
                sample, block_tables=bt)
            toks.append(nxt.numpy())
            caches.append({k: v.float().numpy().copy() for k, v in cache.items()})
    monkeypatch.undo()
    return toks, logits, caches


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_chunk_and_decode_launches_match_jax(paged, monkeypatch):
    jt, jl, jc, np_params = _jax_run(paged, monkeypatch)
    tt, tl, tc = _port_run(paged, np_params, monkeypatch, jt)
    assert len(jl) == len(tl) == len(CHUNKS) + len(DECODE_POS)
    live = [np.asarray(n) > 0 for _, _, n in CHUNKS] + [np.asarray(p) >= 0 for p in DECODE_POS]
    for i, (a, b, keep) in enumerate(zip(jl, tl, live)):
        np.testing.assert_allclose(b[keep], a[keep], rtol=0, atol=LOGIT_ATOL, err_msg=f"launch {i}")
        np.testing.assert_array_equal(tt[i][keep], jt[i][keep], err_msg=f"launch {i}")
        for name in ("k", "v"):
            assert ((jc[i][name] != 0) == (tc[i][name] != 0)).all(), (i, name)
            np.testing.assert_allclose(tc[i][name], jc[i][name], rtol=0, atol=KV_ATOL)
    # the sampled lane really sampled: its stream is not the greedy argmax
    assert any(t[1] != np.argmax(lg[1]) for t, lg in zip(tt[len(CHUNKS):-1], tl[len(CHUNKS):-1]))


def test_chunk_tokens_independent_of_compute_len():
    """A chunk's valid tokens and KV do not depend on the width it is padded
    to (the port pads to the top bucket; XLA shares the property)."""
    model = Model(ModelConfig(**CFG), MeshSpec(("data", "model"), (1, 1)),
                  QSDPConfig(min_quant_size=256))
    params = model.init_params(0, "cpu")
    spec = DecodeSpec(cache_len=RING, batch_global=LANES, batch_sharded=False,
                      kv_block_size=BLOCK)
    eng = ServeEngine(model, spec, "cpu")
    out = []
    for width in (4, 8, 16):
        cache = eng.init_cache()
        tokens, offset, n_valid = CHUNKS[0]
        nxt, cache = eng.prefill_chunk_step(width)(
            params, cache, torch.tensor(tokens), torch.tensor(offset), torch.tensor(n_valid),
            prng.PRNGKey(KEY), block_tables=torch.tensor(BLOCK_TABLE))
        out.append((nxt[:2], cache["k"].clone()))
    for nxt, k in out[1:]:
        assert torch.equal(nxt, out[0][0])
        assert torch.equal(k.view(torch.int16), out[0][1].view(torch.int16))
