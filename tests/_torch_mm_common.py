"""Shared set-up of the VLM and audio comparison tests: the qwen2-vl-72b and
seamless-m4t-large-v2 smoke configs through both packages'
``build_serve_setup`` (an unsharded batch, the same weights through
``weights.params_from_jax``, the same key), with test-side hooks that
capture every gathered weight (a digest of its bytes in the compute dtype)
and every set of logits: in the JAX package through ``jax.debug.callback``
(no JAX file changes), in the port by wrapping the same functions.

The VLM prompt carries an image block (random patch embeddings, rounded to
bf16 on the host, spliced where ``vision_mask`` is set, with Qwen2-VL's
(t, h, w) M-RoPE positions); the audio prompt carries each package's own
stub (``make_prompt_batch``), byte-equal between the two
(``test_torch_audio.py``)."""
import hashlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

import repro.models.layers as jlayers
from repro.core.qsdp import QSDPConfig as JQSDPConfig
from repro.serve.common import build_serve_setup as jbuild
from repro.serve.common import make_prompt_batch as jprompt
import repro_torch.models.layers as tlayers
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.serve import build_serve_setup, make_prompt_batch
from repro_torch.weights import params_from_jax
import _torch_jax_cache  # noqa: F401  (each JAX program compiles once a run)

# thousands of small tensor ops a run: one intra-op thread keeps them fast
# when the test workers share the cores (see tests/_torch_train_common.py)
torch.set_num_threads(1)

ARCHS = ["qwen2_vl_72b", "seamless_m4t_large_v2"]
B, S, GEN, KEY = 2, 16, 4, 3
# the image block of the VLM prompt: a 2 x 4 patch grid at positions 4-11
IMAGE = dict(start=4, rows=2, cols=4)
# the reference's rowquant test config (tests/test_kernel_dispatch.py:206):
# buckets of 128 tile the smoke MLP's rows, so rowquant decode runs K3
RQ_QSDP = dict(min_quant_size=256, bucket_size=128)
# f32 compute: summation order and the libm of exp/rsqrt, ~1e-6 on logits
# of magnitude ~1 at the prefill; each decode step also writes its k/v into
# the bf16 ring, and an entry the two packages' f32 sums round to
# neighbouring bf16 values (one ulp, 2^-8 relative) moves the later steps'
# logits: measured up to 1.5e-4 over 10 decode steps of these configs
# (tests/test_torch_serve.py's gpt smoke config stays within 1e-4)
LOGIT_ATOL_F32 = 2e-4


def digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return hashlib.sha256(a.tobytes() + str(a.dtype).encode() + str(a.shape).encode()).hexdigest()


def tokens(seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, 1024, size=(b, s)).astype(np.int64)


def image_block(d_model, b=B, s=S, seed=11, start=IMAGE["start"], rows=IMAGE["rows"],
                cols=IMAGE["cols"]):
    """(vision_embeds (b, s, d) f32 values exact in bf16, vision_mask (b, s),
    positions (3, b, s)) of one image block: Qwen2-VL's t = start, h = start
    + row, w = start + col, the text after it from start + max(rows, cols)."""
    n = rows * cols
    end = start + n
    emb = np.zeros((b, s, d_model), np.float32)
    rng = np.random.default_rng(seed)
    emb[:, start:end] = (rng.standard_normal((b, n, d_model)) * 0.02).astype(
        ml_dtypes.bfloat16).astype(np.float32)
    mask = np.zeros((b, s), bool)
    mask[:, start:end] = True
    pos = np.tile(np.arange(s), (3, 1))
    k = np.arange(n)
    pos[0, start:end] = start
    pos[1, start:end] = start + k // cols
    pos[2, start:end] = start + k % cols
    pos[:, end:] = np.arange(s - end) + start + max(rows, cols)
    return emb, mask, np.broadcast_to(pos[:, None], (3, b, s)).copy()


def setups(arch, qcfg_kw=None, rowquant=False, **kw):
    """(JAX setup, port setup) of `arch`'s smoke config, f32 compute, the same
    weights."""
    qcfg_kw = {"compute_dtype": "float32", **(qcfg_kw or {})}
    common = dict(smoke=True, batch=B, prompt_len=S, gen=GEN, batch_sharded=False,
                  rowquant_mlp=rowquant, **kw)
    js = jbuild(arch, qsdp=JQSDPConfig(**qcfg_kw), **common)
    ts = build_serve_setup(arch, qsdp=QSDPConfig(**qcfg_kw), device="cpu", **common)
    ts.params = params_from_jax({k: np.asarray(v) for k, v in js.params.items()}, "cpu",
                                ts.model)
    return js, ts


def prompts(js, ts, image=True):
    """(JAX batch, its pspecs, port batch): tokens, and the VLM image block or
    each package's audio stub."""
    toks = tokens()
    jb, jps = jprompt(js.cfg, js.spec, js.ms, toks)
    tb = make_prompt_batch(ts.cfg, ts.spec, ts.ms, toks, "cpu")
    if js.cfg.arch_type == "vlm" and image:
        emb, mask, pos = image_block(js.cfg.d_model)
        jb.update(vision_embeds=jnp.asarray(emb, jnp.bfloat16), vision_mask=jnp.asarray(mask),
                  positions=jnp.asarray(pos, jnp.int32))
        tb.update(vision_embeds=torch.from_numpy(emb).to(torch.bfloat16),
                  vision_mask=torch.from_numpy(mask), positions=torch.from_numpy(pos))
    return jb, jps, tb


def jax_run(js, jb, jps, monkeypatch, gen=GEN, prefill=True):
    """The JAX engine's generate (gen > 0) and a prefill, hooked: (tokens,
    logits per step, {name: sorted digests of gathered weights}, prefill
    cache as f32 numpy, the prefill's next tokens)."""
    model = js.model
    logits, fulls = [], {}
    orig_logits, orig_full = jlayers.vocab_parallel_logits, model.engine._reshape_full

    def hook_logits(h, w):
        out = orig_logits(h, w)
        jax.debug.callback(lambda v: logits.append(np.asarray(v)), out)
        return out

    def hook_full(name, full):
        n = model.specs[name].n_logical_local(1)
        jax.debug.callback(lambda v, name=name: fulls.setdefault(name, []).append(
            digest(v)), full[:n].astype(model.engine.compute_dtype))
        return orig_full(name, full)

    monkeypatch.setattr(jlayers, "vocab_parallel_logits", hook_logits)
    monkeypatch.setattr(model.engine, "_reshape_full", hook_full)
    out = cache = nxt = None
    with js.mesh:
        if gen:
            out = np.asarray(jax.device_get(js.engine.generate(
                js.params, jb, jps, n_tokens=gen, key=jax.random.PRNGKey(KEY))))
        if prefill:
            nxt, cache = js.engine.prefill_step(jps)(js.params, jb, jax.random.PRNGKey(KEY))
            nxt = np.asarray(nxt)
            cache = {k: np.asarray(jax.device_get(v).astype(jnp.float32))
                     for k, v in cache.items()}
    jax.effects_barrier()
    monkeypatch.undo()
    return out, logits, {k: sorted(v) for k, v in fulls.items()}, cache, nxt


def port_run(ts, tb, monkeypatch, gen=GEN, prefill=True):
    """:func:`jax_run` for the port's engine, the same hooks."""
    model = ts.model
    logits, fulls = [], {}
    orig_logits, orig_full = tlayers.vocab_parallel_logits, model.engine._reshape_full

    def hook_logits(h, w):
        out = orig_logits(h, w)
        logits.append(out.numpy())
        return out

    def hook_full(name, full):
        n = model.specs[name].n_logical_local(1)
        w = full[:n].to(model.engine.compute_dtype)
        fulls.setdefault(name, []).append(digest(
            w.view(torch.int16).numpy().view(np.uint16) if w.dtype == torch.bfloat16
            else w.numpy()))
        return orig_full(name, full)

    monkeypatch.setattr(tlayers, "vocab_parallel_logits", hook_logits)
    monkeypatch.setattr(model.engine, "_reshape_full", hook_full)
    out = cache = nxt = None
    if gen:
        out = ts.engine.generate(ts.params, tb, n_tokens=gen, key=prng.PRNGKey(KEY)).numpy()
    if prefill:
        nxt, cache = ts.engine.prefill_step()(ts.params, tb, prng.PRNGKey(KEY))
        nxt = nxt.numpy()
        cache = {k: v.float().numpy() for k, v in cache.items()}
    monkeypatch.undo()
    return out, logits, {k: sorted(v) for k, v in fulls.items()}, cache, nxt

