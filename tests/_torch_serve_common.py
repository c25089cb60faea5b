"""Shared set-up of the continuous-serving comparison tests: the JAX
package's scheduler suite model (2 layers, d_model 64, vocab 256, 4 heads /
2 KV heads of 16, ring 32, KV block 8, chunk 4 with 3 buckets), its params
handed to the port through ``params_from_jax``, both schedulers over the
same gather key, and request mixes made from a seed with numpy.

f32 compute on both sides: the two frameworks round bf16 intermediates at
other places, and a greedy stream that forks on a near-tie would not test
the scheduler.  The KV cache is bf16 on both.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.models.decode import DecodeSpec as JDecodeSpec
from repro.models.transformer import Model as JModel
from repro.serve import ContinuousScheduler as JScheduler, Request as JRequest
from repro_torch.core import prng
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import DecodeSpec
from repro_torch.models.transformer import Model
from repro_torch.serve import ContinuousScheduler, Request
from repro_torch.weights import params_from_jax
import _torch_jax_cache  # noqa: F401  (each JAX program compiles once a run)

# thousands of small tensor ops per run: one intra-op thread runs them as
# fast as eight on an idle machine, and keeps them fast when the test
# workers share the cores (see tests/_torch_train_common.py)
torch.set_num_threads(1)

CFG = dict(name="sched", arch_type="dense", n_layers=2, d_model=64, vocab_size=256, n_heads=4,
           n_kv_heads=2, head_dim=16, d_ff=128)
RING, BLOCK, CHUNK, BUCKETS, GATHER_SEED = 32, 8, 4, 3, 7
MESH = jax.make_mesh((1, 1), ("data", "model"))
_models: dict = {}


# the reference's MoE scheduler-suite model (tests/test_serve_scheduler.py:
# 45-51: its experts have moe_d_ff 0, so they add nothing), and one whose
# experts compute
MOE_CFG = dict(arch_type="moe", n_experts=4, moe_top_k=2)
MOE_FF_CFG = dict(MOE_CFG, moe_d_ff=64)


def models(**cfg_kw):
    """((JAX model, params), (port model, params)), the same weights; `cfg_kw`
    overrides CFG's fields."""
    key = tuple(sorted(cfg_kw.items()))
    if key not in _models:
        jm = JModel(JModelConfig(**{**CFG, **cfg_kw}), JMeshSpec(("data", "model"), (1, 1)),
                    JQSDPConfig(min_quant_size=256, compute_dtype="float32"))
        jp = jm.init_params(jax.random.PRNGKey(0))
        tm = Model(ModelConfig(**{**CFG, **cfg_kw}), MeshSpec(("data", "model"), (1, 1)),
                   QSDPConfig(min_quant_size=256, compute_dtype="float32"))
        tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu", tm)
        _models[key] = ((jm, jp), (tm, tp))
    return _models[key]


def _host_block_ops(self):
    """The JAX engine's (extract, load, copy) of one block, on the host.
    JAX 0.9's sharding in types refuses the gather of the reference's
    ``ServeEngine.kv_block_ops`` on the engine's sharded cache
    (``ShardingTypeError`` at ``serve/engine.py:358``: its own test of this
    path fails for that reason); this is the same slicing, one rank."""
    bs = self.spec.kv_block_size
    bpr = self.spec.cache_len // bs

    def extract(cache, bid):
        row, s0 = divmod(int(bid), bpr)
        return (np.asarray(cache["k"])[:, row, s0 * bs:(s0 + 1) * bs],
                np.asarray(cache["v"])[:, row, s0 * bs:(s0 + 1) * bs])

    def load(cache, bid, kb, vb):
        row, s0 = divmod(int(bid), bpr)
        k, v = np.array(cache["k"]), np.array(cache["v"])
        k[:, row, s0 * bs:(s0 + 1) * bs] = np.asarray(kb).astype(k.dtype)
        v[:, row, s0 * bs:(s0 + 1) * bs] = np.asarray(vb).astype(v.dtype)
        return dict(cache, k=jnp.asarray(k), v=jnp.asarray(v))

    def copy(cache, src, dst):
        return load(cache, dst, *extract(cache, src))
    return extract, load, copy


def spec_kw(slots=3, paged=False, pool_blocks=0, draft_bits=0, draft_depth=0):
    """The DecodeSpec fields both packages' schedulers are built from."""
    return dict(cache_len=RING, batch_global=slots, batch_sharded=False, sampling=True,
                kv_block_size=BLOCK if paged else 0, kv_pool_blocks=pool_blocks,
                draft_bits=draft_bits, draft_depth=draft_depth)


def schedulers(slots=3, paged=False, pool_blocks=0, draft_bits=0, draft_depth=0,
               lane_block=0, cfg_kw=None, **kw):
    """(JAX scheduler, port scheduler) over the same spec and knobs;
    `lane_block` sets the port's launch blocks (0: the CPU's plain shapes);
    `cfg_kw` the model's fields that differ from CFG."""
    (jm, jp), (tm, tp) = models(**(cfg_kw or {}))
    skw = spec_kw(slots, paged, pool_blocks, draft_bits, draft_depth)
    js = JScheduler(jm, MESH, JDecodeSpec(**skw), jp,
                    gather_key=jax.random.PRNGKey(GATHER_SEED), **kw)
    if paged:
        js.engine.kv_block_ops = types.MethodType(_host_block_ops, js.engine)
    ts = ContinuousScheduler(tm, DecodeSpec(**skw, lane_block=lane_block), tp, "cpu",
                             gather_key=prng.PRNGKey(GATHER_SEED), **kw)
    return js, ts


def requests(plan, seed, prefix_len=BLOCK):
    """Request kwargs of a plan of (behind the shared prefix?, sampled?,
    prompt tokens after the prefix, new tokens)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, CFG["vocab_size"], size=prefix_len).tolist()
    out = []
    for i, (shared, sampled, n, gen) in enumerate(plan):
        out.append(dict(rid=f"r{i}", prompt=(prefix if shared else [])
                        + rng.integers(0, CFG["vocab_size"], size=n).tolist(),
                        max_new_tokens=gen, temperature=0.9 if sampled else 0.0,
                        top_k=7 if sampled else 0, seed=seed + i))
    return out


def run_both(js, ts, reqs):
    """Submit `reqs` to both schedulers and drain them: ({rid: JAX tokens},
    {rid: port tokens})."""
    for r in reqs:
        js.submit(JRequest(**r))
        ts.submit(Request(**r))
    with MESH:
        jd = js.run()
    td = ts.run()
    return ({r: c.tokens.tolist() for r, c in jd.items()},
            {r: c.tokens.tolist() for r, c in td.items()})
