"""The port's ContinuousScheduler against the JAX package's on the CPU for
the SSM and hybrid families: the mamba2-370m and zamba2-7b smoke configs
through both packages' ``build_serve_setup`` -> ``make_scheduler`` with
blocking admission (the reference's only admission for these families), 3
slots, an unsharded batch (the reference's ``_splice_slot`` refuses the
sharded one under JAX 0.9, ROADMAP C3), f32 compute, the same weights
(``params_from_jax``) and gather key.  Greedy and sampled requests mixed:
every request gets the same tokens and ``stats()`` agree (the port adds
``sampled_launches``).  Then the refusals the reference makes for these
families, with its exception types: chunked admission, a paged spec, a
speculative spec, and chunked prefill through ``generate``."""
import jax
import numpy as np
import pytest
import torch

from repro.core.qsdp import QSDPConfig as JQSDPConfig
from repro.serve import Request as JRequest
from repro.serve import build_serve_setup as jbuild
from repro.serve import make_scheduler as jmake_scheduler
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.serve import Request, build_serve_setup, make_scheduler
from repro_torch.weights import params_from_jax

torch.set_num_threads(1)
ARCHS = ["mamba2_370m", "zamba2_7b"]
SLOTS, PROMPT, GEN, GATHER_SEED = 3, 12, 6, 7
# (sampled?, prompt tokens, new tokens): mixed lengths on 3 slots, so
# requests retire and admit mid-decode; 3 tokens is the shortest prompt the
# conv state takes (ROADMAP C7).  Three prompt lengths: the JAX scheduler
# compiles a prefill per length
PLAN = [(False, 3, 4), (True, 6, 3), (False, 9, 6), (False, 9, 5), (True, 3, 2),
        (True, 6, 6), (False, 3, 3), (False, 6, 4)]


def _setups(arch, **kw):
    """(JAX setup, port setup) of the smoke config, the same weights."""
    common = dict(smoke=True, batch=SLOTS, prompt_len=PROMPT, gen=GEN, sampling=True,
                  batch_sharded=False, **kw)
    js = jbuild(arch, qsdp=JQSDPConfig(compute_dtype="float32"), **common)
    ts = build_serve_setup(arch, qsdp=QSDPConfig(compute_dtype="float32"), device="cpu",
                           **common)
    ts.params = params_from_jax({k: np.asarray(v) for k, v in js.params.items()}, "cpu",
                                ts.model)
    return js, ts


def _requests(seed):
    rng = np.random.default_rng(seed)
    return [dict(rid=f"r{i}", prompt=rng.integers(0, 1024, size=n).tolist(), max_new_tokens=g,
                 temperature=0.9 if sampled else 0.0, top_k=7 if sampled else 0, seed=seed + i)
            for i, (sampled, n, g) in enumerate(PLAN)]


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_scheduler_matches_jax(arch):
    js, ts = _setups(arch)
    jsched = jmake_scheduler(js, gather_key=jax.random.PRNGKey(GATHER_SEED))
    tsched = make_scheduler(ts, gather_key=prng.PRNGKey(GATHER_SEED))
    reqs = _requests(5)
    for r in reqs:
        jsched.submit(JRequest(**r))
        tsched.submit(Request(**r))
    with js.mesh:
        jd = {r: c.tokens.tolist() for r, c in jsched.run().items()}
    td = {r: c.tokens.tolist() for r, c in tsched.run().items()}
    assert set(jd) == set(td) == {r["rid"] for r in reqs}
    for r in reqs:
        assert len(td[r["rid"]]) == r["max_new_tokens"]
        assert td[r["rid"]] == jd[r["rid"]], r["rid"]
    jst, tst = jsched.stats(), tsched.stats()
    assert {k: tst[k] for k in jst} == jst
    assert tst["prefills"] == len(reqs) and tst["prefill_chunks"] == 0
    assert tst["sampled_launches"] > 0 and tst["decode_steps"] > 0
    # the pool's state leaves are spliced per lane like the KV rings
    want = {"conv", "ssm"} | ({"shared_k", "shared_v"} if arch == "zamba2_7b" else set())
    assert set(tsched.cache) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_refusals_follow_the_reference(arch):
    js, ts = _setups(arch)
    for make, setup in ((jmake_scheduler, js), (make_scheduler, ts)):
        with pytest.raises(ValueError, match="prefill_chunk requires"):
            make(setup, prefill_chunk=4)
    for build in (jbuild, build_serve_setup):
        kw = {} if build is jbuild else {"device": "cpu"}
        with pytest.raises(ValueError, match="speculative decode"):
            build(arch, smoke=True, batch=2, prompt_len=8, gen=4, draft_bits=4,
                  draft_depth=3, **kw)
        if arch == "zamba2_7b":
            with pytest.raises(ValueError, match="paged KV"):
                build(arch, smoke=True, batch=2, prompt_len=8, gen=4, kv_block_size=4, **kw)
        else:  # no KV ring: a block size gives no paged spec, in both packages
            assert not build(arch, smoke=True, batch=2, prompt_len=8, gen=4,
                             kv_block_size=4, **kw).spec.paged
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="chunked prefill supports"):
        ts.engine.generate(ts.params, {"tokens": tokens}, 2, fold_step_keys=False,
                           prefill_chunk=4)
