"""VLM and audio serving as a whole, the port against the JAX package on the
CPU, on qwen2-vl's and seamless-m4t's smoke configs (the same weights
through ``weights.params_from_jax``, f32 compute, an unsharded batch):

  (a) the registry entries field-equal to the reference's, full and smoke,
      with their parameter counts, and the parameter specs in the
      reference's order;
  (b) ``ServeEngine.generate``, batch 2 x prompt 16 x 4 tokens (qwen2-vl's
      prompt with an image block, seamless's with the audio stub) at the
      reference's rowquant test config (min_quant 256, bucket 128, which
      makes the decode MLP rowquant-eligible): every gathered weight of
      every step byte-equal per tensor, the greedy tokens equal, the
      prefill's and every decode step's logits within LOGIT_ATOL_F32; the
      port's rowquant decode (the MLP through K3's plain version) gives the
      same tokens;
  (c) the blocking continuous scheduler against the JAX one (3 slots,
      greedy and sampled requests of three prompt lengths, the modality
      stubs from the batch builder): every stream and ``stats()`` equal;
  (d) the port's scheduler on the card's fixed-shape route (4 lanes a
      launch): every greedy request equal to its batch-of-1 solo run;
  (e) the reference's refusals: chunked admission, the paged pool,
      speculation, chunked prefill through ``generate``; the serve
      launcher at ``--smoke`` for both archs, batch and continuous.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.transformer import Model as JModel
from repro.serve import Request as JRequest
from repro.serve import build_serve_setup as jbuild
from repro.serve import make_scheduler as jmake_scheduler
import repro_torch.models.layers as tlayers
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.kernels import ops
from repro_torch.models.transformer import Model
from repro_torch.serve import (Request, ServeEngine, build_serve_setup, make_prompt_batch,
                               make_sample_params, make_scheduler)
from repro_torch.weights import params_from_jax

from _torch_mm_common import (ARCHS, GEN, LOGIT_ATOL_F32, RQ_QSDP, jax_run, port_run, prompts,
                              setups)

torch.set_num_threads(1)
SLOTS, PROMPT, GATHER_SEED = 3, 12, 7
# (sampled?, prompt tokens, new tokens): mixed lengths on 3 slots, so
# requests retire and admit mid-decode; two prompt lengths (the JAX
# scheduler compiles a prefill per length)
PLAN = [(False, 4, 4), (True, 8, 3), (False, 8, 6), (False, 4, 5), (True, 4, 2),
        (True, 8, 6), (False, 4, 3), (False, 8, 4)]
N_PARAMS = {"qwen2_vl_72b": 71_458_357_248, "seamless_m4t_large_v2": 2_034_659_328}


@pytest.mark.parametrize("name", ARCHS)
def test_mm_family_ported(name):
    for tget, jget in ((configs.get_config, jconfigs.get_config),
                       (configs.get_smoke, jconfigs.get_smoke)):
        t, j = tget(name.replace("_", "-")), jget(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.n_params() == j.n_params()
        tm = Model(t, MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
        jm = JModel(j, JMeshSpec(("data", "model"), (1, 1)), JQSDPConfig())
        assert list(tm.specs) == list(jm.specs)
        for n, ts in tm.specs.items():
            js = jm.specs[n]
            assert (ts.shape, ts.tp_axis, ts.stack, ts.init, ts.init_scale, ts.quantize) == \
                (js.shape, js.tp_axis, js.stack, js.init, js.init_scale, js.quantize), n
    assert configs.get_config(name).n_params() == N_PARAMS[name]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    mp = pytest.MonkeyPatch()
    js, ts = setups(request.param, qcfg_kw=RQ_QSDP)
    jb, jps, tb = prompts(js, ts)
    jr = jax_run(js, jb, jps, mp, prefill=False)
    tr = port_run(ts, tb, mp, prefill=False)
    _, trq = setups(request.param, qcfg_kw=RQ_QSDP, rowquant=True)
    trq.params = ts.params
    k3 = []
    orig = ops.rowquant_matmul

    def count(*a, **k):
        k3.append(tuple(a[1].shape))
        return orig(*a, **k)

    mp.setattr(tlayers, "rowquant_matmul", count)
    rq = trq.engine.generate(trq.params, tb, n_tokens=GEN, key=prng.PRNGKey(3)).numpy()
    mp.undo()
    return request.param, ts, jr, tr, rq, k3


def test_mm_generate_gathers_byte_equal(served):
    arch, ts, (_, _, jf, _, _), (_, _, tf, _, _), _, _ = served
    cfg = ts.cfg
    assert set(jf) == set(tf)
    for name, digests in jf.items():
        group = name.split("/")[0] if "/" in name else None
        # the prefill gathers every group once; each decode step the decoder
        # stack (audio: not the encoder) and the top-level tensors
        per_prefill = {"enc": cfg.n_enc_layers, None: 1}.get(group, cfg.n_layers)
        per_step = 0 if group == "enc" or name == "enc_final_norm" else per_prefill
        assert len(digests) == per_prefill + (GEN - 1) * per_step, name
        assert tf[name] == digests, name


def test_mm_generate_tokens_and_logits(served):
    arch, _, (jt, jl, _, _, _), (tt, tl, _, _, _), _, _ = served
    np.testing.assert_array_equal(tt, jt)
    assert len(jl) == len(tl) == GEN
    for j, (a, b) in enumerate(zip(jl, tl)):
        assert a.shape == b.shape, j
        np.testing.assert_allclose(b, a, rtol=0, atol=LOGIT_ATOL_F32, err_msg=f"step {j}")


def test_mm_rowquant_tokens_equal_dense(served):
    """The reference's ``test_serve_rowquant_decode_audio_hybrid`` for the
    port: K3's plain version takes the decode MLP (3 weights a layer a
    step), and the tokens equal the dense path's and the JAX engine's."""
    arch, ts, (jt, _, _, _, _), _, rq, k3 = served
    np.testing.assert_array_equal(rq, jt)
    d, ff = ts.cfg.d_model, ts.cfg.d_ff
    assert len(k3) == 3 * ts.cfg.n_layers * (GEN - 1)
    assert sorted(set(k3)) == sorted({(d, ff), (ff, d)})


def _requests(seed):
    rng = np.random.default_rng(seed)
    return [dict(rid=f"r{i}", prompt=rng.integers(0, 1024, size=n).tolist(), max_new_tokens=g,
                 temperature=0.9 if sampled else 0.0, top_k=7 if sampled else 0, seed=seed + i)
            for i, (sampled, n, g) in enumerate(PLAN)]


@pytest.fixture(scope="module")
def sched_setups():
    """arch -> (JAX setup, port setup on the JAX setup's weights), built once
    a module: the scheduler test and the solo-run test serve the same
    weights (neither writes a setup; each makes its own schedulers)."""
    made = {}

    def get(arch):
        if arch not in made:
            common = dict(smoke=True, batch=SLOTS, prompt_len=PROMPT, gen=6, sampling=True,
                          batch_sharded=False)
            js = jbuild(arch, qsdp=JQSDPConfig(compute_dtype="float32"), **common)
            ts = build_serve_setup(arch, qsdp=QSDPConfig(compute_dtype="float32"),
                                   device="cpu", **common)
            ts.params = params_from_jax({k: np.asarray(v) for k, v in js.params.items()},
                                        "cpu", ts.model)
            made[arch] = js, ts
        return made[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_mm_scheduler_matches_jax(arch, sched_setups):
    js, ts = sched_setups(arch)
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
    assert tst["prefills"] == len(reqs) and tst["sampled_launches"] > 0
    want = {"k", "v"} | ({"ck", "cv"} if arch == "seamless_m4t_large_v2" else set())
    assert set(tsched.cache) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_mm_requests_equal_solo_runs(arch, sched_setups):
    """On the fixed-shape route (4 lanes a launch, as on the card) every
    greedy request's stream equals its batch-of-1 solo run, whose prompt
    batch is the scheduler's (modality stubs included)."""
    _, ts = sched_setups(arch)
    spec = dataclasses.replace(ts.spec, lane_block=4)
    ts = dataclasses.replace(ts, spec=spec, engine=ServeEngine(ts.model, spec, "cpu"))
    key = prng.PRNGKey(GATHER_SEED)
    sched = make_scheduler(ts, gather_key=key)
    reqs = _requests(9)
    for r in reqs:
        sched.submit(Request(**r))
    out = {r: c.tokens.tolist() for r, c in sched.run().items()}
    spec1 = dataclasses.replace(spec, batch_global=1)
    solo = ServeEngine(ts.model, spec1, "cpu")
    greedy = [r for r in reqs if not r["temperature"]]
    assert len(greedy) == 5
    for r in greedy:
        prompt = make_prompt_batch(ts.cfg, spec1, ts.ms, [r["prompt"]], "cpu")
        ref = solo.generate(ts.params, prompt, r["max_new_tokens"], key=key,
                            fold_step_keys=False, sample=make_sample_params())[0].tolist()
        assert out[r["rid"]] == ref, r["rid"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mm_refusals_follow_the_reference(arch, sched_setups):
    js, ts = sched_setups(arch)
    for make, setup in ((jmake_scheduler, js), (make_scheduler, ts)):
        with pytest.raises(ValueError, match="prefill_chunk requires"):
            make(setup, prefill_chunk=4)
    for build in (jbuild, build_serve_setup):
        kw = {} if build is jbuild else {"device": "cpu"}
        with pytest.raises(ValueError, match="speculative decode"):
            build(arch, smoke=True, batch=2, prompt_len=8, gen=4, draft_bits=4,
                  draft_depth=3, **kw)
        with pytest.raises(ValueError, match="paged KV"):
            build(arch, smoke=True, batch=2, prompt_len=8, gen=4, kv_block_size=4, **kw)
    batch = make_prompt_batch(ts.cfg, ts.spec, ts.ms, np.zeros((1, 8), np.int64), "cpu")
    with pytest.raises(NotImplementedError, match="chunked prefill supports"):
        ts.engine.generate(ts.params, batch, 2, fold_step_keys=False, prefill_chunk=4)


@pytest.mark.parametrize("flags", [[], ["--continuous", "--requests", "4", "--temperature",
                                        "0.8", "--top-k", "40"]])
@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "seamless-m4t-large-v2"])
def test_serve_launcher_mm(arch, flags, capsys):
    from repro_torch.launch import serve as launch_serve
    rc = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                            "--prompt-len", "8", "--gen", "4", *flags])
    out = capsys.readouterr().out
    assert rc == 0 and arch.split("-")[0] + "-" in out and "sample:" in out
    if flags:
        assert "4 requests" in out


def test_expected_mm_launches_at_the_full_configs():
    """``chip_smoke.py``'s vlmaudio launch formula at the configs it serves
    (qwen2-vl-72b cut to 2 layers, seamless-m4t-large-v2 to 3 decoder and
    3 encoder layers) equals its hand count: rowquant takes qwen2-vl's
    w_down only (w_gate/w_up's 29,568 columns are 28.875 buckets) and all of
    seamless's decoder MLP."""
    from test_torch_continuous import _chip_smoke
    cs = _chip_smoke()
    for arch in cs.MM_ARCHS:
        cfg = cs.mm_config(arch)
        assert cfg.n_layers == (2 if arch == "qwen2-vl-72b" else 3)
        assert cfg.arch_type != "audio" or cfg.n_enc_layers == 3
        model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
        for rowquant in (False, True):
            got = cs.expected_mm_launches(model, rowquant)
            assert got == cs.expected_serve_launches(model, rowquant)
            assert got == cs.SERVE_PER_STEP[arch, rowquant]
