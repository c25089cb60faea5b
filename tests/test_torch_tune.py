"""The port's deployment-plan autotuner (``repro_torch.tune``) against the
JAX package's ``repro.tune`` on the CPU: the candidate space in the same
order, the searches' rankings, the wire-byte accounting at any FSDP size,
every cost-model function ``==`` to the reference's on the (1, 1) mesh
under ``cpu-smoke`` (the same floats: the same arithmetic in the same
order), and the plan's JSON byte for byte."""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.core import collectives as jcoll
from repro.core import qsdp as jqsdp
from repro.core.quant import QuantConfig as JQuantConfig
from repro.models.transformer import Model as JModel
from repro.tune import cost_model as jcm
from repro.tune import plan as jplan
from repro.tune import search as jsearch
from repro.tune import space as jspace
from repro_torch import configs
from repro_torch.core import collectives as coll
from repro_torch.core import qsdp
from repro_torch.core.quant import QuantConfig
from repro_torch.models.transformer import Model
from repro_torch.roofline import HW_H100, Hardware
from repro_torch.tune import cost_model as cm
from repro_torch.tune import plan as tplan
from repro_torch.tune import search, space

ARCHS = ("gpt-125m", "olmoe-1b-7b", "zamba2-7b")
# coalesce off, on, and a threshold between the smallest and largest group
POLICIES = ("per-tensor", "coalesced", "mid")


def _as_dicts(cands):
    return [dataclasses.asdict(c) for c in cands]


@pytest.mark.parametrize("full_space", [False, True])
@pytest.mark.parametrize("thresholds", [(None,), (None, 4096)])
def test_enumerate_space_matches_reference(full_space, thresholds):
    base = dict(slots=4, prefill_chunk=8, prefill_buckets=2)
    got = list(space.enumerate_space(thresholds=thresholds, full_space=full_space,
                                     base=space.Candidate(**base)))
    want = list(jspace.enumerate_space(thresholds=thresholds, full_space=full_space,
                                       base=jspace.Candidate(**base)))
    assert _as_dicts(got) == _as_dicts(want)
    assert [c.label() for c in got] == [c.label() for c in want]
    assert all(c.valid() for c in got)


def test_candidate_validity_and_prefetch_refusal():
    """The validity rule (prefetch needs coalescing) as the reference's; a
    prefetch candidate builds the port's config, every field the
    reference's ``to_qsdp`` sets equal."""
    from repro.core.qsdp import QSDPConfig as JQSDPConfig
    for kw in (dict(prefetch=True, coalesce=False), dict(weight_bits=1), dict(grad_bits=9),
               dict(bucket_size=0), dict(draft_bits=4, draft_depth=1), dict(draft_bits=9,
                                                                              draft_depth=4)):
        assert space.Candidate(**kw).valid() == jspace.Candidate(**kw).valid() is False
    q = space.Candidate(coalesce_max_bytes=4096, weight_bits=4).to_qsdp(qsdp.QSDPConfig())
    assert (q.coalesce, q.coalesce_max_bytes, q.weight_bits) == (True, 4096, 4)
    q = space.Candidate(prefetch=True).to_qsdp(qsdp.QSDPConfig())
    jq = jspace.Candidate(prefetch=True).to_qsdp(JQSDPConfig())
    assert q.prefetch and dataclasses.asdict(q) == {
        k: v for k, v in dataclasses.asdict(jq).items() if k in dataclasses.asdict(q)}


def _toy(c):
    # the reference test's toy cost (tests/test_tune.py)
    return (1.0 * c.coalesce + 0.25 * c.prefetch + 0.01 * c.weight_bits
            + (0.001 if c.coalesce_max_bytes else 0.0))


@pytest.mark.parametrize("how", ["exhaustive", "anneal"])
def test_search_rankings_match_reference(how):
    got_c = list(space.enumerate_space(thresholds=(None, 4096), full_space=True))
    want_c = list(jspace.enumerate_space(thresholds=(None, 4096), full_space=True))
    if how == "exhaustive":
        got, want = search.exhaustive_search(got_c, _toy), jsearch.exhaustive_search(want_c, _toy)
    else:
        got = search.simulated_annealing(got_c, _toy, seed=0, iters=300)
        want = jsearch.simulated_annealing(want_c, _toy, seed=0, iters=300)
        assert got[0][0] == search.exhaustive_search(got_c, _toy)[0][0]
    assert [(t, dataclasses.asdict(c)) for t, c in got] == \
        [(t, dataclasses.asdict(c)) for t, c in want]


@pytest.mark.parametrize("p", [1, 2, 8, 32])
def test_wire_bytes_match_reference(p):
    for n in (1, 1000, 4096, 123_457):
        for fp in (2, 4):
            assert coll.gather_wire_bytes(n, p, None, fp) == jcoll.gather_wire_bytes(n, p, None, fp)
            assert coll.reduce_scatter_wire_bytes(n * p, p, None, fp) == \
                jcoll.reduce_scatter_wire_bytes(n * p, p, None, fp)
        for bits in (2, 4, 8):
            for bucket in (256, 1024):
                for meta in ("float32", "bfloat16"):
                    c, jc = (QuantConfig(bits=bits, bucket_size=bucket, meta_dtype=meta),
                             JQuantConfig(bits=bits, bucket_size=bucket, meta_dtype=meta))
                    assert coll.gather_wire_bytes(n, p, c) == jcoll.gather_wire_bytes(n, p, jc)
                    assert coll.reduce_scatter_wire_bytes(n * p, p, c) == \
                        jcoll.reduce_scatter_wire_bytes(n * p, p, jc)
    assert coll.gather_wire_bytes(4096, 1, QuantConfig()) == 0


def _policy(policy, mid=None):
    return {"per-tensor": dict(coalesce=False), "coalesced": dict(coalesce=True),
            "mid": dict(coalesce=True, coalesce_max_bytes=mid)}[policy]


def _engines(arch, policy):
    """The two packages' engines of `arch`'s smoke config on (1, 1)."""
    ms, jms = qsdp.MeshSpec(("data", "model"), (1, 1)), jqsdp.MeshSpec(("data", "model"), (1, 1))
    mid = None
    if policy == "mid":
        probe = Model(configs.get_smoke(arch), ms, qsdp.QSDPConfig(min_quant_size=256)).engine
        bufs = sorted(probe.layer_wire_bytes(tuple(ns)) for _, ns, _ in cm.layer_groups(probe))
        mid = bufs[len(bufs) // 2]
        assert bufs[0] <= mid < bufs[-1]
    kw = dict(min_quant_size=256, **_policy(policy, mid))
    eng = Model(configs.get_smoke(arch), ms, qsdp.QSDPConfig(**kw)).engine
    jeng = JModel(jconfigs.get_smoke(arch), jms, jqsdp.QSDPConfig(**kw)).engine
    return eng, jeng


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_equals_reference(arch, policy):
    eng, jeng = _engines(arch, policy)
    cp, jcp = cm.HW_PRESETS["cpu-smoke"], jcm.HW_PRESETS["cpu-smoke"]
    groups = cm.layer_groups(eng)
    assert groups == jcm.layer_groups(jeng)
    for n_micro in (1, 2):
        for g in (2, 4):
            assert qsdp.step_comm_bytes(eng, g * n_micro, n_micro) == \
                jqsdp.step_comm_bytes(jeng, g * n_micro, n_micro) == \
                dict(weight_gather=0, grad_reduce=0, total=0)
        assert cm.predict_step_time(eng, cp, n_micro=n_micro) == \
            jcm.predict_step_time(jeng, jcp, n_micro=n_micro)
        forced = {g: i % 2 == 0 for i, (g, _, _) in enumerate(groups)}
        assert cm.predict_step_time(eng, cp, n_micro=n_micro, coalesced_groups=forced,
                                    t_compute_s=0.125) == \
            jcm.predict_step_time(jeng, jcp, n_micro=n_micro, coalesced_groups=forced,
                                  t_compute_s=0.125)
    for _, names, _ in groups:
        assert qsdp.layer_gather_launches(eng, names) == jqsdp.layer_gather_launches(jeng, names)
        assert cm._per_tensor_launches(eng, names) == jcm._per_tensor_launches(jeng, names)
        assert cm.crossover_bytes(eng, names, cp) == jcm.crossover_bytes(jeng, names, jcp)
        for co in (None, False, True):
            assert cm.predict_hlo_gather_counts(eng, names, co) == \
                jcm.predict_hlo_gather_counts(jeng, names, co) == 0
        for co in (False, True):
            for f, jf in ((cm.layer_gather_cost, jcm.layer_gather_cost),
                          (cm.layer_rs_cost, jcm.layer_rs_cost)):
                c, jc = f(eng, names, co), jf(jeng, names, co)
                assert dataclasses.asdict(c) == dataclasses.asdict(jc)
                assert c.time_s(cp) == jc.time_s(jcp)
    pols, thresh = cm.plan_layer_policies(eng, cp)
    jpols, jthresh = jcm.plan_layer_policies(jeng, jcp)
    assert [p.to_dict() for p in pols] == [p.to_dict() for p in jpols]
    assert thresh == jthresh


def test_presets():
    assert set(cm.HW_PRESETS) == {"cpu-smoke", "h100"}
    ref = jcm.HW_PRESETS["cpu-smoke"]
    got = cm.HW_PRESETS["cpu-smoke"]
    assert (got.name, got.t_launch_s, got.ser_bw) == (ref.name, ref.t_launch_s, ref.ser_bw)
    assert dataclasses.asdict(got.hw) == dataclasses.asdict(ref.hw)
    h = cm.HW_PRESETS["h100"]
    assert h.name == "h100" and h.hw is HW_H100 and isinstance(HW_H100, Hardware)
    assert (HW_H100.peak_flops, HW_H100.hbm_bw, HW_H100.ici_bw) == (989e12, 3.35e12, 450e9)
    assert h.t_launch_s > 0 and h.ser_bw > 0


def _plans():
    kw = dict(
        version=1, arch="t", mesh_axes=("data", "model"), mesh_shape=(1, 1), hw="cpu-smoke",
        qsdp={"weight_bits": 4, "grad_bits": 8, "coalesce": True,
              "coalesce_max_bytes": 1024, "min_quant_size": 128, "prefetch": False,
              "hierarchical": False},
        serve={"slots": 4, "prefill_chunk": 8, "prefill_buckets": 2},
        predicted={"step_ms": 1.23456789, "crossover_buffer_bytes": 440},
        measured={"W8G8 b1024 coalesced": {"step_ms_all": [1.000049, 2.5], "compile_s": 3.0}})
    lp = dict(group="layers", coalesce=False, wire_buffer_bytes=4096,
              launches_per_tensor=23, launches_coalesced=1)
    return (tplan.DeploymentPlan(layers=(tplan.LayerPolicy(**lp),), **kw),
            jplan.DeploymentPlan(layers=(jplan.LayerPolicy(**lp),), **kw))


def test_plan_json_byte_equal_and_round_trip(tmp_path):
    plan, jp = _plans()
    plan.save(str(tmp_path / "a.json"))
    jp.save(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    loaded = tplan.DeploymentPlan.load(str(tmp_path / "b.json"))
    assert loaded.layers == plan.layers and loaded.qsdp == plan.qsdp
    assert loaded.predicted["step_ms"] == 1.2346
    assert tplan.PLAN_VERSION == jplan.PLAN_VERSION == 1
    assert tplan._QSDP_FIELDS == jplan._QSDP_FIELDS
    assert tplan._SERVE_FIELDS == jplan._SERVE_FIELDS


def test_plan_to_qsdp_config_matches_reference_fields():
    plan, jp = _plans()
    q, jq = plan.to_qsdp_config(), jp.to_qsdp_config()
    ported = {f.name for f in dataclasses.fields(q)}
    assert {k: v for k, v in dataclasses.asdict(jq).items() if k in ported} == \
        dataclasses.asdict(q)
    assert set(dataclasses.asdict(jq)) - ported >= {"hierarchical"}
    assert "prefetch" in ported
    assert plan.serve_knobs() == jp.serve_knobs()


@pytest.mark.parametrize("field,value,err,match", [
    ("hierarchical", True, NotImplementedError, "ROADMAP A3b"),
    ("prefetch", True, None, None),
    ("bogus_knob", 1, ValueError, "unknown fields"),
])
def test_plan_refusals(field, value, err, match):
    """A plan that sets the two-level gathers or an unknown field is
    refused; one that sets prefetch drives the port's prefetch."""
    plan, _ = _plans()
    bad = dataclasses.replace(plan, qsdp={**plan.qsdp, field: value})
    if err is None:
        assert getattr(bad.to_qsdp_config(), field) == value
        return
    with pytest.raises(err, match=match):
        bad.to_qsdp_config()


def test_plan_version_and_mesh_refusals():
    plan, jp = _plans()
    d = plan.to_dict()
    d["version"] = 2
    with pytest.raises(ValueError, match="regenerate"):
        tplan.DeploymentPlan.from_dict(d)
    plan.validate_mesh(("data", "model"), (1, 1))
    for axes, shape in ((("data", "model"), (2, 1)), (("pod", "data", "model"), (1, 1, 1))):
        with pytest.raises(ValueError, match="re-run repro_torch.tune.autotune"):
            plan.validate_mesh(axes, shape)
        with pytest.raises(ValueError):
            jp.validate_mesh(axes, shape)
    with pytest.raises(ValueError, match="unknown fields"):
        dataclasses.replace(plan, serve={"bogus": 1}).serve_knobs()

