"""The port's qlint (``repro_torch.analysis``) against the JAX package's
(``repro.analysis``) on the CPU.

  * key audit: for every arch of the registry at full size, the fold
    catalog (as a set of (scope, constant, tensor)), the range guards and
    the findings equal the reference's;
  * source lint: on twin seeded trees, the same violations in JAX idioms
    for the reference and in torch idioms for the port, the (rule, site)
    sets are equal once each idiom is named by its twin;
  * collective audit: the pure differs (``diff_gather_counts``,
    ``diff_wire_bytes``, ``check_plan_drift``) give the reference's
    findings on the same inputs, and gpt-125m smoke's report at (1, 1)
    (counted on meta) holds the reference's ``audit(report=...)`` entries,
    beside marginal kernel launches equal to the engine's gather structure;
  * trace audit: each QJ rule fires on a seeded program traced on meta and
    stays clean when the values change or the u8 codes are gathered;
  * the CLI exits 0 on this tree with the port's baseline, and on a seeded
    tree exits 1, then baselines, then exits 0.

The reference's jaxpr audit cannot run under this JAX (``jax.core.
ClosedJaxpr`` is gone, ROADMAP C3), so the QJ rules are held to seeded
programs, as the reference's own tests hold its rules."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro import configs as jconfigs
from repro.analysis import collective_audit as jcoll, key_audit as jkey, source_lint as jlint
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.transformer import Model as JModel
from repro.tune.plan import DeploymentPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch.analysis import collective_audit as tcoll, key_audit as tkey
from repro_torch.analysis import source_lint as tlint, trace_audit
from repro_torch.core import collectives
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.core.quant import QuantConfig, dequantize, quantize
from repro_torch.models.transformer import Model
from repro_torch.tune.plan import DeploymentPlan

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
CFG = QuantConfig(bits=8, bucket_size=64, mode="nearest")


def _rules(findings):
    return {f.rule for f in findings}


def _ident(findings):
    return {f.ident() for f in findings}


# ---------------------------------------------------------------------------
# key audit (QK2xx)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_key_catalog_equals_reference(arch):
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.list_archs())
    jm = JModel(jconfigs.get_config(arch), JMeshSpec(axes=("data", "model"), shape=(1, 1)),
                JQSDPConfig())
    tm = Model(tconfigs.get_config(arch), MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
    for n_micro in (2, 5):
        uses = [{(u.scope, u.const, u.tensor) for u in mod.enumerate_key_uses(m, n_micro)}
                for mod, m in ((jkey, jm), (tkey, tm))]
        assert uses[0] == uses[1]
        assert (_ident(jkey.range_guards(jm, n_micro))
                == _ident(tkey.range_guards(tm, n_micro)))
    assert _ident(tkey.run([arch])) == _ident(jkey.run([arch])) == set()


def test_key_checks_equal_reference_on_seeded_collisions():
    """An index colliding with an index, two name hashes, and an index
    reaching the master salt: the reference's findings, rule for rule."""
    cases = [[("loss", 7, "layers.0.wq", False), ("loss", 7, "layers.1.wq", False)],
             [("master", 0xDEAD, "wq", True), ("master", 0xDEAD, "wk", True)],
             [("step", jkey.MASTER_SALT, "master-requant", False),
              ("step", jkey.MASTER_SALT, "micro[3824617]", False)],
             [("loss", 7, "a", False), ("loss", 8, "b", False)]]
    assert tkey.MASTER_SALT == jkey.MASTER_SALT and tkey.GRAD_SALT == jkey.GRAD_SALT
    for uses in cases:
        got = [tkey.check_key_uses([tkey.KeyUse(s, c, t, "site", h) for s, c, t, h in uses]),
               jkey.check_key_uses([jkey.KeyUse(s, c, t, "site", h) for s, c, t, h in uses])]
        assert [(f.rule, f.site, f.message) for f in got[0]] == \
            [(f.rule, f.site, f.message) for f in got[1]]


# ---------------------------------------------------------------------------
# source lint (QS4xx)
# ---------------------------------------------------------------------------

# the same violations in each package's idiom; IDIOMS names each reference
# idiom by the port's twin
TWINS = {
    "jax": {
        "serve/scheduler.py": """\
            import jax

            class ContinuousScheduler:
                def __init__(self):
                    self.n = jax.device_get(0)  # exempt: setup, not the loop

                def step(self, tokens):
                    done = jax.device_get(tokens)
                    tokens.block_until_ready()
                    return float(tokens.item())
            """,
        "core/lib.py": """\
            import jax

            def default_key():
                return jax.random.PRNGKey(0), jax.random.PRNGKey(1)
            """,
        "train/bad_import.py": "from repro.kernels.quantize import quantize_kernel\n",
        "analysis/harness.py": "import jax\nK = jax.random.PRNGKey(3)\n",
    },
    "torch": {
        "serve/scheduler.py": """\
            import torch

            class ContinuousScheduler:
                def __init__(self):
                    self.n = torch.zeros(1).cpu()  # exempt: setup, not the loop

                def step(self, tokens):
                    done = tokens.cpu().numpy()  # one sync, chained
                    torch.cuda.synchronize()
                    return float(tokens.item())
            """,
        "core/lib.py": """\
            import torch
            from repro_torch.core import prng

            def default_key():
                return prng.PRNGKey(0), torch.manual_seed(1)
            """,
        "train/bad_import.py": "from repro_torch.kernels.ref import quantize_pack_ref\n",
        "analysis/harness.py": "from repro_torch.core import prng\nK = prng.PRNGKey(3)\n",
        "kernels/ops.py": "from .ref import fma_f32\n",  # inside kernels/: allowed
        "roofline/count.py": "from ..kernels import cost, ops\n",  # public: allowed
        "examples/demo.py": "from repro_torch.core import prng\nK = prng.PRNGKey(1)\n",
    },
}
IDIOMS = {"::device_get": "::cpu", "::block_until_ready": "::synchronize",
          "::PRNGKey(1)": "::manual_seed(1)",
          "::import::repro.kernels.quantize": "::import::repro_torch.kernels.ref"}


def _seed_tree(root: Path, files: dict) -> Path:
    for rel, body in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(body))
    return root


def _as_port(site: str) -> str:
    for a, b in IDIOMS.items():
        site = site.replace(a, b)
    return site


def test_lint_equals_reference_on_twin_trees(tmp_path):
    ref = jlint.lint_source(_seed_tree(tmp_path / "jax", TWINS["jax"]))
    port = tlint.lint_source(_seed_tree(tmp_path / "torch", TWINS["torch"]))
    assert {(f.rule, _as_port(f.site)) for f in ref} == {(f.rule, f.site) for f in port}
    assert _rules(port) == {"QS401", "QS402", "QS403"}
    qs401 = sorted(f.site.rsplit("::", 1)[1] for f in port if f.rule == "QS401")
    assert qs401 == ["cpu", "item", "synchronize"]  # .numpy() rides its .cpu()


def test_lint_head_clean_modulo_baseline():
    from repro_torch.analysis.findings import load_baseline, partition_findings
    baseline = load_baseline(str(ROOT / "src" / "repro_torch" / "analysis"
                                 / "qlint_baseline.json"))
    new, suppressed, _ = partition_findings(tlint.run(), baseline)
    assert new == [], [str(f) for f in new]
    assert all(baseline[f.ident()] and "TODO" not in baseline[f.ident()] for f in suppressed)


# ---------------------------------------------------------------------------
# collective audit (QC3xx): the pure differs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("counts,predicted", [
    ({"all-gather": 2}, 1), ({"all-gather": 1, "all-to-all": 1}, 1),
    ({"all-gather": 1, "reduce-scatter": 2}, 1), ({}, 0), ({"collective-permute": 3}, 0)])
def test_diff_gather_counts_equals_reference(counts, predicted):
    got = [m.diff_gather_counts(counts, predicted, "t") for m in (tcoll, jcoll)]
    assert [(f.rule, f.site, f.message) for f in got[0]] == \
        [(f.rule, f.site, f.message) for f in got[1]]


@pytest.mark.parametrize("wire,budget", [(2_000_000, 1_000_000), (1_000_000, 1_000_000),
                                         (0.0, 0.0), (5000.0, 0.0)])
def test_diff_wire_bytes_equals_reference(wire, budget):
    got = [m.diff_wire_bytes(wire, budget, "t") for m in (tcoll, jcoll)]
    assert [(f.rule, f.site, f.message) for f in got[0]] == \
        [(f.rule, f.site, f.message) for f in got[1]]


def test_check_plan_drift_equals_reference():
    """A plan for gpt-125m smoke whose 'layers' group records the wrong
    coalesce decision and bytes, and a group the engine lacks: both
    packages' engines (built from the plan's qsdp section) name the same
    drift; a plan of the engine's own records names none."""
    tm = Model(tconfigs.get_smoke("gpt-125m"), MeshSpec(("data", "model"), (1, 1)),
               QSDPConfig(min_quant_size=256, coalesce=True))
    layers = tuple(sorted(n for n in tm.engine.specs if n.startswith("layers/")))
    buf = tm.engine.layer_wire_bytes(layers)
    base = dict(version=1, arch="gpt-125m", mesh_axes=["data", "model"], mesh_shape=[1, 1],
                hw="cpu-smoke", qsdp={"coalesce": True, "min_quant_size": 256}, serve={})
    good = [dict(group="layers", coalesce=True, wire_buffer_bytes=buf,
                 launches_per_tensor=0, launches_coalesced=1)]
    bad = [dict(good[0], coalesce=False, wire_buffer_bytes=buf + 1),
           dict(good[0], group="nope")]
    for layers_, n in ((good, 0), (bad, 3)):
        d = dict(base, layers=layers_)
        jp, tp = JPlan.from_dict(d), DeploymentPlan.from_dict(d)
        jeng = JModel(jconfigs.get_smoke("gpt-125m"),
                      JMeshSpec(axes=("data", "model"), shape=(1, 1)),
                      jp.to_qsdp_config(JQSDPConfig(min_quant_size=256))).engine
        teng = Model(tconfigs.get_smoke("gpt-125m"), MeshSpec(("data", "model"), (1, 1)),
                     tp.to_qsdp_config(QSDPConfig(min_quant_size=256))).engine
        got = [tcoll.check_plan_drift(tp, teng, "t"), jcoll.check_plan_drift(jp, jeng, "t")]
        assert [(f.rule, f.site, f.message) for f in got[0]] == \
            [(f.rule, f.site, f.message) for f in got[1]]
        assert len(got[0]) == n


def test_layer_kernel_launches_per_tensor_and_coalesced():
    """The gather structure's K1/K2 per layer (``core.qsdp``), and the
    audit's train-step composition of it: coalesced, one K2 per buffer
    (``layer_gather_launches`` = 1); per tensor, one per quantized tensor
    ((3 n_q + n_fp - n_fp) / 3); a skipped name leaves the gather's K2."""
    from repro_torch.core.qsdp import layer_kernel_launches
    for coalesce, k2 in ((True, 1), (False, 7)):
        m = Model(tconfigs.get_smoke("gpt-125m"), MeshSpec(("data", "model"), (1, 1)),
                  QSDPConfig(min_quant_size=256, coalesce=coalesce))
        names = sorted(n for n in m.engine.specs if n.startswith("layers/"))
        assert layer_kernel_launches(m.engine, names) == {"gather": (7, k2), "reduce": (7, k2)}
        skipped = layer_kernel_launches(m.engine, names, skip=("w_up", "w_down"))
        assert skipped == {"gather": (7, k2 - 2 * (not coalesce)), "reduce": (7, k2)}
        assert tcoll.train_layer_launches(m.engine, names, n_micro=2) == \
            {"quantize_pack": 2 * 21, "unpack_dequantize": 2 * 3 * k2}


def test_mesh_beyond_one_rank_names_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP A12e"):
        tcoll.audit(mesh_shape=(2, 4))


# ---------------------------------------------------------------------------
# trace audit (QJ1xx), on meta
# ---------------------------------------------------------------------------

KEY = (0, 0)


def _traced(fn, bit_identity=False):
    return trace_audit.trace(fn, "seeded", bit_identity).findings


def _x():
    return torch.empty((256,), device=META)


def test_trace_fires_on_redundant_roundtrip():
    def seeded():
        d = dequantize(quantize(_x(), CFG, KEY))
        return quantize(d.reshape(-1), CFG, KEY)  # re-quantizing decoded values

    assert _ident(_traced(seeded)) == {("QJ101", "seeded::unpack_dequantize->quantize_pack")}


def test_trace_clean_when_values_change():
    def clean():
        d = dequantize(quantize(_x(), CFG, KEY))
        return quantize(d * 1.5 + 1.0, CFG, KEY)  # real compute between the two

    assert _traced(clean) == []


def test_trace_fires_on_u8_widening_before_collective():
    def seeded():
        wide = quantize(_x(), CFG, KEY).codes.to(torch.float32)  # 4x the wire bytes
        return collectives.all_gather_fp(wide.reshape(-1))

    assert _ident(_traced(seeded)) == {("QJ102", "seeded::u8->float32->all_gather_fp")}


def test_trace_fires_on_widening_written_into_a_wire_buffer():
    """A widened segment copied into part of a buffer taints the buffer the
    collective ships."""
    def seeded():
        buf = torch.zeros((512,), device=META)
        buf[:256].copy_(quantize(_x(), CFG, KEY).codes.reshape(-1))  # u8 -> f32 copy
        return collectives.gather_wire(buf)

    assert _ident(_traced(seeded)) == {("QJ102", "seeded::u8->float32->gather_wire")}


def test_trace_clean_when_gathering_u8():
    def clean():
        q = quantize(_x(), CFG, KEY)
        return collectives.gather_wire(q.codes.reshape(-1)).to(torch.float32)  # u8 on the wire

    assert _traced(clean) == []


@pytest.mark.parametrize("op,hazard", [
    (lambda z, i, s: z.index_add_(0, i, s), "index_add:float"),
    (lambda z, i, s: z.index_put_((i,), s, accumulate=True), "index_put:float"),
    (lambda z, i, s: z.scatter_add_(0, i, s), "scatter_add:float"),
    (lambda z, i, s: z.uniform_(), "uniform"),
])
def test_trace_fires_on_hazards_only_when_guarded(op, hazard):
    def seeded():
        op(torch.zeros(8, device=META), torch.zeros(4, dtype=torch.int64, device=META),
           torch.ones(4, device=META))

    assert _ident(_traced(seeded, bit_identity=True)) == {("QJ103", f"seeded::{hazard}")}
    assert _traced(seeded) == []


def test_trace_clean_on_exact_scatters():
    """Integer accumulation and plain (non-accumulating) writes replay."""
    def clean():
        i = torch.zeros(4, dtype=torch.int64, device=META)
        torch.zeros(8, dtype=torch.int64, device=META).index_add_(0, i, i)
        torch.zeros(8, device=META).index_put_((i,), torch.ones(4, device=META))

    assert _traced(clean, bit_identity=True) == []


def test_trace_launches_equal_the_wrappers_counts():
    """The trace records every kernel launch: on meta, the delta of
    ``kernels.ops.LAUNCHES`` over the traced program."""
    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    traced = trace_audit.trace(lambda: dequantize(quantize(_x(), CFG, KEY)), "t")
    delta = {k: ops.LAUNCHES[k] - before[k] for k in ops.KERNELS if ops.LAUNCHES[k] != before[k]}
    assert traced.launches == delta == {"quantize_pack": 1, "unpack_dequantize": 1}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _run_cli(args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis.qlint", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def head_report(tmp_path_factory):
    path = tmp_path_factory.mktemp("qlint") / "report.json"
    r = _run_cli(["--all", "--arch", "gpt-125m", "--mesh", "1,1", "--report", str(path)])
    return r, json.loads(path.read_text())


def test_cli_head_exits_zero_with_the_port_baseline(head_report):
    r, report = head_report
    assert r.returncode == 0, r.stdout + r.stderr
    assert "new=0" in r.stdout and report["ok"] is True
    assert set(report["passes"]) == {"lint", "key", "jaxpr", "collective"}
    assert report["unused_suppressions"] == []
    # the five programs traced, every one through K1 and K2
    launches = report["meta"]["trace_launches"]
    assert set(launches) == {"train-step[f32]", "train-step[qstate]", *trace_audit.SERVE_TAGS}
    assert all(v["quantize_pack"] > 0 and v["unpack_dequantize"] > 0 for v in launches.values())


def test_collective_report_equals_reference(head_report):
    """gpt-125m smoke at (1, 1): the reference's report entries, and the
    marginal kernel launches per layer equal to the gather structure's."""
    want = {}
    assert jcoll.audit(report=want) == []
    got = head_report[1]["meta"]["collective"]
    assert set(got) == set(want)
    for tag, entry in want.items():
        assert {k: got[tag][k] for k in entry} == entry
        assert got[tag]["marginal_launches"] == got[tag]["predicted_marginal_launches"] \
            == {"quantize_pack": 21, "unpack_dequantize": 3}


def test_cli_seeded_tree_exits_nonzero_then_baselines(tmp_path):
    tree = _seed_tree(tmp_path / "tree", TWINS["torch"])
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"version": 1, "suppressions": []}))
    lint = ["--passes", "lint", "--root", str(tree), "--baseline", str(baseline)]

    r = _run_cli(lint + ["--report", str(tmp_path / "report.json")])
    assert r.returncode == 1, r.stdout + r.stderr
    assert "NEW QS401" in r.stdout
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["ok"] is False
    assert {f["rule"] for f in report["new"]} == {"QS401", "QS402", "QS403"}

    r = _run_cli(lint + ["--update-baseline"])
    assert r.returncode == 1  # still new THIS run; the baseline now records them
    assert all(s["justify"].startswith("TODO")
               for s in json.loads(baseline.read_text())["suppressions"])
    r = _run_cli(lint)
    assert r.returncode == 0, r.stdout + r.stderr
    assert _run_cli(["--mesh", "2,4"]).returncode == 2
