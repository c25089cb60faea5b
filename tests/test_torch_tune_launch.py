"""The port's autotuner CLI and both launchers' ``--plan`` against the JAX
package on the CPU: ``repro_torch.tune.autotune`` writes the reference's
plan byte for byte when it trusts the model (``--measure-top 0``), a plan
the reference wrote drives both of the port's launchers with the same
``QSDPConfig``, the refusals name their ROADMAP items, the measured
shortlist runs the port's train step, and ``chip_smoke.py``'s tune phase is
rehearsed at the smoke config."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro.core.qsdp import QSDPConfig as JQSDPConfig
from repro.tune import autotune as jautotune
from repro.tune.plan import DeploymentPlan as JDeploymentPlan
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.data import SyntheticLM, make_batch
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, make_adamw
from repro_torch.train import step as train_step
from repro_torch.tune import autotune, measure
from repro_torch.tune.plan import DeploymentPlan

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--smoke", "--data-par", "1", "--model-par", "1", "--measure-top", "0",
         "--hw", "cpu-smoke", "--min-quant-size", "256"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _ref_plan(tmp_path, extra=()):
    out = str(tmp_path / "ref_plan.json")
    assert jautotune.main(SMOKE + list(extra) + ["--out", out]) == 0
    return out


@pytest.mark.parametrize("extra", [[], ["--full-space", "--search", "anneal"]],
                         ids=["default", "full-space-anneal"])
@pytest.mark.parametrize("arch", ["gpt-125m", "olmoe-1b-7b", "zamba2-7b"])
def test_autotune_plan_byte_equal_to_reference(arch, extra, tmp_path):
    mine, ref = str(tmp_path / "mine.json"), str(tmp_path / "ref.json")
    flags = SMOKE + ["--arch", arch] + extra
    assert autotune.main(flags + ["--out", mine, "--device", "cpu"]) == 0
    assert jautotune.main(flags + ["--out", ref]) == 0
    assert Path(mine).read_bytes() == Path(ref).read_bytes()


def test_assert_choice_per_tensor_passes_and_coalesced_fails(tmp_path, capsys):
    out = str(tmp_path / "plan.json")
    assert autotune.main(SMOKE + ["--out", out, "--device", "cpu",
                                  "--assert-choice", "per-tensor"]) == 0
    plan = DeploymentPlan.load(out)
    assert plan.qsdp["coalesce"] is True and plan.qsdp["coalesce_max_bytes"] == 0
    assert plan.layers and not any(lp.coalesce for lp in plan.layers)
    assert "per-tensor gathers for group 'layers'" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--assert-choice coalesced failed"):
        autotune.main(SMOKE + ["--out", out, "--device", "cpu", "--assert-choice", "coalesced"])


def test_measured_prefetch_candidate_wins_plan_byte_equal(tmp_path, monkeypatch):
    """Both autotuners measure the whole shortlist, prefetch candidates
    included, with the step times of a stub that makes prefetch the
    fastest (a real measurement's winner is the noise's at this size):
    the same candidates measured in the same order, a prefetch candidate
    the winner, and the port's plan byte-equal to the reference's.  Under
    ``cpu-smoke`` the model's per-layer policy gathers the stacked group
    per tensor, so both plans record ``prefetch`` false (the reference
    keeps it only where that group coalesces)."""
    seen = {"port": [], "ref": []}

    def stub(tag):
        def measure(mcfg, ms, qcfg, batch, **kw):
            seen[tag].append((qcfg.coalesce, qcfg.prefetch, qcfg.coalesce_max_bytes))
            t = 1.0 if qcfg.prefetch else 2.0
            return {"step_ms_median": t, "step_ms_all": [t, t]}
        return measure

    monkeypatch.setattr(autotune, "measure_train_step", stub("port"))
    monkeypatch.setattr(jautotune, "measure_train_step", stub("ref"))
    flags = [f for f in SMOKE if f not in ("--measure-top", "0")] + ["--measure-top", "5"]
    mine, ref = str(tmp_path / "mine.json"), str(tmp_path / "ref.json")
    assert autotune.main(flags + ["--out", mine, "--device", "cpu"]) == 0
    assert jautotune.main(flags + ["--out", ref]) == 0
    assert seen["port"] == seen["ref"] and any(pf for _, pf, _ in seen["port"])
    assert Path(mine).read_bytes() == Path(ref).read_bytes()
    plan = DeploymentPlan.load(mine)
    best = min(plan.measured, key=lambda label: plan.measured[label]["step_ms_median"])
    assert best.endswith("+prefetch")
    assert not any(lp.coalesce for lp in plan.layers if lp.group == "layers")
    assert plan.qsdp["prefetch"] is False


@pytest.mark.parametrize("flags", [["--data-par", "2"], ["--model-par", "4"]])
def test_autotune_refuses_multi_rank_mesh(flags, capsys):
    with pytest.raises(SystemExit):
        autotune.parse_args(flags)
    assert "ROADMAP A12e" in capsys.readouterr().err


def test_reference_plan_drives_train_launcher(tmp_path, capsys):
    path = _ref_plan(tmp_path)
    jq = JDeploymentPlan.load(path).to_qsdp_config(JQSDPConfig())
    argv = ["--plan", path, "--smoke", "--device", "cpu", "--steps", "1", "--batch", "2",
            "--seq", "16", "--log-every", "1"]
    q = launch_train.build_qsdp(launch_train.parse_args(argv))
    ported = {f.name for f in dataclasses.fields(q)}
    assert {k: v for k, v in dataclasses.asdict(jq).items() if k in ported} == \
        dataclasses.asdict(q)
    assert (q.coalesce, q.coalesce_max_bytes, q.min_quant_size) == (True, 0, 256)
    out = tmp_path / "log.json"
    assert launch_train.main(argv + ["--out-json", str(out)]) == 0
    assert "[QSDP plan W8G8 coalesce<=0B]" in capsys.readouterr().out
    log = json.loads(out.read_text())["log"]
    assert len(log) == 1 and log[0]["loss"] > 0


def test_reference_plan_drives_serve_launcher(tmp_path, capsys):
    path = _ref_plan(tmp_path)
    args = launch_serve.parse_args(["--plan", path, "--smoke", "--device", "cpu",
                                    "--prompt-len", "8", "--gen", "2"])
    # the plan's serve section gives the defaults: slots -> --batch
    assert args.batch == JDeploymentPlan.load(path).serve["slots"] == 8
    assert args.plan_qsdp == DeploymentPlan.load(path).to_qsdp_config()
    # a flag typed wins over the plan's default
    assert launch_serve.parse_args(["--plan", path, "--batch", "2"]).batch == 2
    assert launch_serve.main(["--plan", path, "--smoke", "--device", "cpu", "--batch", "2",
                              "--prompt-len", "8", "--gen", "2"]) == 0
    assert "sample:" in capsys.readouterr().out


def _plan_with(tmp_path, **qsdp_over):
    d = DeploymentPlan.load(_ref_plan(tmp_path)).to_dict()
    d["qsdp"].update(qsdp_over)
    path = tmp_path / "edited.json"
    path.write_text(json.dumps(d))
    return str(path)


@pytest.mark.parametrize("edit,match", [
    (dict(prefetch=True), None),
    (dict(hierarchical=True), "ROADMAP A3b"),
    ("mesh", "tuned for mesh"),
    ("version", "regenerate with repro_torch.tune.autotune"),
])
def test_launchers_refuse_plans(edit, match, tmp_path, capsys):
    """Both launchers refuse a plan for the two-level gathers, for another
    mesh or of another version; a plan with prefetch (ported) sets it."""
    if match is None:
        path = _plan_with(tmp_path, **edit)
        for launcher in (launch_train, launch_serve):
            assert launcher.parse_args(["--plan", path, "--smoke"]).plan_qsdp.prefetch
        return
    if isinstance(edit, dict):
        path = _plan_with(tmp_path, **edit)
    else:
        d = json.loads(Path(_ref_plan(tmp_path)).read_text())
        if edit == "mesh":
            d["mesh_shape"] = [4, 2]
        else:
            d["version"] = 2
        path = str(tmp_path / "edited.json")
        Path(path).write_text(json.dumps(d))
    for launcher in (launch_train, launch_serve):
        with pytest.raises(SystemExit):
            launcher.parse_args(["--plan", path, "--smoke"])
        assert match in capsys.readouterr().err


@pytest.mark.parametrize("launcher", [launch_train, launch_serve], ids=["train", "serve"])
def test_plan_with_baseline_refused(launcher, tmp_path, capsys):
    with pytest.raises(SystemExit):
        launcher.parse_args(["--plan", _ref_plan(tmp_path), "--baseline"])
    assert "--plan pins the" in capsys.readouterr().err


def test_train_plan_refuses_comm_flags(tmp_path, capsys):
    path = _ref_plan(tmp_path)
    for flags in (["--coalesce-max-bytes", "4"], ["--no-coalesce"]):
        with pytest.raises(SystemExit):
            launch_train.parse_args(["--plan", path] + flags)
        assert "--plan pins the comm policy" in capsys.readouterr().err


def test_measure_train_step_first_loss_equals_build_train_step(monkeypatch):
    cfg = configs.get_smoke("gpt-125m")
    ms = MeshSpec(("data", "model"), (1, 1))
    q = QSDPConfig(min_quant_size=256, coalesce_max_bytes=0)
    batch = make_batch(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
                                   seed=1), 0, "cpu")
    losses = []
    orig = train_step.build_train_step

    def recording(*a, **k):
        step = orig(*a, **k)

        def f(state, b, key):
            state, m = step(state, b, key)
            losses.append(float(m["loss"]))
            return state, m
        return f

    monkeypatch.setattr(measure, "build_train_step", recording)
    r = measure.measure_train_step(cfg, ms, q, batch, steps=1, seed=0, device="cpu")
    assert set(r) == {"step_ms_median", "step_ms_all", "compile_s", "loss_final",
                      "layer_gather_launches"}
    assert len(r["step_ms_all"]) == 1 and len(losses) == 3 and r["loss_final"] == losses[-1]
    assert r["layer_gather_launches"] == 23  # per-tensor: 7 quantized x 3 + 2 norms
    # the same state, batch and keys through build_train_step alone
    model = Model(cfg, ms, q)
    opt = make_adamw(AdamWConfig(lr=1e-3))
    state = train_step.init_train_state(model, opt, 0, "cpu")
    step = train_step.build_train_step(model, opt, device="cpu")
    key = prng.PRNGKey(7)
    want = []
    for k in (key, prng.fold_in(key, -1), prng.fold_in(key, 0)):
        state, m = step(state, batch, k)
        want.append(float(m["loss"]))
    assert losses == want


def test_chip_smoke_tune_rehearsal(monkeypatch, tmp_path):
    """The tune phase's autotune and launcher parts at the smoke config on
    the CPU: launches per candidate and per launcher run against
    ``expected_train_launches`` / ``expected_launches`` (the wrappers count
    only kernel launches, so the rehearsal counts calls), the plan against
    its engine, --plan bit-equal to the equivalent flags."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "TUNE_OUT", str(tmp_path))
    for name, kernel in (("quantize_pack", "quantize_pack"),
                         ("unpack_dequantize", "unpack_dequantize"),
                         ("unpack_dequantize_wire", "unpack_dequantize")):
        def counted(*a, _orig=getattr(ops, name), _kernel=kernel, **k):
            ops.LAUNCHES[_kernel] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    lines = []
    path = str(tmp_path / "plan.json")
    plan, counts = cs.tune_autotune(torch, lines.append, "cpu", path, smoke=True, batch=2,
                                    seq=16, measure_top=3, steps=1, hw="cpu-smoke")
    # per-tensor (threshold 440 B), coalesced and coalesced+prefetch
    # measured; 3 steps each: K1 44 a step per tensor and coalesced, 30
    # prefetched (the 2 layers' replays encode none of their 7 weights), K2
    # 44 per tensor, 8 coalesced (3 + 2 + 3) with or without prefetch
    assert counts["quantize_pack"] == 3 * 44 * 2 + 3 * 30
    assert counts["unpack_dequantize"] == 3 * 44 + 3 * 8 * 2
    assert plan.qsdp["coalesce_max_bytes"] == 0
    assert sum("launches a step (= the structure's)" in x for x in lines) == 3
    c2 = cs.tune_launchers(torch, lines.append, "cpu", path, plan, smoke=True,
                           train=dict(steps=1, batch=2, seq=16),
                           serve=dict(batch=2, prompt_len=8, gen=2))
    assert c2["quantize_pack"] > 0 and c2["unpack_dequantize"] > 0
    assert any("bit-equal" in x for x in lines) and any("tokens equal" in x for x in lines)


@pytest.mark.parametrize("t_pt,t_co,passes", [
    (2e-3, 1e-3, True),      # coalesced faster: the preset coalesces, as it should
    (1e-3, 1.03e-3, True),   # per tensor 3 % faster: within the tie
    (1e-3, 1.1e-3, False),   # per tensor 10 % faster: the preset is wrong here
])
def test_chip_smoke_fit_solves_the_cost_model(t_pt, t_co, passes, monkeypatch):
    """The tune phase's fit solves the cost model's two equations at wire 0
    (t_pt = L_pt t_launch, t_co = L_co t_launch + buf / ser_bw) for the
    times measured, and its gate holds the committed h100 preset's
    coalesce decision to the faster form (gpt-1.3b's smoke layer, whose
    buffers lie far below the preset's crossover: the preset coalesces)."""
    cs = _chip_smoke()
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    monkeypatch.setattr(cs, "layer_gather_seconds",
                        lambda torch_, engs, prefix, names, dev, reps: {False: t_pt, True: t_co})
    lines = []
    if not passes:
        with pytest.raises(cs.PhaseError, match="per-tensor form measured faster"):
            cs.fit_cost_params(torch, lines.append, "cpu")
        return
    cs.fit_cost_params(torch, lines.append, "cpu")
    # gpt-1.3b smoke: 2 x 23 launches per tensor, 2 coalesced over the
    # gather's and the reduce-scatter's buffers
    buf = 662_528 + 661_504
    t_launch = t_pt / 46
    want = f"fitted t_launch_s={t_launch:.6e} ser_bw={buf / (t_co - 2 * t_launch):.6e} B/s"
    assert any(want in x for x in lines), lines
