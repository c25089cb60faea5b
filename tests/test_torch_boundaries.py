"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points refuse to fall back to the CPU silently, and
what this slice does not serve raises with the ROADMAP item to read."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.core.qsdp import MeshSpec, QSDPConfig, QSDPEngine
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.serve import build_serve_setup

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_and_no_repro():
    files = _port_files()
    assert len(files) > 20
    scanned = {p.parent.name for p in files}
    assert {"tune", "roofline", "examples", "analysis"} <= scanned, scanned
    rel = {p.relative_to(ROOT / "src" / "repro_torch").as_posix() for p in files[:-1]}
    assert {"launch/dryrun.py", "configs/inputs.py", "roofline/counter.py",
            "experiments/roofline_report.py", "analysis/findings.py",
            "analysis/source_lint.py", "analysis/key_audit.py",
            "analysis/collective_audit.py", "analysis/trace_audit.py",
            "analysis/qlint.py", "launch/mesh.py"} <= rel, rel
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & FORBIDDEN)
           for p in files if _imported_roots(p) & FORBIDDEN}
    assert not bad, bad


def test_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serve_setup("gpt-1.3b", smoke=True, batch=1, prompt_len=4, gen=2)


def test_cpu_setup_when_asked():
    setup = build_serve_setup("gpt-1.3b", smoke=True, batch=1, prompt_len=4, gen=2,
                              device="cpu")
    assert setup.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in setup.params.values())


def test_multi_rank_mesh_names_roadmap(capsys):
    """A (1, 2) mesh is accepted: without a model group the engine computes
    the model rank it is given alone, and without either it refuses; a
    mesh the port does not run (a "pod" axis) names its ROADMAP item, and a
    (P, 1) mesh needs a process group of P ranks; the train launcher
    refuses the VLM and audio families, whose batches carry inputs the
    synthetic corpus does not give (they train through
    ``build_train_step``), before it touches a device."""
    from repro_torch.launch import train as launch_train
    eng = QSDPEngine(MeshSpec(("data", "model"), (1, 2)), QSDPConfig(), {}, model_rank=1)
    assert (eng.rank, eng.model_rank, eng.group, eng.model_group) == (0, 1, None, None)
    with pytest.raises(ValueError, match="model group has 1"):
        QSDPEngine(MeshSpec(("data", "model"), (1, 2)), QSDPConfig(), {})
    with pytest.raises(NotImplementedError, match="ROADMAP A3b"):
        QSDPEngine(MeshSpec(("pod", "data", "model"), (2, 1, 1)), QSDPConfig(), {})
    with pytest.raises(ValueError, match="process group has 1"):
        QSDPEngine(MeshSpec(("data", "model"), (2, 1)), QSDPConfig(), {})
    for arch, inputs in (("qwen2-vl-72b", "vision_embeds"), ("seamless-m4t-large-v2",
                                                              "audio_embeds")):
        with pytest.raises(SystemExit):
            launch_train.main(["--arch", arch, "--smoke", "--steps", "1"])
        err = capsys.readouterr().err
        assert f"--arch {arch}" in err and inputs in err and "build_train_step" in err


def test_wrappers_reject_mixed_devices():
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops.unpack_dequantize(torch.zeros((1, 4), dtype=torch.uint8),
                              torch.zeros((1, 1), device="meta"), torch.zeros((1, 1)), 8)


def test_train_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import AdamWConfig, make_adamw
    from repro_torch.train.step import build_train_step
    from repro_torch.models.transformer import Model
    from repro_torch import configs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(configs.get_smoke("gpt-1.3b"), MeshSpec(("data", "model"), (1, 1)),
                  QSDPConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train_step(model, make_adamw(AdamWConfig()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "gpt-1.3b", "--smoke", "--steps", "1"])


@pytest.mark.parametrize("flags,refusal", [
    (["--arch", "olmoe-1b-7b", "--smoke", "--model-par", "2"], "ROADMAP A11h"),
    (["--hierarchical"], "ROADMAP A3b"), (["--prefetch"], None), (["--plan", "{prefetch}"], None),
    (["--prefetch", "--no-coalesce"], "--prefetch requires coalescing")])
def test_train_launcher_names_roadmap_for_unported_flags(flags, refusal, capsys, tmp_path):
    """``--plan`` and layer prefetch are ported: ``--prefetch`` and a plan
    that asks for it set ``QSDPConfig.prefetch``, and ``--prefetch`` without
    coalescing is refused as the JAX launcher refuses it; a model axis
    above 1 for a family other than the dense one and the two-level
    gathers name their ROADMAP items."""
    from repro_torch.launch import train as launch_train
    from repro_torch.tune.plan import PLAN_VERSION, DeploymentPlan
    plan = str(tmp_path / "prefetch_plan.json")
    DeploymentPlan(version=PLAN_VERSION, arch="gpt-125m", mesh_axes=("data", "model"),
                   mesh_shape=(1, 1), hw="h100", qsdp={"coalesce": True, "prefetch": True},
                   serve={}).save(plan)
    argv = [f.format(prefetch=plan) for f in flags]
    if refusal is None:
        assert launch_train.build_qsdp(launch_train.parse_args(argv)).prefetch
        return
    with pytest.raises(SystemExit):
        launch_train.parse_args(argv)
    assert refusal in capsys.readouterr().err


def test_train_launcher_data_par_needs_torchrun(capsys, monkeypatch):
    """``--data-par P`` trains over P processes that torchrun starts: it must
    equal the world size (1 outside torchrun)."""
    from repro_torch.launch import train as launch_train
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--data-par", "2"])
    assert "torchrun --nproc_per_node 2" in capsys.readouterr().err
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--data-par", "2"])
    assert "the world has 4" in capsys.readouterr().err
    assert launch_train.parse_args(["--data-par", "4"]).data_par == 4


def test_train_launcher_accepts_model_par(capsys, monkeypatch):
    """``--model-par M`` trains the dense family over P·M processes: the
    (1, 2) and (2, 2) grids parse under a world of their size, ``--batch``
    splits over P alone, and P·M must equal the world size."""
    from repro_torch.launch import train as launch_train
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = launch_train.parse_args(["--model-par", "2", "--batch", "1"])
    assert (args.data_par, args.model_par) == (1, 2)
    monkeypatch.setenv("WORLD_SIZE", "4")
    args = launch_train.parse_args(["--data-par", "2", "--model-par", "2", "--batch", "2"])
    assert (args.data_par, args.model_par) == (2, 2)
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--model-par", "2"])
    assert "trains over 2 ranks" in capsys.readouterr().err


def test_unported_training_options_raise():
    with pytest.raises(ValueError, match="'full' or 'dots'"):
        QSDPConfig(remat_policy="offload")
    assert QSDPConfig().remat_policy == "full"
    assert QSDPConfig(remat_policy="dots").remat_policy == "dots"


def test_state_loaders_raise_without_cuda(monkeypatch, tmp_path):
    """A resumed state lands on the card unless the caller asks for the CPU."""
    from repro_torch import configs
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, make_adamw
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint, state_to_flat
    from repro_torch.train.step import init_train_state
    from repro_torch.weights import params_from_jax, train_state_from_jax

    model = Model(configs.get_smoke("gpt-1.3b"), MeshSpec(("data", "model"), (1, 1)),
                  QSDPConfig())
    state = init_train_state(model, make_adamw(AdamWConfig()), 0, "cpu")
    save_checkpoint(str(tmp_path), state)
    flat = state_to_flat(state)
    params = {k: v.numpy() for k, v in state.params.items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (lambda: load_checkpoint(str(tmp_path)), lambda: train_state_from_jax(*flat),
                 lambda: params_from_jax(params)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load()
    assert load_checkpoint(str(tmp_path), device="cpu").params["embed"].device.type == "cpu"


def test_bucket_wrappers_reject_mixed_devices():
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops.quantize_buckets(torch.zeros(1, 4), torch.zeros(1, 4, device="meta"))
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops.dequantize_buckets(torch.zeros(1, 4, dtype=torch.uint8),
                               torch.zeros(1, 1, device="meta"), torch.zeros(1, 1))


def test_unported_serving_paths_name_roadmap():
    """Speculative decoding (ROADMAP A10c) is ported: a spec with draft bits
    and depth builds a scheduler with a draft engine, and draft bits outside
    [2, 8] are refused.  The audio family serves (A11d), but, as in the
    reference, not from a paged pool: that spec fails at its DecodeModel."""
    from repro_torch.serve import make_scheduler
    spec_setup = build_serve_setup("gpt-1.3b", smoke=True, batch=2, prompt_len=8, gen=4,
                                   draft_bits=4, draft_depth=3, device="cpu")
    assert spec_setup.spec.speculative
    assert make_scheduler(spec_setup).draft_engine is not None
    with pytest.raises(ValueError, match="draft_bits"):
        build_serve_setup("gpt-1.3b", smoke=True, batch=2, prompt_len=8, gen=4,
                          draft_bits=1, draft_depth=3, device="cpu")
    setup = build_serve_setup("gpt-1.3b", smoke=True, batch=2, prompt_len=8, gen=4,
                              kv_block_size=4, device="cpu")
    assert setup.spec.paged and setup.spec.pool_blocks() == 2 * setup.spec.blocks_per_slot
    with pytest.raises(ValueError, match="requires chunked admission"):
        make_scheduler(setup)
    audio = ModelConfig(name="audio", arch_type="audio", n_layers=1, d_model=64,
                        vocab_size=128, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                        n_enc_layers=1)
    with pytest.raises(ValueError, match="paged KV"):
        build_serve_setup(audio, device="cpu", kv_block_size=4)
