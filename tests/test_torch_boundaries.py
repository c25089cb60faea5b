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


def test_multi_rank_mesh_names_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        QSDPEngine(MeshSpec(("data", "model"), (2, 1)), QSDPConfig(), {})
    moe = ModelConfig(name="moe", arch_type="moe", n_layers=1, d_model=64,
                      vocab_size=128, n_heads=2, n_kv_heads=2, head_dim=32)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        build_serve_setup(moe, device="cpu")


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


@pytest.mark.parametrize("flags,item", [
    (["--data-par", "2"], "A3b"), (["--model-par", "2"], "A3b"),
    (["--hierarchical"], "A3b"), (["--prefetch"], "A4b"),
    (["--coalesce-max-bytes", "1024"], "A12"), (["--plan", "plan.json"], "A12")])
def test_train_launcher_names_roadmap_for_unported_flags(flags, item, capsys):
    from repro_torch.launch import train as launch_train
    with pytest.raises(SystemExit):
        launch_train.parse_args(flags)
    assert f"ROADMAP {item}" in capsys.readouterr().err


def test_unported_training_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP A5c"):
        QSDPConfig(remat_policy="dots")
    assert QSDPConfig().remat_policy == "full"


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
