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
        ops.quantize_pack(torch.zeros(1, 4), torch.zeros(1, 1, device="meta"), 255, 8)
