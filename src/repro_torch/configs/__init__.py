"""Architecture registry of the port: the paper's own GPT family (125M /
350M / 1.3B), the dense GQA decoders, and the MoE, SSM, hybrid, VLM and
audio families of the JAX package's registry, each with a reduced smoke
variant (2-3 layers, d_model <= 448, <= 4 experts)."""
from __future__ import annotations

import importlib

from ..models.config import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

ARCHS = ["qwen2_5_3b", "yi_6b", "qwen1_5_32b", "olmoe_1b_7b", "yi_34b",
         "qwen3_moe_235b_a22b", "mamba2_370m", "zamba2_7b", "qwen2_vl_72b",
         "seamless_m4t_large_v2", "gpt_125m", "gpt_350m", "gpt_1_3b"]

# the ten assigned architectures, in the JAX package's order
# (``configs/__init__.py:13-30`` there): the dry run's --all sweep
ASSIGNED = ["qwen2_5_3b", "yi_6b", "seamless_m4t_large_v2", "qwen1_5_32b", "olmoe_1b_7b",
            "yi_34b", "zamba2_7b", "qwen2_vl_72b", "qwen3_moe_235b_a22b", "mamba2_370m"]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS.update({"qwen2.5-3b": "qwen2_5_3b", "qwen1.5-32b": "qwen1_5_32b",
               "olmoe-1b-7b": "olmoe_1b_7b", "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
               "gpt-1.3b": "gpt_1_3b"})


def _mod(name: str):
    key = _ALIAS.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; the port serves {ARCHS}")
    return importlib.import_module(f".{key}", __package__)


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).smoke()
