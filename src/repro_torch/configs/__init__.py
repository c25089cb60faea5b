"""Architecture registry of the port: the paper's own GPT family (125M /
350M / 1.3B), each with a reduced smoke variant (2 layers, d_model 256).
The other families of the JAX package's registry come with ROADMAP A11."""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = ["gpt_125m", "gpt_350m", "gpt_1_3b"]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS["gpt-1.3b"] = "gpt_1_3b"


def _mod(name: str):
    key = _ALIAS.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; the port serves {ARCHS} "
                         "(other families: ROADMAP A11)")
    return importlib.import_module(f".{key}", __package__)


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _mod(name).smoke()
