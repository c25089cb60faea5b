"""Tensor-parallel collectives (Megatron's f/g), the JAX package's
``core/tp.py``:

    tp_copy   : identity forward, psum over the model axis backward
    tp_reduce : psum over the model axis forward, identity backward

The port runs at tensor-parallel size 1, where both directions of both are
the identity, so returning `x` gives autograd the right backward; a model
group of more than one rank raises ``NotImplementedError`` (ROADMAP A4b).
"""
from __future__ import annotations

import torch

from .collectives import require_one_rank


def tp_copy(x: torch.Tensor, group=None) -> torch.Tensor:
    require_one_rank(group)
    return x


def tp_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    require_one_rank(group)
    return x
