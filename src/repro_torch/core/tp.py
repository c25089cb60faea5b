"""Tensor-parallel collectives (Megatron's f/g) — the forward of the JAX
package's ``core/tp.py``:

    tp_copy   : identity forward (psum backward, with the training slice)
    tp_reduce : psum over the model axis forward

This slice serves at tensor-parallel size 1, where both are the identity;
a model group of more than one rank raises ``NotImplementedError``
(ROADMAP A4).
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
