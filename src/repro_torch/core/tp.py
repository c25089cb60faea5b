"""Tensor-parallel collectives (Megatron's f/g), the JAX package's
``core/tp.py``, over the rank's model group:

    tp_copy   : identity forward, sum over the model group backward
    tp_reduce : sum over the model group forward, identity backward

and the model-axis sum and max the vocab-parallel cross-entropy, the
engine's ``grad_sync_model`` and the train step's loss and norm take
(the reference's ``psum`` and ``pmax`` over "model").  On a model axis of
one rank (``group=None``, or a group of one) each of them is the identity
and calls nothing, as the reference compiles a size-1 axis's psum away.

The token-split forms (``tp_split_tokens``, ``tp_merge_tokens``,
``tp_all_gather``) serve expert parallelism and serving over ranks (ROADMAP
A11h, A10e) and are not ported.
"""
from __future__ import annotations

import torch

from . import collectives as coll


def model_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x` summed over the model group in rank order (``collectives.
    ordered_sum``; no autograd: a value or a cotangent)."""
    return x if coll.group_size(group) == 1 else coll.ordered_sum(x, group)


def model_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max of `x` over the model group (no autograd)."""
    return x if coll.group_size(group) == 1 else coll.all_reduce_max(x, group)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return model_sum(ct, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return model_sum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def tp_copy(x: torch.Tensor, group=None) -> torch.Tensor:
    """Entry into a column-parallel region from replicated activations."""
    return x if coll.group_size(group) == 1 else _Copy.apply(x, group)


def tp_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Exit from a row-parallel region: the ranks' partial outputs summed."""
    return x if coll.group_size(group) == 1 else _Reduce.apply(x, group)
