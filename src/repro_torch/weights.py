"""Weights and train-state exchange with the JAX package.

The port keeps the JAX package's rest layout — every parameter flat and
zero-padded as ``(stack?, MODEL, FSDP, n_local)`` f32 — so a params dict of
the JAX package, handed over as numpy arrays, is the port's params dict.
A whole train state travels in the checkpoint's flat form (npz keys and
manifest entries), so both packages can start a step from the same state.
On a (P, M) mesh the JAX package's arrays are the whole ``(stack?, MODEL,
FSDP, n_local)`` leaves, and each rank takes its block: row `model_rank` of
the model axis (-3), column `rank` of the FSDP axis (-2), `rank` the FSDP
index (data-major on a pod mesh, ``d·Q + q``: the engine's ``rank``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.qsdp import rank_block
from .device import resolve_device


def params_from_jax(np_params: dict, device=None, model=None,
                    rank: int = 0, model_rank: int = 0) -> dict[str, torch.Tensor]:
    """{name: numpy rest-layout array} -> {name: f32 tensor on `device`}
    (the card unless given): the block of each array at data rank `rank`
    and model rank `model_rank`, the whole array at one rank.

    With `model` (a ``models.transformer.Model``), the names and rest shapes
    are checked against the port's parameter specs."""
    if model is not None:
        want = {n: s.rest_shape(model.ms) for n, s in model.specs.items()}
        got = {n: tuple(np.shape(v)) for n, v in np_params.items()}
        if want != got:
            raise ValueError(f"params do not match the model: missing "
                             f"{sorted(set(want) - set(got))}, extra "
                             f"{sorted(set(got) - set(want))}, shape mismatch "
                             f"{sorted(n for n in set(want) & set(got) if want[n] != got[n])}")
    device = resolve_device(device)
    out = {}
    for name, v in np_params.items():
        a = np.asarray(v)
        if a.dtype != np.float32:
            raise TypeError(f"{name}: rest-layout params are float32, got {a.dtype}")
        out[name] = torch.from_numpy(np.array(_block(a, rank, model_rank))).to(device)
    return out


def _block(a: np.ndarray, rank: int, model_rank: int) -> np.ndarray:
    """The (rank, model_rank) block of a rest-layout (or wire) array, whose
    axes -3 and -2 are the model and FSDP axes; arrays of rank below 3 (the
    step) as they are."""
    return (rank_block(a, rank, a.shape[-2], model_rank, a.shape[-3]) if a.ndim >= 3
            else a)


def train_state_from_jax(flat: dict, leaves: dict, device=None, model=None,
                         rank: int = 0, model_rank: int = 0):
    """A train state of the JAX package in its checkpoint form -- ``{npz key:
    numpy array}`` and ``{npz key: manifest entry}`` (``params/<name>``,
    ``opt/step``, ``opt/mu/<name>``, ``opt/nu/<name>``; QuantizedParam
    leaves as their wire bytes) -> the port's ``TrainState`` on `device`
    (the card unless given), the (rank, model_rank) block of every leaf.
    With `model`, the dense param leaves are checked against its specs."""
    from .train.checkpoint import state_from_flat
    state = state_from_flat({k: _block(np.asarray(v), rank, model_rank)
                             for k, v in flat.items()},
                            leaves, device)
    if model is not None:
        want = {n: s.local_shape(model.ms) for n, s in model.specs.items()}
        got = state.params
        bad = sorted(n for n in set(want) | set(got)
                     if n not in want or n not in got
                     or (isinstance(got[n], torch.Tensor) and tuple(got[n].shape) != want[n]))
        if bad:
            raise ValueError(f"train state does not match the model's params: {bad}")
    return state
