"""Weights exchange with the JAX package.

The port keeps the JAX package's rest layout — every parameter flat and
zero-padded as ``(stack?, MODEL, FSDP, n_local)`` f32 — so a params dict of
the JAX package, handed over as numpy arrays, is the port's params dict.
"""
from __future__ import annotations



import numpy as np
import torch


def params_from_jax(np_params: dict, device="cpu", model=None) -> dict[str, torch.Tensor]:
    """{name: numpy rest-layout array} -> {name: f32 tensor on `device`}.

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
    out = {}
    for name, v in np_params.items():
        a = np.asarray(v)
        if a.dtype != np.float32:
            raise TypeError(f"{name}: rest-layout params are float32, got {a.dtype}")
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return out



