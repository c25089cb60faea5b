"""Device choice of the port's entry points: the card unless the caller
asks for another device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as given, else the first CUDA device; raises when no CUDA
    device exists and none was asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "device='cpu' to run the plain versions of its kernels")
    return torch.device("cuda")
