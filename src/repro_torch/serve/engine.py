"""Batched serving engine: whole-prompt prefill, then one greedy token per
decode step.

Decoding re-gathers the quantized weights layer by layer every step —
FSDP-style serving — so each step runs the quantize and dequantize kernels
over every quantized tensor (see ``models/decode.py``).  The engine owns
the step loop and the cache; ``DecodeModel`` owns the math.  PyTorch runs
eagerly: there is no compiled step to cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import prng
from ..models.decode import DecodeModel, DecodeSpec
from ..models.transformer import Model


class ServeEngine:
    def __init__(self, model: Model, spec: DecodeSpec, device):
        self.model = model
        self.spec = spec
        self.device = torch.device(device)
        self.dm = DecodeModel(model, spec)

    def decode_step(self):
        """(params, cache, tokens (B,), pos (B,), key) -> (next tokens, cache)."""
        return self.dm.decode_fn

    def prefill_step(self):
        """(params, batch, key) -> (next tokens (B,), a fresh filled cache)."""
        def prefill(params, batch, key):
            return self.dm.prefill_fn(params, batch, key, self.init_cache())
        return prefill

    def init_cache(self):
        return self.dm.init_cache_local(self.device)

    @torch.inference_mode()
    def generate(self, params, prompt_batch: dict, n_tokens: int,
                 key: Optional[prng.Key] = None,
                 fold_step_keys: bool = True) -> torch.Tensor:
        """Prefill the prompt, then decode greedily to n_tokens per row.

        The gather key of decode step i is ``fold_in(key, i)``; with
        fold_step_keys=False every step reuses `key`, i.e. serves one fixed
        quantized model.  Returns (B, n_tokens) token ids."""
        key = key if key is not None else prng.PRNGKey(0)
        b, s = prompt_batch["tokens"].shape
        nxt, cache = self.prefill_step()(params, prompt_batch, key)
        out = [nxt]
        dec = self.decode_step()
        for i in range(n_tokens - 1):
            pos = torch.full((b,), s + i, dtype=torch.int64, device=self.device)
            k = prng.fold_in(key, i) if fold_step_keys else key
            nxt, cache = dec(params, cache, nxt, pos, k)
            out.append(nxt)
        return torch.stack(out, dim=1)
