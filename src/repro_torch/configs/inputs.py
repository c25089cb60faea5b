"""input_specs(): stand-ins for every model input of every (architecture x
input-shape) pair at one rank, as the JAX package's ``configs/inputs.py``
gives ``ShapeDtypeStruct``s for its dry run: tensors on the meta device,
which hold shapes and dtypes and no data, so nothing is allocated.

Shape kinds and their inputs (beside the parameters):

  train    -> (batch, key): tokens, labels (B, S) [, modality stubs]
  prefill  -> (batch, key): tokens (B, S) [, modality stubs]
  decode   -> (cache, tokens (B,), positions (B,), key)

Modality stubs: VLM ``vision_embeds`` (B, S, d) bf16 patch embeddings,
``vision_mask`` (B, S) and M-RoPE ``positions`` (3, B, S); audio
``audio_embeds`` (B, S_enc, d) bf16 frame embeddings, S_enc = S //
``enc_frames_ratio`` in training and the decode spec's capped ``enc_len``
in the prefill, as in the reference.

The decode cache is the meta cache of ``DecodeModel.init_cache_local``.
The decode path keeps its control tensors on the host (the positions, read
with ``.cpu()`` to find each lane's ring slot), so the positions are a
real, small CPU tensor: every slot at the shape's last position, ``seq_len
- 1``, so each reads the full cache (the reference's per-slot positions
are traced, with no value).  The key is a host key, as every key of the
port is.
"""
from __future__ import annotations

import torch

from ..core import prng
from ..models.config import ModelConfig, ShapeConfig
from ..models.decode import DecodeModel, make_decode_spec
from ..models.transformer import Model

META = torch.device("meta")


def _token_batch(cfg: ModelConfig, b: int, s: int, with_labels: bool) -> dict:
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    if with_labels:
        batch["labels"] = torch.empty((b, s), dtype=torch.int32, device=META)
    if cfg.arch_type == "vlm":
        batch["vision_embeds"] = torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16,
                                             device=META)
        batch["vision_mask"] = torch.empty((b, s), dtype=torch.bool, device=META)
        batch["positions"] = torch.empty((3, b, s), dtype=torch.int32, device=META)
    if cfg.arch_type == "audio":
        s_enc = max(s // cfg.enc_frames_ratio, 1)
        batch["audio_embeds"] = torch.empty((b, s_enc, cfg.d_model), dtype=torch.bfloat16,
                                            device=META)
    return batch


def input_specs(model: Model, shape: ShapeConfig, dm: DecodeModel | None = None):
    """(kind, args): the step's non-parameter inputs (see the module
    docstring).  Decode and prefill take the DecodeModel `dm` the step runs
    (its cache and lanes); made from ``make_decode_spec`` if not given."""
    cfg = model.cfg
    key = prng.PRNGKey(0)
    if shape.kind == "train":
        if shape.global_batch % model.ms.fsdp_size:
            raise ValueError(f"batch {shape.global_batch} does not split over "
                             f"{model.ms.fsdp_size} FSDP ranks")
        return "train", (_token_batch(cfg, shape.global_batch, shape.seq_len, True), key)
    dm = dm or DecodeModel(model, make_decode_spec(model, shape))
    if shape.kind == "prefill":
        batch = _token_batch(cfg, shape.global_batch, shape.seq_len, False)
        if cfg.arch_type == "audio":
            # decode-time cross KV is capped; the prefill uses the capped length
            s_enc = dm.spec.enc_len or max(shape.seq_len // cfg.enc_frames_ratio, 1)
            batch["audio_embeds"] = torch.empty((shape.global_batch, s_enc, cfg.d_model),
                                                dtype=torch.bfloat16, device=META)
        return "prefill", (batch, key)
    tokens = torch.empty((shape.global_batch,), dtype=torch.int32, device=META)
    pos = torch.full((shape.global_batch,), shape.seq_len - 1, dtype=torch.int64)
    return "decode", (dm.init_cache_local(META), tokens, pos, key)
