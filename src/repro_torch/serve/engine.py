"""Batched serving engine: prefill (whole-prompt or chunked), then one token
per decode step, greedy or sampled per slot, over private KV rings or a
paged block pool.

Decoding re-gathers the quantized weights layer by layer every step —
FSDP-style serving — so each step runs the quantize and dequantize kernels
over every quantized tensor (see ``models/decode.py``).  The engine owns
the step loop, the cache and the paged pool's block operations;
``DecodeModel`` owns the math.  PyTorch runs eagerly: there is no compiled
step to cache, so the reference's per-bucket compiled chunk steps are one
function here.

Quantized-domain parameters serve with no conversion:
:func:`prepare_wire_params` keeps the dense-MLP weights of a quantized
checkpoint as their wire codes (K3 consumes them), and
:func:`make_draft_params` builds the low-bit draft of self-speculative
decoding, whose layer weights the draft engine gathers as codes.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..core import prng
from ..core.quant import (QuantConfig, QuantizedParam, qparam_decode, qparam_encode,
                          qparam_split_stack)
from ..models.decode import LANE_BLOCK, ROWQUANT_MLP, DecodeModel, DecodeSpec
from ..models.transformer import Model
from .kv_pool import PoolExhausted, decode_block, encode_block


def prepare_wire_params(model: Model, params: dict) -> dict:
    """Adapt a params dict that may hold QuantizedParam leaves (a quantized
    train state or checkpoint) for serving (reference ``engine.py:40``):
    the dense-MLP weights of a dense stack whose buckets tile their rows
    keep their wire codes, split per layer (``qparam_split_stack``), and go
    through K3 at every gather with no re-quantization; every other
    QuantizedParam is decoded to its exact f32 rest-layout values."""
    out = {}
    eng = model.engine
    for name, v in params.items():
        if not isinstance(v, QuantizedParam):
            out[name] = v
            continue
        if (model.cfg.arch_type in ("dense", "vlm") and name.startswith("layers/")
                and name.rsplit("/", 1)[-1] in ROWQUANT_MLP
                and eng.rowquant_wire_eligible(name, v)):
            out[name] = qparam_split_stack(v) if v.stacked else v
        else:
            out[name] = qparam_decode(v)
    return out


# layer weights the self-speculative draft re-quantizes to `draft_bits`: the
# large matmuls; norms, embedding and head stay shared with the serving set
DRAFT_WEIGHTS = ROWQUANT_MLP + ("wq", "wk", "wv", "wo")


def _draft_bucket(n_local: int, bits: int) -> int:
    """Per-leaf draft bucket: the largest power-of-2 divisor of the shard
    size, capped at 256 (low-bit min-max buckets that small track the
    weights), so that ``qparam_split_stack`` stays bucket-aligned; 0 where
    it does not hold whole packed bytes."""
    cpb = 8 // bits if 8 % bits == 0 else 1
    b = math.gcd(n_local, 256)
    return b if b % cpb == 0 else 0


def make_draft_params(model: Model, params: dict, draft_bits: int) -> dict:
    """The self-speculative DRAFT parameter set (reference ``engine.py:84``):
    the serving params with every large ``layers/*`` matmul weight replaced
    by its `draft_bits`-bit wire codes (deterministic nearest rounding, so
    the draft and its acceptance rate are functions of the served weights),
    split per layer.  Leaves that already are wire codes are reused as they
    are; everything else is the serving params' own tensor, no copy.  The
    draft engine gathers the codes and consumes them through K3 where the
    buckets tile the rows and K2 otherwise (``DecodeModel._gather_layer_w``)."""
    if not 2 <= draft_bits <= 8:
        raise ValueError(f"draft_bits must be in [2, 8], got {draft_bits}")
    out = {}
    for name, v in params.items():
        if (not name.startswith("layers/") or name.rsplit("/", 1)[-1] not in DRAFT_WEIGHTS
                or isinstance(v, QuantizedParam)):
            out[name] = v
            continue
        bucket = _draft_bucket(v.shape[-1], draft_bits)
        if not bucket or v.dim() not in (3, 4):
            out[name] = v
            continue
        qp = qparam_encode(v, QuantConfig(bits=draft_bits, bucket_size=bucket, mode="nearest"))
        out[name] = qparam_split_stack(qp) if qp.stacked else qp
    return out


def prefill_bucket_sizes(chunk: int, n_buckets: int, cache_len: int) -> tuple[int, ...]:
    """The padded chunk lengths of chunked prefill: `n_buckets` evenly
    spaced sizes up to the chunk size (clamped to the KV ring), deduped
    ascending.  Every chunk right-pads to the smallest bucket that fits."""
    if chunk <= 0:
        return ()
    top = min(chunk, cache_len) if cache_len else chunk
    n = max(1, min(n_buckets, top))
    return tuple(sorted({max(1, round(top * i / n)) for i in range(1, n + 1)} | {top}))


def prefill_bucket_for(length: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket that holds a chunk of `length` tokens."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"chunk of {length} tokens exceeds every bucket {buckets}")


def make_sample_params(temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                       b: int = 1) -> dict:
    """The `sample` tree of ``DecodeSpec.sampling`` engines: ONE request's
    sampling state over b slots, as host tensors (temp f32, top_k int64,
    key (b, 2) u32 words as int64)."""
    return {"temp": torch.full((b,), temperature, dtype=torch.float32),
            "top_k": torch.full((b,), top_k, dtype=torch.int64),
            "key": torch.tensor([prng.PRNGKey(seed)] * b, dtype=torch.int64).reshape(b, 2)}


def greedy_sample_params(b: int) -> dict:
    """Per-slot sampling state that keeps every row on the greedy path."""
    return make_sample_params(b=b)


class ServeEngine:
    def __init__(self, model: Model, spec: DecodeSpec, device):
        """The decode path computes at blocks of ``spec.lane_block`` lanes,
        by default LANE_BLOCK on the card and all lanes in one launch on the
        CPU (see ``models/decode.py``)."""
        self.model = model
        self.spec = spec
        self.device = torch.device(device)
        lane_block = spec.lane_block or (LANE_BLOCK if self.device.type == "cuda" else 0)
        self.dm = DecodeModel(model, spec, lane_block=lane_block)

    def decode_step(self):
        """(params, cache, tokens (B,), pos (B,), key[, sample][,
        block_tables=]) -> (next tokens, cache); pos is per slot, so every
        slot advances at its own position."""
        return self.dm.decode_fn

    def prefill_step(self):
        """(params, batch, key[, sample]) -> (next tokens (B,), a fresh
        filled cache); ring caches only."""
        if self.spec.paged:
            raise NotImplementedError("whole-prompt prefill is ring-only; paged engines "
                                      "prefill through prefill_chunk_step / "
                                      "generate(prefill_chunk=...)")

        def prefill(params, batch, key, sample=None):
            return self.dm.prefill_fn(params, batch, key, self.init_cache(), sample)
        return prefill

    def prefill_chunk_step(self, compute_len: int):
        """(params, cache, tokens (B, Lb), offset (B,), n_valid (B,), key[,
        sample][, block_tables=]) -> (next tokens, cache): chunked prefill
        over the whole slot pool, computed at `compute_len` tokens (the top
        bucket) whatever the chunk's bucket Lb."""
        return functools.partial(self.dm.prefill_chunk_fn, compute_len=compute_len)

    def verify_step(self):
        """(params, cache, tokens (B, K), pos (B,), n_spec (B,), key[,
        sample][, block_tables=]) -> (out (B, K), cache): the speculative
        verify over the whole slot pool (``DecodeModel.verify_fn``)."""
        return self.dm.verify_fn

    def init_cache(self):
        return self.dm.init_cache_local(self.device)

    # -- paged block ops (cold tier + copy-on-write) ---------------------------

    def _block_index(self, bid: int):
        """(pool row, row seq indices) of physical block `bid`: the rank's
        block_loc-token slice of every rank's share (one rank: the block's
        block_size consecutive positions)."""
        sp, tp = self.spec, self.dm.tp
        bs = sp.kv_block_size
        bpr, bl, s_loc = sp.cache_len // bs, bs // tp, sp.cache_len // tp
        i = torch.arange(bs, device=self.device)
        return bid // bpr, (i // bl) * s_loc + (bid % bpr) * bl + i % bl

    def kv_block_ops(self):
        """(extract, load, copy) over a paged cache, addressing ONE physical
        block by id: extract(cache, bid) -> (k, v) (L, block_size, n_kv, hd);
        load(cache, bid, k, v) and copy(cache, src, dst) write in place and
        return the cache.  Off the decode hot path (cold tier, COW forks)."""
        def extract(cache, bid):
            row, seq = self._block_index(int(bid))
            return cache["k"][:, row, seq], cache["v"][:, row, seq]

        def load(cache, bid, kblk, vblk):
            row, seq = self._block_index(int(bid))
            cache["k"][:, row, seq] = kblk.to(cache["k"].dtype)
            cache["v"][:, row, seq] = vblk.to(cache["v"].dtype)
            return cache

        def copy(cache, src, dst):
            kb, vb = extract(cache, src)  # advanced indexing: copies
            return load(cache, dst, kb, vb)

        return extract, load, copy

    def demote_cold_blocks(self, cache, pool, now: int) -> int:
        """Quantized cold tier: re-encode the cached (ref-0 prefix) blocks
        idle past the pool's horizon into the wire format (K1), keep the
        bytes on the host and free their hot blocks.  Reads each block
        before the pool frees it.  Returns the number demoted."""
        ids = pool.demotable(now)
        if not ids:
            return 0
        extract, _, _ = self.kv_block_ops()
        for bid in ids:
            kb, vb = extract(cache, bid)
            pool.demote(bid, encode_block(kb, vb, pool.quant_cfg), now)
        return len(ids)

    def rehydrate_block(self, cache, pool, key, now: int):
        """A cold prefix block back hot: allocate a block, decode the wire
        codes (K2), write them in.  Returns (bid, cache)."""
        bid, cold = pool.rehydrate(key, now)
        _, load, _ = self.kv_block_ops()
        kb, vb = decode_block(cold, torch.bfloat16, self.device)
        return bid, load(cache, bid, kb, vb)

    @torch.inference_mode()
    def generate(self, params, prompt_batch: dict, n_tokens: int,
                 key: Optional[prng.Key] = None, sample: Optional[dict] = None,
                 fold_step_keys: bool = True, prefill_chunk: int = 0,
                 prefill_buckets: int = 4) -> torch.Tensor:
        """Prefill the prompt, then decode to n_tokens per row (greedy unless
        a `sample` tree is given to a ``spec.sampling`` engine).  The gather
        key of decode step i is ``fold_in(key, i)``; with
        fold_step_keys=False every step reuses `key`, i.e. serves one fixed
        quantized model, which is what the continuous scheduler serves.

        prefill_chunk=C > 0 prefills in C-token chunks through
        ``prefill_chunk_step``: the scheduler's computation, run alone.  On
        that path the prompt's b rows ride lanes 0..b-1 of the engine's
        ``batch_global`` lanes and the others run dead, and chunks compute
        at the top bucket, so a request's launches have the shapes the
        scheduler's pooled launches have: this is the solo reference of the
        scheduler built from the same spec.  Paged specs lay the rows out as
        the identity block table.  Returns (b, n_tokens) token ids."""
        key = key if key is not None else prng.PRNGKey(0)
        tokens = prompt_batch["tokens"]
        b, s = tokens.shape
        sp = self.spec
        if sample is not None and not sp.sampling:
            raise ValueError("generate() got a sample tree but this engine was built "
                             "with DecodeSpec(sampling=False)")
        if sp.sampling and sample is None:
            sample = greedy_sample_params(b)
        if sp.paged and not prefill_chunk:
            raise ValueError("paged DecodeSpec serves through chunked prefill only; "
                             "pass prefill_chunk=...")
        if not prefill_chunk:
            return self._generate_whole(params, prompt_batch, n_tokens, key, sample,
                                        fold_step_keys)
        if fold_step_keys:
            raise ValueError("chunked prefill serves a fixed quantized model; pass "
                             "fold_step_keys=False")
        if sp.cache_len and s > sp.cache_len:
            raise ValueError(f"prompt ({s}) exceeds the KV ring ({sp.cache_len}); chunked "
                             "prefill cannot stream a prompt through a smaller window")
        lanes = sp.batch_global
        if b > lanes:
            raise ValueError(f"{b} prompt rows, the engine has {lanes} lanes")
        bt = None
        if sp.paged:
            bps = sp.blocks_per_slot
            need, have = b * bps, sp.pool_blocks()
            if need > have:
                raise PoolExhausted(f"KV pool exhausted: {b} lanes need {need} blocks but "
                                    f"the pool holds {have}; raise --kv-pool-blocks (or "
                                    "lower the batch)")
            bt = torch.full((lanes, bps), -1, dtype=torch.int64)
            bt[:b] = torch.arange(b * bps).reshape(b, bps)
        if sample is not None:  # dead lanes: greedy
            pad = greedy_sample_params(lanes)
            sample = {k: torch.cat([v, pad[k][b:]]) for k, v in sample.items()}
        tokens = tokens.cpu().to(torch.int64)
        buckets = prefill_bucket_sizes(prefill_chunk, prefill_buckets, sp.cache_len)
        step = self.prefill_chunk_step(buckets[-1])
        cache = self.init_cache()
        for o in range(0, s, prefill_chunk):
            clen = min(prefill_chunk, s - o)
            chunk = torch.zeros((lanes, prefill_bucket_for(clen, buckets)), dtype=torch.int64)
            chunk[:b, :clen] = tokens[:, o:o + clen]
            n_valid = torch.zeros(lanes, dtype=torch.int64)
            n_valid[:b] = clen
            nxt, cache = step(params, cache, chunk, torch.where(n_valid > 0, o, 0), n_valid,
                              key, sample, block_tables=bt)
        out = [nxt[:b]]
        dec = self.decode_step()
        for i in range(n_tokens - 1):
            pos = torch.full((lanes,), -1, dtype=torch.int64)
            pos[:b] = s + i
            nxt, cache = dec(params, cache, nxt, pos, key, sample, block_tables=bt)
            out.append(nxt[:b])
        return torch.stack(out, dim=1)

    def _generate_whole(self, params, prompt_batch, n_tokens, key, sample, fold_step_keys):
        b, s = prompt_batch["tokens"].shape
        nxt, cache = self.prefill_step()(params, prompt_batch, key, sample)
        out = [nxt]
        dec = self.decode_step()
        for i in range(n_tokens - 1):
            # host positions where the sampler needs them, else on the card
            pos = torch.full((b,), s + i, dtype=torch.int64,
                             device="cpu" if sample is not None else self.device)
            k = prng.fold_in(key, i) if fold_step_keys else key
            nxt, cache = dec(params, cache, nxt, pos, k, sample)
            out.append(nxt)
        return torch.stack(out, dim=1)
