"""Paged KV block pool: host-side bookkeeping for paged serving
(``serve/kv_pool.py`` of the JAX package).

The serve stack's KV cache is a pool of fixed-size blocks instead of one
private ring per slot.  The cache tensors keep the ring's layout — (L, R,
cache_len, n_kv, hd), each row read as ``cache_len // block_size``
physical blocks (``models.attention.paged_gather_kv``) — so a physical
block is one int id and per-slot block tables map logical block index ->
physical id.  Everything on the device is a gather (attend) or an indexed
write of the kept targets (KV write) through those tables; everything
stateful lives HERE, in plain Python on the host:

* **alloc / free / refcount**: a free list plus per-block refcounts.
  Blocks shared by several requests (prefix hits) carry ref > 1 and are
  read-only; a writer copies on write first (``cow_fork``).
* **prefix table**: full prompt blocks are registered under a chained
  structural key (the previous block's key + this block's tokens), so
  distinct prefixes never alias; a new request shares every hit of its
  prompt's chain read-only and skips that prefix's prefill.
* **deferred reclaim**: a retired request's registered blocks drop to ref
  0 and stay resident in an LRU of cached blocks, evicted only when an
  allocation needs a block (or demoted, below); unregistered blocks
  (generated tokens) free at once.
* **quantized cold tier**: cached blocks idle past a horizon are
  re-encoded into the ``core.quant`` wire format (packed codes + per-bucket
  f32 scale/zero, "nearest" rounding: on the card K1) held on the host, and
  their hot block returns to the free list; a prefix hit on a cold block
  decodes it (K2) into a fresh block.  ``encode_block``/``decode_block``
  round-trip equals ``block_qdq_reference`` bit for bit.

The pool never touches device memory: the scheduler and engine own the
cache tensors and ask the pool which block ids to read, write, copy or
drop, so every invariant (no double free, no leak, no aliasing) is a
host-side property.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict, deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.quant import (QuantConfig, dequantize, quantize, quantize_dequantize,
                          wire_pack, wire_segment_bytes, wire_unpack)


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied even after evicting
    every reclaimable (ref-0 cached) block."""


def prefix_keys(prompt: Sequence[int], block_size: int) -> list:
    """Chained keys for every FULL block of `prompt`: ``key_j = (key_{j-1},
    tuple(block_j tokens))``, structural equality on the tokens themselves,
    so two distinct prefixes never collide.  A partial trailing block gets
    no key: only full blocks are sharable."""
    keys = []
    prev = None
    for j in range(len(prompt) // block_size):
        prev = (prev, tuple(int(t) for t in prompt[j * block_size:(j + 1) * block_size]))
        keys.append(prev)
    return keys


def kv_quant_config(bits: int, bucket_size: int = 128) -> QuantConfig:
    """The cold-tier codec: nearest rounding (no key: a cold block decodes
    to the same bytes every time) with f32 wire metadata, so encode/decode
    equals the plain quantize-dequantize reference bit for bit."""
    return QuantConfig(bits=bits, bucket_size=bucket_size, mode="nearest",
                       meta_dtype="float32")


@dataclasses.dataclass
class ColdBlock:
    """One demoted block: host wire bytes of k and v, and what decodes them."""

    k_wire: torch.Tensor  # (wire bytes,) u8, on the host
    v_wire: torch.Tensor
    shape: tuple  # (L, block_size, n_kv, hd): the hot shape
    cfg: QuantConfig

    @property
    def nbytes(self) -> int:
        return self.k_wire.numel() + self.v_wire.numel()


def encode_block(k: torch.Tensor, v: torch.Tensor, cfg: QuantConfig) -> ColdBlock:
    """(L, bs, n_kv, hd) bf16/f32 block pair -> ColdBlock; the quantize runs
    where the block lies (K1 on the card), the wire bytes go to the host."""
    def wire(x):
        return wire_pack(quantize(x.to(torch.float32), cfg)).cpu()
    return ColdBlock(k_wire=wire(k), v_wire=wire(v), shape=tuple(k.shape), cfg=cfg)


def decode_block(cold: ColdBlock, dtype=torch.bfloat16, device="cpu"):
    """ColdBlock -> (k, v) of `cold.shape` in `dtype` on `device`: the wire
    decode (``wire_unpack`` + ``dequantize``; K2 on the card)."""
    n = math.prod(cold.shape)
    return tuple(dequantize(wire_unpack(w.to(device), n, cold.cfg, cold.shape), dtype)
                 for w in (cold.k_wire, cold.v_wire))


def block_qdq_reference(x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """The quantize-dequantize reference the cold-tier round trip matches
    bit for bit (f32)."""
    return quantize_dequantize(x.to(torch.float32), cfg)


class BlockPool:
    """Host-side allocator + prefix cache + cold tier over `n_blocks`
    physical KV blocks of `block_size` (global) tokens each.

    `hot_block_bytes` (optional) is the device bytes of one resident block
    (all layers, k+v) — only used for the capacity stats."""

    def __init__(self, n_blocks: int, block_size: int, *,
                 quant_bits: int = 0, quant_horizon: int = 0,
                 quant_bucket: int = 128, hot_block_bytes: int = 0):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.quant_bits = int(quant_bits)
        self.quant_horizon = int(quant_horizon)
        self.quant_cfg = (kv_quant_config(quant_bits, quant_bucket)
                          if quant_bits else None)
        self.hot_block_bytes = hot_block_bytes
        self._free: deque[int] = deque(range(n_blocks))
        self._ref = np.zeros(n_blocks, np.int64)
        self._key_of: dict[int, object] = {}  # bid -> prefix key
        self._bid_of: dict[object, int] = {}  # prefix key -> bid
        self._cached: OrderedDict[int, int] = OrderedDict()  # bid -> last-use
        self._cold: "OrderedDict[object, ColdBlock]" = OrderedDict()
        self._cold_idle: dict[object, int] = {}  # key -> last-use step
        self.stats = dict(allocs=0, frees=0, prefix_hits=0, prefix_misses=0,
                          cow_forks=0, evictions=0, demotions=0,
                          rehydrations=0, cold_evictions=0)

    # -- invariant probes (the property suite leans on these) ---------------

    @property
    def free_blocks(self) -> int:
        """Blocks an alloc() can obtain right now (free + reclaimable)."""
        return len(self._free) + len(self._cached)

    @property
    def blocks_in_use(self) -> int:
        """Blocks pinned by a live reference (ref > 0)."""
        return int((self._ref > 0).sum())

    @property
    def blocks_cached(self) -> int:
        return len(self._cached)

    @property
    def cold_blocks(self) -> int:
        return len(self._cold)

    def cold_bytes(self) -> int:
        return sum(c.nbytes for c in self._cold.values())

    def check_invariants(self) -> None:
        """Every block is in exactly one of {free, cached (ref 0), ref>0};
        the prefix table maps are mutually inverse."""
        free = set(self._free)
        cached = set(self._cached)
        live = {int(b) for b in np.nonzero(self._ref > 0)[0]}
        assert not (free & cached), (free & cached)
        assert not (free & live), (free & live)
        assert not (cached & live), (cached & live)
        assert free | cached | live == set(range(self.n_blocks)), (
            free, cached, live)
        assert (self._ref >= 0).all(), self._ref
        for bid, key in self._key_of.items():
            assert self._bid_of.get(key) == bid, (bid, key)
        assert len(self._bid_of) == len(self._key_of)
        for bid in cached:
            assert bid in self._key_of, bid  # only registered blocks cache

    # -- alloc / free / refcount --------------------------------------------

    def alloc(self, now: int = 0) -> int:
        """One free block id (ref = 1).  Evicts the LRU cached block when
        the free list is empty (demoting it to the cold tier first when the
        tier is on); raises PoolExhausted when nothing is reclaimable."""
        if not self._free:
            self._evict_one(now)
        if not self._free:
            raise PoolExhausted(
                f"KV block pool exhausted: all {self.n_blocks} blocks are "
                "referenced by live requests (no cached block to reclaim); "
                "raise --kv-pool-blocks or retire requests first")
        bid = self._free.popleft()
        self._ref[bid] = 1
        self.stats["allocs"] += 1
        return bid

    def _evict_one(self, now: int) -> None:
        if not self._cached:
            return
        bid, _ = self._cached.popitem(last=False)  # LRU
        key = self._key_of.pop(bid)
        del self._bid_of[key]
        self._free.append(bid)
        self.stats["evictions"] += 1

    def incref(self, bid: int) -> None:
        if self._ref[bid] < 1:
            raise RuntimeError(f"incref of unreferenced block {bid}")
        self._ref[bid] += 1

    def decref(self, bid: int, now: int = 0) -> None:
        """Drop one reference.  ref 0 + registered -> deferred reclaim (LRU
        cache); ref 0 unregistered -> freed immediately.  A decref below
        zero is a double-free and raises."""
        if self._ref[bid] < 1:
            raise RuntimeError(f"double free of block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            if bid in self._key_of:
                self._cached[bid] = now
                self._cached.move_to_end(bid)
            else:
                self._free.append(bid)
            self.stats["frees"] += 1

    def ref(self, bid: int) -> int:
        return int(self._ref[bid])

    # -- prefix table --------------------------------------------------------

    def register(self, key, bid: int) -> None:
        """Publish a (ref > 0) block under a prefix key.  First writer wins:
        re-registering an existing key is a no-op (the two blocks hold
        byte-identical content by construction — same tokens, same fixed
        model, same chunk decomposition)."""
        if key in self._bid_of:
            return
        if self._ref[bid] < 1:
            raise RuntimeError(f"register of unreferenced block {bid}")
        if bid in self._key_of:  # one key per block
            return
        self._key_of[bid] = key
        self._bid_of[key] = bid
        # content under `key` now resident hot: a stale cold copy (possible
        # after eviction raced a re-prefill) would just waste bytes
        self._cold.pop(key, None)
        self._cold_idle.pop(key, None)

    def is_registered(self, bid: int) -> bool:
        return bid in self._key_of

    def unregister(self, bid: int) -> None:
        """Withdraw a block from the prefix table (its content is about to
        change — ring wrap overwrite — or its request chain broke)."""
        key = self._key_of.pop(bid, None)
        if key is not None:
            del self._bid_of[key]
        self._cached.pop(bid, None)
        if key is not None and self._ref[bid] == 0:
            # was cached (ref 0): nothing references it and it is no longer
            # findable — straight back to the free list
            self._free.append(bid)

    def lookup(self, key, now: int = 0) -> Optional[int]:
        """Prefix hit: return the hot block id for `key` with a NEW
        reference taken (un-caching it if it was in deferred reclaim), or
        None.  Cold blocks do NOT hit here — use lookup_cold + rehydrate."""
        bid = self._bid_of.get(key)
        if bid is None:
            self.stats["prefix_misses"] += 1
            return None
        if self._ref[bid] == 0:
            self._cached.pop(bid, None)
            self._ref[bid] = 1
        else:
            self._ref[bid] += 1
        self.stats["prefix_hits"] += 1
        return bid

    def touch(self, bid: int, now: int) -> None:
        if bid in self._cached:
            self._cached[bid] = now
            self._cached.move_to_end(bid)

    # -- copy-on-write -------------------------------------------------------

    def cow_fork(self, bid: int, now: int = 0) -> int:
        """A writer holding one reference to shared block `bid` wants a
        private copy: allocate a fresh block, drop the writer's reference to
        the shared one.  The CALLER must device-copy bid's bytes into the
        returned id before writing (that copy is what preserves the other
        readers' view).  Returns the new private block id."""
        new = self.alloc(now)
        self.decref(bid, now)
        self.stats["cow_forks"] += 1
        return new

    # -- quantized cold tier -------------------------------------------------

    def demotable(self, now: int) -> list[int]:
        """Cached block ids idle for >= quant_horizon steps (oldest first).
        Empty when the tier is off."""
        if not self.quant_cfg or self.quant_horizon <= 0:
            return []
        return [bid for bid, last in self._cached.items()
                if now - last >= self.quant_horizon]

    def demote(self, bid: int, cold: ColdBlock, now: int = 0) -> None:
        """Move a cached block to the cold store (caller already encoded its
        bytes): the hot block returns to the free list; the prefix key now
        resolves through lookup_cold."""
        if bid not in self._cached:
            raise RuntimeError(f"demote of non-cached block {bid}")
        key = self._key_of.pop(bid)
        del self._bid_of[key]
        del self._cached[bid]
        self._free.append(bid)
        self._cold[key] = cold
        self._cold_idle[key] = now
        self.stats["demotions"] += 1

    def lookup_cold(self, key) -> Optional[ColdBlock]:
        return self._cold.get(key)

    def rehydrate(self, key, now: int = 0) -> tuple[int, ColdBlock]:
        """Cold hit: allocate a hot block for `key`'s content and re-register
        it.  The CALLER decodes the returned ColdBlock into the returned
        block id (bit-exact wire decode).  The cold copy is dropped."""
        cold = self._cold.pop(key)
        self._cold_idle.pop(key, None)
        bid = self.alloc(now)
        self._key_of[bid] = key
        self._bid_of[key] = bid
        self.stats["rehydrations"] += 1
        return bid, cold

    # -- capacity accounting -------------------------------------------------

    def capacity_stats(self) -> dict:
        """The bench columns: hot occupancy, prefix-cache effectiveness and
        the cold tier's capacity multiplier."""
        hits = self.stats["prefix_hits"]
        misses = self.stats["prefix_misses"]
        hot_b = self.hot_block_bytes
        cold_per_block = (self.block_kv_wire_bytes()
                          if self.quant_cfg else 0)
        # bytes multiplier of the cold representation, and total context
        # blocks resident (hot capacity + every demoted block's context,
        # each held at 1/compression of a hot block's bytes)
        compression = hot_b / cold_per_block if hot_b and cold_per_block else 1.0
        eff = self.n_blocks + len(self._cold)
        return dict(
            blocks_total=self.n_blocks,
            blocks_in_use=self.blocks_in_use,
            blocks_cached=self.blocks_cached,
            blocks_free=len(self._free),
            cold_blocks=len(self._cold),
            cold_bytes=self.cold_bytes(),
            hot_block_bytes=hot_b,
            prefix_hit_rate=hits / (hits + misses) if hits + misses else 0.0,
            cold_compression=compression,
            effective_capacity=float(eff),
            **self.stats,
        )

    def block_kv_wire_bytes(self) -> int:
        """Cold bytes of one block (k + v) — needs hot_block_bytes to infer
        the element count (bf16: 2 bytes/elem)."""
        if not (self.quant_cfg and self.hot_block_bytes):
            return 0
        n = self.hot_block_bytes // 2 // 2  # elems per tensor (k or v)
        return 2 * wire_segment_bytes(n, self.quant_cfg)
