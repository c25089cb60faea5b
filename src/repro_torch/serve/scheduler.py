"""Continuous-batching request scheduler over the ServeEngine
(``serve/scheduler.py`` of the JAX package).

The scheduler owns a fixed pool of ``B = spec.batch_global`` decode slots.
Queued requests are admitted into freed slots mid-decode, by one of two
admission paths:

* **Blocking (``prefill_chunk=0``)**: a batch-of-1 whole-prompt prefill
  writes the prompt's KV (the slot's whole ring) and that one-slot cache is
  copied into the slot's lane of the pool cache in place.  Every queued
  prompt stalls the pooled decode for its full length.
* **Chunked (``prefill_chunk=C``)**: prompts prefill C tokens at a time
  through ``ServeEngine.prefill_chunk_step``: each scheduler step advances
  every prefilling slot by at most one chunk (one pooled launch for all of
  them), written straight into the slot's KV at its chunk offset, beside the
  pooled decode.  Chunks are right-padded into a few length buckets (the
  reference's bound on compiled traces, kept for its statistics); the
  launch computes at the top bucket.  ``prefill_interleave`` is the
  fairness knob: chunk launches per scheduler step.  With a paged spec the
  KV lives in a pool of blocks (``serve/kv_pool.py``): admission shares the
  cached blocks of a prompt's prefix read-only, a slot copies a shared
  block before it writes it (ring wrap), and idle cached blocks demote to a
  quantized cold tier.

With a speculative spec (``DecodeSpec(draft_bits, draft_depth)``) each
decode step drafts up to ``draft_depth - 1`` tokens per slot on a low-bit
draft engine over the same cache (``make_draft_params``), then verifies
them at serving precision in one ``verify_fn`` pass and commits the
longest prefix the verifier agrees with plus its own next token.

Dead lanes (never filled, retired, or mid-chunked-prefill) carry ``pos =
-1``: the decode step writes none of their KV, their attention sees no
valid slot, and their sampling row is greedy.  Nothing a dead lane computes
can reach a live lane.

Invariants (held by the CPU tests against the JAX package and by
``chip_smoke.py`` on the card):

* **Slot isolation**: a greedy request's tokens are bit-identical whether
  it runs alone (``ServeEngine.generate(..., fold_step_keys=False)`` with
  the matching ``prefill_chunk``, on a batch-of-1 engine) or interleaved
  with other requests here, speculative or not.  On the card this needs
  every launch to compute at one shape whatever the batch composition:
  cuBLAS's GEMMs and batched attention products are not row-invariant
  across row counts, so every launch runs at whole blocks of the spec's
  lane block (a batch-of-1 engine pads its lane with dead ones), and
  chunks compute at the top bucket.
* **Fixed served model**: one ``gather_key`` for every prefill chunk and
  decode step.
* **Reproducible sampling**: a request's sampling stream is keyed by
  ``fold_in(PRNGKey(request.seed), position)``, a function of the request
  alone.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core import prng
from ..models.decode import CHUNKED_PREFILL_ARCHS, DecodeSpec
from ..models.transformer import Model
from .engine import (ServeEngine, make_draft_params, make_sample_params, prefill_bucket_for,
                     prefill_bucket_sizes)
from .kv_pool import BlockPool, PoolExhausted, prefix_keys


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  temperature <= 0 (or top_k == 1) decodes
    greedily, bit-exact with the greedy engine path; top_k <= 0 means no
    top-k restriction."""

    rid: str
    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_id: Optional[int] = None

    @property
    def needs_sampling(self) -> bool:
        return self.temperature > 0.0 and self.top_k != 1


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed token: request `rid` produced its `index`-th token."""

    rid: str
    token: int
    index: int
    done: bool


@dataclasses.dataclass
class CompletedRequest:
    rid: str
    tokens: np.ndarray  # (n_generated,) int32, includes the EOS if hit
    submit_step: int  # scheduler decode-step count at submit()
    admit_step: int  # ... when the request entered a slot
    finish_step: int  # ... when the last token was produced
    submit_time: float
    finish_time: float
    first_token_step: int = 0  # ... when token 0 (the prefill token) landed
    first_token_time: float = 0.0  # wall clock of token 0 (TTFT source)


@dataclasses.dataclass
class _Slot:
    req: Request
    n_out: int  # tokens generated so far (incl. the prefill token)
    pf_off: int = 0  # prompt tokens already prefilled (chunked admission)
    prefilling: bool = False  # True until the last chunk lands
    # paged-pool bookkeeping (spec.paged only)
    pkeys: Optional[list] = None  # chained prefix keys of the full prompt blocks
    n_registered: int = 0  # prompt blocks already published to the prefix table
    reserve: int = 0  # worst-case future block allocs still owed to this lane


def _splice_slot(pool: dict, one: dict, slot: int) -> dict:
    """Copy a batch-of-1 prefill cache into lane `slot` of the pool cache
    (batch axis 1 of every leaf), in place: only that lane's bytes change."""
    for k, v in pool.items():
        v[:, slot] = one[k][:, 0].to(v.dtype)
    return pool


def _default_batch(tokens: np.ndarray, device) -> dict:
    return {"tokens": torch.as_tensor(tokens, dtype=torch.int64).to(device)}


def _host(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


class ContinuousScheduler:
    """Fixed-slot continuous batching over one model / parameter set.

    model, spec, params, device: as for :class:`ServeEngine`;
    ``spec.batch_global`` is the slot-pool size B (``spec.sampling`` serves
    temperature/top-k requests).  gather_key: the ONE weight-gather key of
    every prefill and decode step (default PRNGKey(0)).  batch_builder:
    ``tokens (1, s) -> prefill batch dict`` for blocking admission.
    prefill_chunk: 0 = blocking batch-of-1 admission, C > 0 = chunked
    admission.  prefill_buckets: bucket count for chunk right-padding.
    prefill_interleave: chunk launches per scheduler step.  kv_quant_bits /
    kv_quant_horizon: the paged pool's cold tier; kv_prefix_share: share
    cached prompt blocks (paged)."""

    def __init__(self, model: Model, spec: DecodeSpec, params: dict, device,
                 gather_key: Optional[prng.Key] = None,
                 batch_builder: Optional[Callable] = None,
                 prefill_chunk: int = 0, prefill_buckets: int = 4,
                 prefill_interleave: int = 1,
                 kv_quant_bits: int = 0, kv_quant_horizon: int = 0,
                 kv_prefix_share: bool = True):
        self.model = model
        self.spec = spec
        self.params = params
        self.device = torch.device(device)
        self.B = spec.batch_global
        self.gather_key = gather_key if gather_key is not None else prng.PRNGKey(0)
        # not a bound method of self: the scheduler would hold itself in a
        # reference cycle, and its cache would outlive it until a GC pass
        self.batch_builder = batch_builder or functools.partial(_default_batch,
                                                                device=self.device)
        self.engine = ServeEngine(model, spec, self.device)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0 (0 = blocking admission), "
                             f"got {prefill_chunk}")
        if spec.paged and not self.prefill_chunk:
            raise ValueError("paged DecodeSpec(kv_block_size > 0) requires chunked "
                             "admission; pass prefill_chunk > 0")
        if self.prefill_chunk and model.cfg.arch_type not in CHUNKED_PREFILL_ARCHS:
            raise ValueError(f"prefill_chunk requires an arch in {CHUNKED_PREFILL_ARCHS}; "
                             f"{model.cfg.arch_type!r} prefills whole-prompt (prefill_chunk=0)")
        self.prefill_interleave = max(int(prefill_interleave), 1)
        self.buckets = prefill_bucket_sizes(self.prefill_chunk, prefill_buckets,
                                            spec.cache_len)
        # batch-of-1 prefill engine (blocking admission), same ring layout
        self._pf_spec = dataclasses.replace(spec, batch_global=1, batch_sharded=False)
        self.prefill_engine = ServeEngine(model, self._pf_spec, self.device)
        # self-speculative decoding: a low-bit draft of the same weights over
        # the same cache; the verifier re-scores every drafted token
        self.draft_engine: Optional[ServeEngine] = None
        self.draft_params: Optional[dict] = None
        if spec.speculative:
            self.draft_params = make_draft_params(model, params, spec.draft_bits)
            self.draft_engine = ServeEngine(model, spec, self.device)

        # paged pool: block tables map each lane's logical block index ->
        # physical block; every valid entry holds one pool reference
        self.pool: Optional[BlockPool] = None
        self.block_tables: Optional[np.ndarray] = None
        self._reserved = 0  # sum of live lanes' worst-case future allocs
        self.prefix_share = bool(kv_prefix_share)
        if spec.paged:
            (shp, dt), _ = self.engine.dm.cache_struct().values()
            hot = (shp[0] * spec.kv_block_size * shp[3] * shp[4]) * dt.itemsize * 2
            self.pool = BlockPool(spec.pool_blocks(), spec.kv_block_size,
                                  quant_bits=kv_quant_bits, quant_horizon=kv_quant_horizon,
                                  hot_block_bytes=hot)
            self.block_tables = np.full((self.B, spec.blocks_per_slot), -1, np.int64)

        self.cache = self.engine.init_cache()
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[_Slot]] = [None] * self.B
        # per-slot step state (host); every lane starts at the dead sentinel
        self.tok = np.zeros(self.B, np.int64)
        self.pos = np.full(self.B, -1, np.int64)
        self.temp = np.zeros(self.B, np.float32)
        self.top_k = np.ones(self.B, np.int64)
        self.keys = np.zeros((self.B, 2), np.int64)
        self._submit_meta: dict[str, tuple[int, float]] = {}
        self._admit_step: dict[str, int] = {}
        self._first_token: dict[str, tuple[int, float]] = {}
        self._out: dict[str, list[int]] = {}
        self.finished: dict[str, CompletedRequest] = {}
        # stats
        self.step_count = 0
        self.prefill_count = 0
        self.prefill_chunk_count = 0
        self._pf_shapes: set[int] = set()  # distinct prefill shapes
        self._max_pf_tokens = 0  # longest single prefill launch (seq tokens)
        self.occupancy_sum = 0
        self.tokens_generated = 0
        self.decode_launches = 0
        self.sampled_launches = 0  # sampler passes with a row that draws
        # speculative accounting (zero without a draft)
        self.draft_launches = 0
        self.draft_lane_steps = 0
        self.verify_launches = 0
        self.spec_tokens = 0
        self.spec_lane_steps = 0

    # -- request intake ------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.rid in self._out or req.rid in self.finished:
            raise ValueError(f"duplicate request id {req.rid!r}")
        if req.needs_sampling and not self.spec.sampling:
            raise ValueError(f"request {req.rid!r} needs sampling but the engine was built "
                             "with DecodeSpec(sampling=False)")
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.rid!r}: prompt must be non-empty")
        if len(req.prompt) < self.engine.dm.min_prompt_len:
            raise ValueError(f"request {req.rid!r}: prompt of {len(req.prompt)} tokens, the "
                             f"model prefills at least {self.engine.dm.min_prompt_len}")
        if self.spec.cache_len and len(req.prompt) > self.spec.cache_len:
            raise ValueError(f"request {req.rid!r}: prompt ({len(req.prompt)}) exceeds the "
                             f"logical KV window ({self.spec.cache_len})")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid!r}: max_new_tokens must be >= 1")
        if self.pool is not None and self._lane_need(req) > self.pool.n_blocks:
            raise ValueError(f"request {req.rid!r}: needs up to {self._lane_need(req)} KV "
                             f"blocks but the pool holds {self.pool.n_blocks}; raise "
                             "--kv-pool-blocks")
        self._submit_meta[req.rid] = (self.step_count, time.perf_counter())
        self._out[req.rid] = []
        self.queue.append(req)

    # -- internals -----------------------------------------------------------

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _clear_lane(self, slot_i: int) -> None:
        """Dead-lane sentinel: pos -1 masks the lane's KV write and its
        attention; temp 0 / top-k 1 keep its row greedy."""
        self.tok[slot_i] = 0
        self.pos[slot_i] = -1
        self.temp[slot_i] = 0.0
        self.top_k[slot_i] = 1
        self.keys[slot_i] = 0

    def _arm_lane(self, slot_i: int, req: Request, first_pos: int) -> None:
        """Slot enters the decoding phase at position `first_pos`."""
        self.pos[slot_i] = first_pos
        self.temp[slot_i] = req.temperature
        self.top_k[slot_i] = req.top_k
        self.keys[slot_i] = prng.PRNGKey(req.seed)

    def _sample_tree(self, temp, top_k, keys) -> dict:
        return {"temp": _host(temp), "top_k": _host(top_k), "key": _host(keys)}

    def _count_sampled(self, lanes) -> None:
        """Count a sampler pass whose live `lanes` include one that draws
        (one random_bits launch)."""
        if any(self.slots[i].req.needs_sampling for i in lanes):
            self.sampled_launches += 1

    # -- paged-pool bookkeeping (spec.paged) ---------------------------------

    def _lane_need(self, req: Request) -> int:
        """Worst-case pool blocks a lane running `req` ever allocates: its
        footprint when it fits the window, the whole table otherwise (a
        wrapping lane may COW-fork every shared block)."""
        bs, bps = self.spec.kv_block_size, self.spec.blocks_per_slot
        total = len(req.prompt) + req.max_new_tokens
        return bps if total > self.spec.cache_len else -(-total // bs)

    def _lane_alloc(self, st: _Slot) -> int:
        bid = self.pool.alloc(self.step_count)
        if st.reserve > 0:
            st.reserve -= 1
            self._reserved -= 1
        return bid

    def _prefix_attach(self, slot_i: int, st: _Slot) -> None:
        """Share every consecutive hit (hot, or cold and rehydrated) of the
        prompt's prefix-key chain read-only; the lane skips prefilling them.
        The shared span is cut to whole prefill chunks with at least one
        prompt token left, so the lane's remaining chunks land at the
        offsets of its solo chunk decomposition."""
        req, C, bs = st.req, self.prefill_chunk, self.spec.kv_block_size
        taken: list[int] = []  # bids, one NEW reference each
        for key in st.pkeys:
            bid = self.pool.lookup(key, self.step_count)
            if bid is None and self.pool.lookup_cold(key) is not None:
                try:
                    bid, self.cache = self.engine.rehydrate_block(
                        self.cache, self.pool, key, self.step_count)
                except PoolExhausted:
                    bid = None
            if bid is None:
                break
            taken.append(bid)
        n = len(taken)
        while n and not ((n * bs) % C == 0 and n * bs < len(req.prompt)):
            n -= 1
        for bid in taken[n:]:
            self.pool.decref(bid, self.step_count)
        for j, bid in enumerate(taken[:n]):
            self.block_tables[slot_i, j] = bid
        st.pf_off = n * bs
        st.n_registered = n

    def _release_lane_blocks(self, slot_i: int) -> None:
        """Retirement: drop the lane's reference on every table entry and
        return its unused reservation."""
        st = self.slots[slot_i]
        if st is not None and st.reserve:
            self._reserved -= st.reserve
            st.reserve = 0
        for b in self.block_tables[slot_i]:
            if b >= 0:
                self.pool.decref(int(b), self.step_count)
        self.block_tables[slot_i] = -1

    def _prepare_decode_block(self, slot_i: int) -> None:
        """Before a lane's decode write at pos p: a fresh logical block
        allocates; on ring wrap into a SHARED block (ref > 1) the lane
        COW-forks and copies the bytes before it writes (the other readers
        keep the original); wrapping a block it registered itself withdraws
        it from the prefix table."""
        st = self.slots[slot_i]
        p = int(self.pos[slot_i])
        w, bs = self.spec.cache_len, self.spec.kv_block_size
        j = (p % w) // bs
        b = int(self.block_tables[slot_i, j])
        if b < 0:
            self.block_tables[slot_i, j] = self._lane_alloc(st)
        elif p >= w and p % bs == 0:
            if self.pool.ref(b) > 1:
                new = self.pool.cow_fork(b, self.step_count)
                if st.reserve > 0:
                    st.reserve -= 1
                    self._reserved -= 1
                _, _, copyb = self.engine.kv_block_ops()
                self.cache = copyb(self.cache, b, new)
                self.block_tables[slot_i, j] = new
            elif self.pool.is_registered(b):
                self.pool.unregister(b)

    def _prepare_decode_blocks(self, slot_i: int, k: int) -> None:
        """Speculative :meth:`_prepare_decode_block`: the lane may write
        positions p .. p+k-1 this step, so every logical block of that span
        needs a physical block first.  Drafting (k > 1) happens only where
        the span does not wrap the window, past the prompt, where the lane
        owns every target block: fresh allocation is the only case."""
        if k <= 1:
            self._prepare_decode_block(slot_i)
            return
        st = self.slots[slot_i]
        p = int(self.pos[slot_i])
        bs = self.spec.kv_block_size
        for j in range(p // bs, (p + k - 1) // bs + 1):
            if self.block_tables[slot_i, j] < 0:
                self.block_tables[slot_i, j] = self._lane_alloc(st)

    def _emit(self, events: list, slot_i: int, token: int) -> None:
        """Record one generated token; retire the slot when it is done."""
        st = self.slots[slot_i]
        req = st.req
        self._out[req.rid].append(token)
        st.n_out += 1
        self.tokens_generated += 1
        if st.n_out == 1:
            self._first_token[req.rid] = (self.step_count, time.perf_counter())
        done = (st.n_out >= req.max_new_tokens
                or (req.eos_id is not None and token == req.eos_id))
        events.append(TokenEvent(req.rid, token, st.n_out - 1, done))
        if done:
            submit_step, submit_time = self._submit_meta.pop(req.rid)
            ft_step, ft_time = self._first_token.pop(req.rid)
            self.finished[req.rid] = CompletedRequest(
                rid=req.rid, tokens=np.asarray(self._out.pop(req.rid), np.int32),
                submit_step=submit_step, admit_step=self._admit_step.pop(req.rid),
                finish_step=self.step_count, submit_time=submit_time,
                finish_time=time.perf_counter(), first_token_step=ft_step,
                first_token_time=ft_time)
            if self.pool is not None:
                self._release_lane_blocks(slot_i)
            self.slots[slot_i] = None
            self._clear_lane(slot_i)
        else:
            self.tok[slot_i] = token

    # -- blocking admission (prefill_chunk == 0) -----------------------------

    def _admit_blocking(self, events: list) -> None:
        """Prefill queued requests into free slots (batch-of-1 prefill, then
        the lane copied in place), one host sync of the produced tokens per
        pass; re-scan for slots freed by their own prefill token."""
        while self.queue:
            free = self._free_slots()
            if not free:
                return
            admitted: list[tuple[int, torch.Tensor]] = []
            for slot_i in free:
                if not self.queue:
                    break
                req = self.queue.popleft()
                s = len(req.prompt)
                batch = self.batch_builder(np.asarray(req.prompt, np.int64)[None, :])
                sample = (make_sample_params(req.temperature, req.top_k, req.seed)
                          if self.spec.sampling else None)
                nxt1, cache1 = self.prefill_engine.prefill_step()(
                    self.params, batch, self.gather_key, sample)
                self.prefill_count += 1
                if req.needs_sampling:
                    self.sampled_launches += 1
                self._pf_shapes.add(s)
                self._max_pf_tokens = max(self._max_pf_tokens, s)
                self.cache = _splice_slot(self.cache, cache1, slot_i)
                self.slots[slot_i] = _Slot(req=req, n_out=0)
                self._admit_step[req.rid] = self.step_count
                self._arm_lane(slot_i, req, s)  # the prefill token is fed at s
                admitted.append((slot_i, nxt1))
            if not admitted:
                return
            toks = torch.cat([t for _, t in admitted]).cpu().tolist()  # one sync
            for (slot_i, _), t in zip(admitted, toks):
                self._emit(events, slot_i, int(t))

    # -- chunked admission (prefill_chunk > 0) -------------------------------

    def _assign_slots(self) -> None:
        """Move queued requests into free slots as prefilling occupants (no
        model work here).  Paged: a request enters only when the pool's
        reclaimable blocks cover its worst case on top of what admitted
        lanes may still claim, else it queues (FIFO); admission then shares
        the cached blocks of its prompt's prefix."""
        for slot_i in self._free_slots():
            if not self.queue:
                return
            req = self.queue[0]
            if self.pool is not None:
                need = self._lane_need(req)
                if self.pool.free_blocks - self._reserved < need:
                    return  # pool pressure: keep queued
            self.queue.popleft()
            st = _Slot(req=req, n_out=0, prefilling=True)
            self.slots[slot_i] = st
            self._admit_step[req.rid] = self.step_count
            if self.pool is not None:
                st.pkeys = prefix_keys(req.prompt, self.spec.kv_block_size)
                st.reserve = need
                self._reserved += need
                if self.prefix_share:
                    self._prefix_attach(slot_i, st)
                wraps = len(req.prompt) + req.max_new_tokens > self.spec.cache_len
                if st.pf_off and not wraps:
                    # shared blocks the lane will never allocate (a wrapping
                    # lane keeps the full reservation: it may COW-fork them)
                    n_shared = st.pf_off // self.spec.kv_block_size
                    st.reserve -= n_shared
                    self._reserved -= n_shared
            # the lane keeps the dead sentinel until its last chunk lands

    def _chunk_pass(self, events: list) -> None:
        """Advance every prefilling slot by one chunk per launch, at most
        ``prefill_interleave`` launches; all prefilling slots' chunks ride
        one pooled launch.  Lanes whose chunk completes the prompt stream
        their prefill token (one host sync) and decode this very step."""
        for _ in range(self.prefill_interleave):
            lanes = [i for i, s in enumerate(self.slots) if s is not None and s.prefilling]
            if not lanes:
                return
            clen = {i: min(self.prefill_chunk,
                           len(self.slots[i].req.prompt) - self.slots[i].pf_off)
                    for i in lanes}
            bucket = prefill_bucket_for(max(clen.values()), self.buckets)
            tokens = np.zeros((self.B, bucket), np.int64)
            offset = np.zeros(self.B, np.int64)
            n_valid = np.zeros(self.B, np.int64)
            temp = np.zeros(self.B, np.float32)
            top_k = np.ones(self.B, np.int64)
            keys = np.zeros((self.B, 2), np.int64)
            for i in lanes:
                st = self.slots[i]
                tokens[i, :clen[i]] = st.req.prompt[st.pf_off:st.pf_off + clen[i]]
                offset[i] = st.pf_off
                n_valid[i] = clen[i]
                temp[i] = st.req.temperature
                top_k[i] = st.req.top_k
                keys[i] = prng.PRNGKey(st.req.seed)
            bt = None
            if self.pool is not None:
                bs = self.spec.kv_block_size
                for i in lanes:
                    st = self.slots[i]
                    for j in range(st.pf_off // bs, -(-(st.pf_off + clen[i]) // bs)):
                        if self.block_tables[i, j] < 0:
                            self.block_tables[i, j] = self._lane_alloc(st)
                bt = _host(self.block_tables)
            sample = self._sample_tree(temp, top_k, keys) if self.spec.sampling else None
            nxt, self.cache = self.engine.prefill_chunk_step(self.buckets[-1])(
                self.params, self.cache, _host(tokens), _host(offset), _host(n_valid),
                self.gather_key, sample, block_tables=bt)
            self.prefill_chunk_count += 1
            self._count_sampled(lanes)
            self._pf_shapes.add(bucket)
            self._max_pf_tokens = max(self._max_pf_tokens, bucket)
            finishing = []
            for i in lanes:
                st = self.slots[i]
                st.pf_off += clen[i]
                if self.pool is not None and self.prefix_share:
                    # publish every prompt block this chunk completed
                    full = min(st.pf_off // self.spec.kv_block_size, len(st.pkeys))
                    for j in range(st.n_registered, full):
                        self.pool.register(st.pkeys[j], int(self.block_tables[i, j]))
                    st.n_registered = max(st.n_registered, full)
                if st.pf_off >= len(st.req.prompt):
                    finishing.append(i)
            if finishing:
                toks = nxt.cpu().numpy()  # one sync per launch
                for i in finishing:
                    st = self.slots[i]
                    st.prefilling = False
                    self.prefill_count += 1
                    self._arm_lane(i, st.req, len(st.req.prompt))
                    self._emit(events, i, int(toks[i]))
                # a prefill token may retire its request at once; refill the
                # freed lanes so they start prefilling next launch
                self._assign_slots()

    # -- the scheduler loop --------------------------------------------------

    def step(self) -> list[TokenEvent]:
        """Admit pending requests, then run ONE pooled decode step.  Returns
        the tokens streamed this step (admission may also stream admitted
        requests' first tokens)."""
        events: list[TokenEvent] = []
        if self.prefill_chunk:
            self._assign_slots()
            self._chunk_pass(events)
        else:
            self._admit_blocking(events)
        active = [i for i, s in enumerate(self.slots) if s is not None and not s.prefilling]
        if not active:
            return events
        # per-slot draft depth: capped by the token budget and by the window
        # (a lane whose draft span would wrap decodes plainly, k = 1, through
        # the COW-aware single-block path)
        n_spec = np.ones(self.B, np.int64)
        if self.spec.speculative:
            for i in active:
                st = self.slots[i]
                n_spec[i] = max(1, min(self.spec.draft_depth,
                                       st.req.max_new_tokens - st.n_out,
                                       self.spec.cache_len - int(self.pos[i])))
        kmax = max(int(n_spec[i]) for i in active)
        bt = None
        if self.pool is not None:
            for i in active:
                self._prepare_decode_blocks(i, int(n_spec[i]))
            if self.pool.quant_horizon > 0 and self.pool.quant_cfg:
                # quantized cold tier: idle cached prefix blocks re-encode
                # into the wire format, freeing their hot block
                self.engine.demote_cold_blocks(self.cache, self.pool, self.step_count)
            bt = _host(self.block_tables)
        sample = (self._sample_tree(self.temp, self.top_k, self.keys)
                  if self.spec.sampling else None)
        if kmax > 1:
            return self._step_speculative(events, active, n_spec, kmax, bt, sample)
        nxt, self.cache = self.engine.decode_step()(
            self.params, self.cache, _host(self.tok), _host(self.pos), self.gather_key,
            sample, block_tables=bt)
        nxt = nxt.cpu().numpy()
        self.decode_launches += 1
        self._count_sampled(active)
        self.step_count += 1
        self.occupancy_sum += len(active)
        for slot_i in active:
            self.pos[slot_i] += 1
            self._emit(events, slot_i, int(nxt[slot_i]))
        return events

    def _step_speculative(self, events: list, active: list[int], n_spec: np.ndarray,
                          kmax: int, bt, sample) -> list[TokenEvent]:
        """Draft up to kmax - 1 tokens per lane on the low-bit engine, then
        verify the window at serving precision (reference
        ``scheduler.py:716``).  Draft round r feeds the previous round's
        token at pos + r (lanes whose depth is spent ride along dead) and
        writes draft-precision KV, which the verifier overwrites at serving
        precision before any later query reads it.  The verifier scores
        [tok, d1, .., d_{k-1}] with the decode step's math and sampling
        streams, and the lane commits the longest prefix of drafts it agrees
        with plus its own next token: every committed token, greedy or
        sampled, is the token non-speculative decode produces."""
        rows = [_host(self.tok)]
        dstep = self.draft_engine.decode_step()
        for r in range(kmax - 1):
            live = (self.pos >= 0) & (n_spec - 1 > r)
            pos_r = np.where(live, self.pos + r, -1)
            cur, self.cache = dstep(self.draft_params, self.cache, rows[-1], _host(pos_r),
                                    self.gather_key, sample, block_tables=bt)
            rows.append(cur.cpu())
            self.draft_launches += 1
            self.draft_lane_steps += int(live.sum())
            self._count_sampled(np.flatnonzero(live))
        tok_mat = torch.stack(rows, dim=1)  # (B, kmax) the drafted window
        outs, self.cache = self.engine.verify_step()(
            self.params, self.cache, tok_mat, _host(self.pos), _host(n_spec), self.gather_key,
            sample, block_tables=bt)
        out = outs.cpu().numpy()
        tok = tok_mat.numpy()
        self.verify_launches += 1
        self.spec_lane_steps += len(active)
        for j in range(kmax):
            self._count_sampled([i for i in active if n_spec[i] > j])
        self.step_count += 1
        self.occupancy_sum += len(active)
        for i in active:
            k_i = int(n_spec[i])
            a = 0  # accepted drafts: the longest prefix the verifier agrees with
            while a < k_i - 1 and int(out[i, a]) == int(tok[i, a + 1]):
                a += 1
            for j in range(a + 1):
                self.pos[i] += 1
                self.spec_tokens += 1
                self._emit(events, i, int(out[i, j]))
                if self.slots[i] is None:
                    break  # EOS or budget retirement inside the window
        return events

    def run(self, max_steps: Optional[int] = None,
            on_token: Optional[Callable[[TokenEvent], None]] = None
            ) -> dict[str, CompletedRequest]:
        """Drain the queue: step until every submitted request finished (or
        max_steps decode steps ran).  Returns {rid: CompletedRequest}."""
        steps = 0
        while self.queue or self.n_active():
            if max_steps is not None and steps >= max_steps:
                break
            for ev in self.step():
                if on_token is not None:
                    on_token(ev)
            steps += 1
        return self.finished

    def stats(self) -> dict:
        """The reference's statistics and ``sampled_launches``: sampler passes
        that drew for at least one row (one random_bits launch each)."""
        d = self.pool.capacity_stats() if self.pool is not None else {}
        generated = max(1, self.tokens_generated - self.prefill_count)
        return d | {
            "decode_steps": self.step_count,
            "prefills": self.prefill_count,
            "prefill_chunks": self.prefill_chunk_count,
            "prefill_traces": len(self._pf_shapes),
            "max_prefill_launch_tokens": self._max_pf_tokens,
            "tokens_generated": self.tokens_generated,
            "slots": self.B,
            "mean_occupancy": (self.occupancy_sum / self.step_count
                               if self.step_count else 0.0),
            "decode_launches": self.decode_launches,
            "draft_launches": self.draft_launches,
            "draft_lane_steps": self.draft_lane_steps,
            "verify_launches": self.verify_launches,
            "spec_tokens": self.spec_tokens,
            "spec_lane_steps": self.spec_lane_steps,
            "lane_steps": self.occupancy_sum,
            "accepted_per_launch": (self.spec_tokens / self.spec_lane_steps
                                    if self.spec_lane_steps else 0.0),
            "launches_per_token": self.occupancy_sum / generated,
            "draft_overhead": self.draft_lane_steps / generated,
            "sampled_launches": self.sampled_launches,
        }
