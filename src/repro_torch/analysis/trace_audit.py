"""Trace audit: walk traced programs for wire-format hazards (QJ101-103),
the JAX package's ``analysis/jaxpr_audit.py``.

The reference traces the jitted train step (f32 and quantized-state) and
the serve-side ``decode_fn`` / ``prefill_chunk_fn`` / ``verify_fn`` to
ClosedJaxprs with ``jax.make_jaxpr`` and walks their equations.  The port
has no jaxpr.  It runs the same programs under :class:`TraceMode`, a
``TorchDispatchMode`` that sees every aten op a program dispatches (the
backward's and a checkpoint's recompute included), every kernel launch of
``kernels.ops`` (``_launch`` hands each launch's operand and result tensors
to the modes that take them) and every call of a collective entry point of
``core.collectives`` (identities at one rank, which report themselves to
the modes as graph nodes).  On the meta device nothing is allocated and
nothing computes (:func:`run` traces there, at the reference's programs);
on the card the programs launch their kernels as they always do.

The dataflow is kept by tensor storage: each storage carries the
dequantizers (K2 ``unpack_dequantize``, K5 ``dequantize_buckets``) and the
u8 -> float conversions its values come from through layout-only ops
(:data:`LAYOUT`: views, reshapes, slices, concatenation, copies and casts,
index reads; the reference's transparent primitives), and forgets them at
any op that computes.  A write into part of a storage keeps what the rest
of it came from.  Rules:

  QJ101  a K2/K5 result reaches a K1/K4 (``quantize_pack`` /
         ``quantize_buckets``) operand through layout-only ops: a redundant
         re-quantization round-trip (an extra noise draw, an extra bias
         term, invisible to shape checks)
  QJ102  a u8 tensor converted to a float dtype reaches the operand of a
         collective entry point through layout-only ops: the wire was
         silently widened 2-4x
  QJ103  nondeterminism-hazard ops inside programs guarded by the
         bit-identity serve invariant (decode/prefill/verify must replay
         exactly): float accumulating scatters (CUDA atomics: ``index_add``,
         ``index_put`` / ``put`` with accumulate, ``scatter_add``,
         ``scatter_reduce``, ``embedding_dense_backward``) and draws from
         the global generator (the reference's ``rng_uniform``)
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..roofline.counter import meta_key, run_memo
from .findings import Finding

QUANTIZERS = ("quantize_pack", "quantize_buckets")        # K1, K4
DEQUANTIZERS = ("unpack_dequantize", "dequantize_buckets")  # K2, K5

# ops that move values without combining them (by packet name, an in-place
# form's "_" dropped): views and reshapes, slices and selections, copies and
# casts, concatenation, index reads, padding
LAYOUT = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "_reshape_copy", "view_copy",
    "slice", "slice_copy", "select", "select_copy", "narrow", "unbind", "split",
    "split_with_sizes", "cat", "stack", "_to_copy", "clone", "copy", "contiguous",
    "permute", "permute_copy", "expand", "expand_copy", "t", "transpose", "unsqueeze",
    "squeeze", "flatten", "unflatten", "alias", "detach", "lift_fresh", "lift_fresh_copy",
    "as_strided", "index_select", "index", "gather", "repeat", "flip",
    "constant_pad_nd", "slice_scatter", "select_scatter", "index_put", "_index_put_impl",
    "index_copy", "scatter", "masked_scatter",
})
# float results of these accumulate through atomics on the card
ATOMIC = frozenset({"index_add", "scatter_add", "scatter_reduce", "embedding_dense_backward"})
# these accumulate when their `accumulate` argument (position 3) is set
ACCUMULATING = frozenset({"index_put", "_index_put_impl", "put"})
# draws from the global generator: a replay sees other values
STATEFUL_RNG = frozenset({"uniform", "normal", "bernoulli", "random", "exponential",
                          "geometric", "cauchy", "log_normal", "multinomial", "randperm",
                          "rand", "randn", "randint", "rand_like", "randn_like",
                          "randint_like", "poisson", "native_dropout"})

_EMPTY = (frozenset(), frozenset())


def _name(func) -> str:
    n = func.overloadpacket.__name__
    return n[:-1] if n.endswith("_") and not n.endswith("__") else n


def _tensors(tree):
    """The tensors in an op's arguments or result (nested tuples, lists
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class TraceMode(TorchDispatchMode):
    """Records, while active, what the three QJ rules read: the K2/K5
    results and u8 -> float conversions each storage's values come from
    through layout-only ops (:data:`LAYOUT`), the K1/K4 operands and
    collective operands they reach, the hazard ops dispatched, and every
    kernel launch by kernel (``launches``)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        return False  # nothing compiles under the trace (see roofline.counter)

    def __init__(self):
        super().__init__()
        self.launches: Counter = Counter()
        self.roundtrips: list[tuple[str, str]] = []  # (dequantizer, quantizer)
        self.widened: list[tuple[str, str]] = []     # (float dtype, collective)
        self.hazards: list[str] = []
        self._taint: dict = {}  # storage id -> (dequantizers, widened dtypes)
        self._refs: dict = {}   # storage id -> weak reference (drops the entry)
        self._ops: dict = {}    # func -> (name, written argument positions, is view, names)
        self._memo: dict = {}   # functional meta ops' outputs by argument metadata

    # -- storages --------------------------------------------------------------

    def _get(self, t: torch.Tensor) -> tuple:
        return self._taint.get(t.untyped_storage()._cdata, _EMPTY)

    def _set(self, t: torch.Tensor, taint: tuple) -> None:
        """`taint` for the values written into `t`; a write into part of its
        storage keeps what the rest came from."""
        st = t.untyped_storage()
        key = st._cdata
        if t.numel() * t.element_size() < st.nbytes():
            old = self._taint.get(key, _EMPTY)
            taint = (old[0] | taint[0], old[1] | taint[1])
        if taint == _EMPTY:
            self._taint.pop(key, None)
            return
        self._taint[key] = taint
        if key not in self._refs:
            self._refs[key] = weakref.ref(st, lambda _r, k=key: self._drop(k))

    def _drop(self, key: int) -> None:
        self._taint.pop(key, None)
        self._refs.pop(key, None)

    def _through(self, name: str, srcs: list, dst_dtype) -> tuple:
        """The taint of a layout op's result from its sources: their union,
        a u8 -> float cast adding its float dtype, a cast to an integer
        dtype ending the widening."""
        deq = frozenset().union(*(self._get(s)[0] for s in srcs))
        wide = frozenset().union(*(self._get(s)[1] for s in srcs))
        if name in ("_to_copy", "copy"):
            if not dst_dtype.is_floating_point:
                wide = frozenset()
            elif any(t.dtype == torch.uint8 for t in srcs):
                wide = wide | {str(dst_dtype).removeprefix("torch.")}
        return deq, wide

    # -- the ops ----------------------------------------------------------------

    def _classify(self, func) -> tuple:
        schema = func._schema
        written = tuple(i for i, a in enumerate(schema.arguments)
                        if a.alias_info is not None and a.alias_info.is_write)
        view = (not written and any(r.alias_info is not None for r in schema.returns))
        self._ops[func] = info = (_name(func), written, view,
                                  tuple(a.name for a in schema.arguments))
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, written, view, arg_names = self._ops.get(func) or self._classify(func)
        first = next(_tensors(args), None)
        if written or view or first is None or first.device.type != "meta":
            out = func(*args, **kwargs)
        else:  # a functional op on meta: from the memo (roofline.counter.run_memo)
            out = run_memo(self._memo, func, args, kwargs, meta_key(func, args, kwargs, []))
        self._hazard(name, args, kwargs, out)
        if view:
            return out
        if not written:  # its results are new storages, of no origin unless it moves values
            if name in LAYOUT:
                outs = list(_tensors(out))
                taint = self._through(name, list(_tensors((args, kwargs))), outs[0].dtype)
                for o in outs:
                    self._set(o, taint)
            return out
        full = dict(zip(arg_names, args))
        full.update(kwargs)
        targets = list(_tensors([full[arg_names[i]] for i in written if arg_names[i] in full]))
        ids = {id(t) for t in targets}
        srcs = [t for t in _tensors((args, kwargs)) if id(t) not in ids]
        for t in targets:
            self._set(t, self._through(name, srcs, t.dtype)
                      if name in LAYOUT and not self._accumulates(name, args, kwargs)
                      else _EMPTY)
        return out

    @staticmethod
    def _accumulates(name: str, args, kwargs) -> bool:
        if name not in ACCUMULATING:
            return False
        return bool(args[3] if len(args) > 3 else kwargs.get("accumulate", False))

    def _hazard(self, name: str, args, kwargs, out) -> None:
        if name in STATEFUL_RNG:
            self.hazards.append(name)
            return
        if name in ATOMIC or self._accumulates(name, args, kwargs):
            res = next(_tensors(out), None)
            if res is not None and res.dtype.is_floating_point:
                self.hazards.append(f"{name}:float")

    # -- kernels and collectives (reported by kernels.ops / core.collectives) ---

    def launched(self, name: str, ins, outs) -> None:
        """A kernel of ``kernels.ops`` launched with operands `ins` and
        results `outs`."""
        self.launches[name] += 1
        if name in QUANTIZERS:
            for t in ins:
                for deq in sorted(self._get(t)[0]):
                    self.roundtrips.append((deq, name))
        taint = (frozenset({name}), frozenset()) if name in DEQUANTIZERS else _EMPTY
        for o in outs:
            self._set(o, taint)

    def collective(self, name: str, operands) -> None:
        """A collective entry point of ``core.collectives`` called with
        `operands` (its arguments)."""
        for t in _tensors(operands):
            for dt in sorted(self._get(t)[1]):
                self.widened.append((dt, name))


def audit_trace(mode: TraceMode, tag: str, bit_identity: bool = False) -> list[Finding]:
    """All three detectors over one traced program, each site once."""
    out = [Finding("QJ101", f"{tag}::{deq}->{q}",
                   f"'{q}' consumes '{deq}' output with no intervening compute — "
                   f"redundant QDQ round-trip") for deq, q in mode.roundtrips]
    out += [Finding("QJ102", f"{tag}::u8->{dt}->{coll}",
                    f"u8 wire buffer widened to {dt} before '{coll}' — wire bytes "
                    f"multiplied") for dt, coll in mode.widened]
    if bit_identity:
        out += [Finding("QJ103", f"{tag}::{h}",
                        f"nondeterminism-hazard op '{h}' inside a bit-identity-guarded "
                        f"program") for h in mode.hazards]
    seen, uniq = set(), []
    for f in out:
        if f.site not in seen:
            seen.add(f.site)
            uniq.append(f)
    return uniq


@dataclasses.dataclass
class Traced:
    """One traced program: its findings, its kernel launches by kernel and
    what it returned."""

    findings: list
    launches: dict
    result: object = None


def trace(fn: Callable[[], object], tag: str, bit_identity: bool = False) -> Traced:
    """Run `fn` once under a :class:`TraceMode` and audit what it did."""
    with TraceMode() as mode:
        result = fn()
    return Traced(audit_trace(mode, tag, bit_identity), dict(mode.launches), result)


# ---------------------------------------------------------------------------
# The programs: one closure per tag, built from live objects (the card's
# phases hand theirs in) or on the meta device (:func:`run`)
# ---------------------------------------------------------------------------

SERVE_TAGS = ("decode_fn", "prefill_chunk_fn", "verify_fn")  # bit-identity guarded


def serve_programs(engine, params: dict, cache: dict, key=(0, 0),
                   bucket: int = 8) -> dict[str, Callable[[], object]]:
    """{tag: run} for one decode step, one chunked-prefill launch of
    `bucket` tokens and one verify launch of ``spec.draft_depth`` tokens
    on `engine` (a ``ServeEngine``), every lane live at position 0, with
    the sampler drawing where the spec samples and the lanes' blocks
    allocated in order where it is paged."""
    from ..serve.engine import make_sample_params

    spec = engine.spec
    b = spec.batch_global
    kw = {}
    if spec.sampling:
        kw["sample"] = make_sample_params(0.8, 40, 0, b)
    if spec.paged:
        bps = spec.blocks_per_slot
        kw["block_tables"] = (torch.arange(b * bps, dtype=torch.int64)
                              % spec.pool_blocks()).reshape(b, bps)
    pos = torch.zeros((b,), dtype=torch.int64)
    k = max(1, spec.draft_depth)

    def tokens(*shape):
        return torch.zeros(shape, dtype=torch.int64)
    return {
        "decode_fn": lambda: engine.decode_step()(params, cache, tokens(b), pos, key, **kw),
        "prefill_chunk_fn": lambda: engine.prefill_chunk_step(bucket)(
            params, cache, tokens(b, bucket), pos, torch.full((b,), bucket), key, **kw),
        "verify_fn": lambda: engine.verify_step()(params, cache, tokens(b, k), pos,
                                                  torch.full((b,), k), key, **kw),
    }


def trace_programs(programs: dict[str, Callable[[], object]]) -> dict[str, Traced]:
    """Trace each program once (keeping no result); serving programs are
    bit-identity guarded."""
    return {tag: dataclasses.replace(trace(fn, tag, bit_identity=tag in SERVE_TAGS),
                                     result=None)
            for tag, fn in programs.items()}


def meta_serve_programs(cfg, bucket: int = 8, **setup) -> dict[str, Callable[[], object]]:
    """:func:`serve_programs` on meta for the model config `cfg` on the
    card's route (blocks of ``LANE_BLOCK`` lanes); `setup` goes to
    ``build_serve_setup`` (batch, prompt and generation lengths, sampling,
    the paged pool, the draft)."""
    from ..configs.inputs import META
    from ..core.qsdp import QSDPConfig
    from ..launch.dryrun import MS11, meta_params
    from ..models.decode import LANE_BLOCK
    from ..models.transformer import Model
    from ..serve.common import build_serve_setup
    from ..serve.engine import ServeEngine, prepare_wire_params

    params = meta_params(Model(cfg, MS11, QSDPConfig()))
    s = build_serve_setup(cfg, params=params, device=META, **setup)
    engine = ServeEngine(s.model, dataclasses.replace(s.spec, lane_block=LANE_BLOCK), META)
    return serve_programs(engine, prepare_wire_params(s.model, s.params), engine.init_cache(),
                          bucket=bucket)


def meta_train_program(cfg, qsdp, optimizer, n_micro: int = 1, batch: int = 4,
                       seq: int = 16, quantized_state: bool = False) -> Callable[[], object]:
    """One train step on meta: the model config `cfg` under `qsdp` and
    `optimizer`, its state built from the parameter specs (the quantized
    domain's through ``quantize_train_state`` with `quantized_state`),
    `n_micro` microbatches of zero tokens (`batch`, `seq`)."""
    from ..configs.inputs import META
    from ..launch.dryrun import MS11, meta_params
    from ..models.transformer import Model
    from ..train.step import TrainState, build_train_step, quantize_train_state

    model = Model(cfg, MS11, qsdp)
    params = meta_params(model)
    state = TrainState(params=params, opt=optimizer.init(params))
    if quantized_state:
        state = quantize_train_state(state, model, (0, 0))
    step = build_train_step(model, optimizer, n_micro=n_micro, quantized_state=quantized_state,
                            device=META)
    tokens = torch.zeros((batch, seq), dtype=torch.int64, device=META)
    return lambda: step(state, {"tokens": tokens, "labels": tokens}, (0, 0))


def reference_programs(arch: str = "gpt-125m") -> dict[str, Callable[[], object]]:
    """The reference's five programs on meta: `arch`'s smoke config; the
    train step under ``QSDPConfig(min_quant_size=256, coalesce=True)`` and
    AdamW, zero tokens of (4, 16), one microbatch, f32 and quantized-domain
    state; the serve programs at batch 2, prompt 8, gen 4, a 4-bit draft of
    depth 2, chunk bucket 8."""
    from .. import configs
    from ..core.qsdp import QSDPConfig
    from ..optim import AdamWConfig, make_adamw

    cfg = configs.get_smoke(arch)
    qsdp, opt = QSDPConfig(min_quant_size=256, coalesce=True), make_adamw(AdamWConfig(lr=1e-3))
    out = {f"train-step[{'qstate' if qs else 'f32'}]":
           meta_train_program(cfg, qsdp, opt, quantized_state=qs) for qs in (False, True)}
    out.update(meta_serve_programs(cfg, batch=2, prompt_len=8, gen=4, draft_bits=4,
                                   draft_depth=2))
    return out


def run(arch: str = "gpt-125m", report: Optional[dict] = None) -> list[Finding]:
    """Trace the reference's five programs on meta and audit them;
    `report` takes each program's kernel launches."""
    traced = trace_programs(reference_programs(arch))
    if report is not None:
        report.update({tag: t.launches for tag, t in traced.items()})
    return [f for t in traced.values() for f in t.findings]
