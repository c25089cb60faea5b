"""Counts a step's FLOPs, bytes and kernel launches from the ops it
dispatches: the port's twin of the JAX package's ``roofline/hlo_analyzer.py``.

The reference compiles a step and reads its terms from the HLO; the port
has no HLO.  It runs the eager step (on the meta device for the dry run,
where nothing is allocated and nothing computes; on the CPU or the card it
counts a real step alike) under :class:`Counter`, a ``TorchDispatchMode``
that sees every aten op the step dispatches, the backward's and a
checkpoint's recompute included, and every kernel of ``kernels.ops``
(which report their own work, ``kernels.cost``).  Its :meth:`Counter.counts`
returns the keys of the reference's ``analyze_hlo``:

* ``flops``: 2·M·N·K for every ``mm``/``addmm``/``bmm``/``baddbmm``, the
  reference's convolution formula (2 · output elements · kernel elements /
  output features, ``hlo_analyzer.py:181``) and K3's product (a matrix
  product over u8 codes).  Elementwise work is not counted, as in the
  reference; ``flops_by_dtype`` splits the same FLOPs by the dtype the
  product runs in ("bf16", "f32", ...; K3 multiplies in f32) and
  ``flops_by_op`` by op.
* ``traffic_bytes``: input + output bytes of every op that materialises.
  Views (``view``, ``t``, ``transpose``, ``expand``, ``slice``, ``select``,
  ``as_strided``, ``unsqueeze``, ``detach``: any op whose output aliases an
  input without writing it) and allocations (``empty``) move nothing, as
  ``_SKIP_TRAFFIC`` says for the HLO.  An indexed read (``index``,
  ``gather``, ``index_select``, ``embedding``) is charged twice its result,
  an in-place indexed write (``index_put_``, ``scatter_``, ...) twice its
  update, as the reference charges gathers and in-place scatters.  A
  kernel is charged the bytes it must move.
* ``traffic_min_bytes``: the same less the elementwise ops that a fusing
  compiler would merge into their neighbours (:data:`ELEMENTWISE`, the aten
  twins of the reference's ``_ELEMENTWISE_FUSED``).
* ``collectives``: the reference's per-kind dict of wire bytes and launch
  counts.  At one rank no collective is launched and every entry is 0;
  ``launch.dryrun`` fills the wire bytes from the engine's own accounting
  (``core.qsdp.step_comm_bytes``), 0 on the (1, 1) mesh.

and beside them ``launches`` (kernel launches by kernel),
``peak_live_bytes``: the most bytes alive at once, the caller's `base`
(the state alive when counting starts) plus every storage an op creates,
from its creation until it is freed, and ``host_tensor_bytes``: the
largest tensor an op made on the host while counting another device (the
decode path keeps its control tensors there).

Trip counts: the reference multiplies a ``while`` body by its trip count;
the port counts a loop at two lengths and scales the difference
(:func:`marginal`, :func:`scaled`), as the dry run does with a train step's
microbatches and as a per-layer audit does with the depth.
"""
from __future__ import annotations

import functools
import weakref
from collections import Counter as _Tally

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")

# hlo_analyzer._ELEMENTWISE_FUSED, HLO op -> the aten ops (by their packet
# name, in-place forms included) that compute it:
#   add, subtract, multiply, divide -> add, sub, rsub, mul, div, addcmul,
#       addcdiv, lerp (their compositions), neg (negate)
#   maximum, minimum, clamp -> maximum, minimum, clamp, clamp_min, clamp_max
#   exponential, exponential-minus-one, log, log-plus-one, tanh, logistic,
#       rsqrt, sqrt, cbrt, power -> exp, expm1, log, log1p, tanh, sigmoid,
#       rsqrt, sqrt, pow, reciprocal, and the activations built of them
#       (silu, gelu, softplus) and their backward twins
#   compare, select, and, or, not, xor -> eq, ne, lt, le, gt, ge, where,
#       masked_fill, logical_and/or/not/xor, bitwise_and/or/not/xor
#   convert -> _to_copy (a dtype cast)
#   broadcast -> full, fill, zeros (a constant broadcast into a buffer)
#   floor, ceil, round-nearest-*, sign, abs, is-finite, remainder, rem ->
#       floor, ceil, round, trunc, sign, abs, isfinite, remainder, fmod
#   shift-left, shift-right-* -> bitwise_left_shift, bitwise_right_shift,
#       __lshift__, __rshift__
#   sine, cosine, atan2 -> sin, cos, atan2
#   reshape, slice -> views here (no traffic at all)
ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "addcmul", "addcdiv", "lerp", "neg",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
    "exp", "expm1", "log", "log1p", "tanh", "sigmoid", "rsqrt", "sqrt", "pow", "reciprocal",
    "silu", "gelu", "softplus", "silu_backward", "gelu_backward", "sigmoid_backward",
    "tanh_backward", "threshold_backward",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "masked_fill",
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_not", "bitwise_xor",
    "_to_copy", "full", "fill", "zeros", "zeros_like", "ones", "ones_like", "full_like",
    "floor", "ceil", "round", "trunc", "sign", "abs", "isfinite", "remainder", "fmod",
    "bitwise_left_shift", "bitwise_right_shift", "__lshift__", "__rshift__",
    "sin", "cos", "atan2",
})

# ops that move nothing: allocations, and views the schema does not mark
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "_unsafe_view", "lift_fresh", "alias"})
# reads of the addressed rows only: charged twice the result
_INDEXED_READS = frozenset({"index", "gather", "index_select", "embedding", "take"})
# in-place writes of an update into a larger buffer: charged twice the update
_INDEXED_WRITES = frozenset({"index_put", "_index_put_impl", "scatter", "scatter_add",
                             "scatter_reduce", "index_copy", "index_add", "masked_scatter",
                             "index_fill"})
# in-place ops that write their target without reading it
_WRITE_ONLY = frozenset({"copy", "fill", "zero", "normal", "uniform", "random"})

_PRODUCTS = frozenset({"mm", "addmm", "bmm", "baddbmm", "convolution"})

_DTYPE_KEYS = {torch.bfloat16: "bf16", torch.float32: "f32", torch.float16: "f16",
               torch.float64: "f64"}

# kernels of kernels.ops whose work is a matrix product (counted in flops)
PRODUCT_KERNELS = frozenset({"rowquant_matmul"})


def _name(func) -> str:
    """The op's packet name, an in-place form's trailing "_" dropped."""
    n = func.overloadpacket.__name__
    return n[:-1] if n.endswith("_") and not n.endswith("__") else n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _product_flops(name: str, args, out) -> int:
    """2·M·N·K of a (batched) matrix product; a convolution's 2 · output
    elements · kernel elements / output features (per output element, 2 x
    the weight's elements over C_out)."""
    if name == "convolution":
        weight = args[1]
        return 2 * out.numel() * weight.numel() // max(weight.shape[0], 1)
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else (args[0], args[1])
    return 2 * a.numel() * b.shape[-1]


def empty_collectives() -> dict:
    """The reference's per-kind collective dict with every entry 0."""
    d = dict.fromkeys(COLLECTIVE_KINDS, 0)
    d.update(total=0, counts=dict.fromkeys(COLLECTIVE_KINDS, 0), counts_by_dtype={})
    return d


def _device_tensors(tree, device: str) -> list:
    """The tensors on `device` in an op's arguments or output (a tensor, or
    tuples, lists and dicts of them and of other values; a Python scalar,
    as ``_local_scalar_dense`` returns, holds none)."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.device.type == device else []
    if not isinstance(tree, (list, tuple, dict)):
        return []
    out = []
    for x in tree.values() if isinstance(tree, dict) else tree:
        if isinstance(x, torch.Tensor):
            if x.device.type == device:
                out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out += _device_tensors(x, device)
    return out


def _scan(x, device: str, found: list):
    """A hashable key of an op argument's metadata (a tensor's shape,
    strides, dtype and device; any other argument as it is), the tensors on
    `device` appended to `found` on the way."""
    if isinstance(x, torch.Tensor):
        if x.device.type == device:
            found.append(x)
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return tuple(_scan(v, device, found) for v in x)
    return x


def run_memo(memo: dict, func, args, kwargs, key):
    """``func(*args, **kwargs)`` of a functional op (one that neither writes
    nor aliases its inputs) on the meta device, where its outputs are a
    function of `key` (its arguments' metadata, :func:`_scan`): computed
    once per key and kept in `memo`, later made as fresh empty tensors of
    the same shapes and strides (PyTorch's meta kernels take ~10^2 us an
    op).  Outputs off the meta device are not kept."""
    try:
        hit = memo.get(key)
    except TypeError:  # an unhashable argument
        return func(*args, **kwargs)
    if hit is not None:
        made = [torch.empty_strided(size, stride, dtype=dt, device="meta")
                for size, stride, dt in hit[1]]
        return made[0] if hit[0] else tuple(made)
    out = func(*args, **kwargs)
    single = isinstance(out, torch.Tensor)
    outs = [out] if single else out
    if (isinstance(outs, (tuple, list))
            and all(isinstance(t, torch.Tensor) and t.device.type == "meta" for t in outs)):
        memo[key] = (single, [(t.shape, t.stride(), t.dtype) for t in outs])
    return out


def meta_key(func, args, kwargs, found: list) -> tuple:
    """The memo key of an op on meta tensors (:func:`run_memo`), the meta
    tensors of its arguments appended to `found`."""
    return (func, _scan(args, "meta", found),
            tuple((k, _scan(v, "meta", found)) for k, v in kwargs.items()))


class Counter(TorchDispatchMode):
    """Counts the ops dispatched on `device` (a device type: "meta",
    "cpu", "cuda") while active; ops whose tensors all lie elsewhere (the
    decode path's host control tensors) are not counted.  `base`: bytes
    alive when counting starts (the state), the floor of
    ``peak_live_bytes``.

    On the meta device the outputs of a functional op (one that neither
    writes nor aliases its inputs) are a function of its inputs' shapes,
    strides and dtypes and its other arguments; the counter computes them
    once per such signature and makes later outputs as fresh empty tensors
    of the same shapes and strides (PyTorch's meta kernels take ~10^2 µs an
    op, and a step repeats a few signatures many thousand times: the
    attention's chunk pairs, the layers)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing compiles under the counter: keep torch from wrapping
        # __torch_dispatch__ for dynamo (an import of torch._dynamo and a
        # few frames on every op)
        return False

    def __init__(self, device: str = "meta", base: int = 0):
        super().__init__()
        self.device = device
        self.base = base
        self.flops = 0
        self.traffic = 0
        self.traffic_min = 0
        self.flops_by_dtype: _Tally = _Tally()
        self.flops_by_op: _Tally = _Tally()
        self.launches: _Tally = _Tally()
        self.n_ops = 0
        self.host_bytes = 0
        self._live: dict = {}  # storage id -> (bytes, weak reference)
        self._live_bytes = 0
        self._peak = 0
        self._ops: dict = {}  # func -> (name, kind, mutable)
        self._memo: dict = {}  # (func, argument metadata) -> output metadata

    # -- the ops ------------------------------------------------------------

    def _classify(self, func) -> tuple:
        name = _name(func)
        schema = func._schema
        aliased = any(r.alias_info is not None for r in schema.returns)
        if name in _NO_TRAFFIC:
            kind = "alloc" if "empty" in name else "view"
        elif aliased and not schema.is_mutable:
            kind = "view"
        elif aliased:
            kind = "inplace"
        else:
            kind = "op"
        self._ops[func] = info = (name, kind, schema.is_mutable)
        return info

    def _run(self, func, args, kwargs, key):
        """func(*args, **kwargs), from the memo for a functional meta op
        (`key`: the arguments' metadata)."""
        if self.device != "meta":
            return func(*args, **kwargs)
        return run_memo(self._memo, func, args, kwargs, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, kind, mutable = self._ops.get(func) or self._classify(func)
        if kind == "view":
            return func(*args, **kwargs)
        ins = []
        key = (func, _scan(args, self.device, ins),
               tuple((k, _scan(v, self.device, ins)) for k, v in kwargs.items()))
        out = self._run(func, args, kwargs, key) if kind == "op" else func(*args, **kwargs)
        outs = _device_tensors(out, self.device)
        if kind != "inplace":
            self._track(outs)
        if kind == "alloc":
            return out
        if not ins and not outs:  # host work (the decode path's control tensors)
            self.host_bytes = max([self.host_bytes] + [
                _nbytes(t) for t in _device_tensors(out, "cpu")])
            return out
        self.n_ops += 1
        if name in _INDEXED_READS:
            moved = 2 * sum(map(_nbytes, outs))
        elif mutable and name in _INDEXED_WRITES:
            target = args[0]
            moved = 2 * sum(_nbytes(t) for t in ins if t is not target and t.dtype == target.dtype)
        else:
            reads = [t for t in ins if t is not args[0]] if mutable and name in _WRITE_ONLY \
                else ins
            moved = sum(map(_nbytes, reads)) + sum(map(_nbytes, outs))
        self.traffic += moved
        if name not in ELEMENTWISE:
            self.traffic_min += moved
        if name in _PRODUCTS:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            self._add_flops(name, a.dtype, _product_flops(name, args, out))
        return out

    def _add_flops(self, op: str, dtype, f: int) -> None:
        self.flops += f
        self.flops_by_dtype[_DTYPE_KEYS.get(dtype, str(dtype))] += f
        self.flops_by_op[op] += f

    # -- the kernels ----------------------------------------------------------

    def kernel(self, name: str, work) -> None:
        """A kernel of ``kernels.ops`` launched on the meta device with
        `work` (``kernels.cost.KernelCost``): its bytes go to both traffic
        terms (a kernel materialises its output), a product kernel's
        operations to the FLOPs."""
        self.launches[name] += 1
        self.traffic += work.nbytes
        self.traffic_min += work.nbytes
        if name in PRODUCT_KERNELS:
            self._add_flops(name, torch.float32, work.flops)

    # -- live bytes -----------------------------------------------------------

    def _track(self, outs: list) -> None:
        """Count the storages of a functional op's (or an allocation's)
        outputs as live until they are freed."""
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (n, weakref.ref(st, functools.partial(self._free, key)))
            self._live_bytes += n
            if self._live_bytes > self._peak:
                self._peak = self._live_bytes

    def _free(self, key: int, _ref=None) -> None:
        self._live_bytes -= self._live.pop(key)[0]

    # -- the result -----------------------------------------------------------

    def counts(self) -> dict:
        return {
            "flops": self.flops,
            "traffic_bytes": self.traffic,
            "traffic_min_bytes": self.traffic_min,
            "collectives": empty_collectives(),
            "flops_by_dtype": dict(self.flops_by_dtype),
            "flops_by_op": dict(self.flops_by_op),
            "launches": dict(self.launches),
            "peak_live_bytes": self.base + self._peak,
            "host_tensor_bytes": self.host_bytes,
            "n_ops": self.n_ops,
        }


def _combine(a, b, fn):
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _combine(a.get(k, 0), b.get(k, 0), fn) for k in {**a, **b}}
    return fn(a, b)


def marginal(hi: dict, lo: dict, units: int = 1) -> dict:
    """Per-unit difference of two counts of one step at two loop lengths
    (`units` more iterations in `hi`): what one more iteration adds, every
    numeric entry and nested dict alike (``peak_live_bytes`` included)."""
    return _combine(hi, lo, lambda x, y: (x - y) // units if (x - y) % units == 0
                    else (x - y) / units)


def scaled(base: dict, per_unit: dict, units: int) -> dict:
    """`base` plus `units` times `per_unit` (from :func:`marginal`): the
    count of a loop run `units` more times than in `base`, every entry
    extrapolated linearly (a peak too: right where each iteration keeps
    what it makes, as each layer of a stack keeps its state and its
    cache; a caller whose iterations free theirs takes the peak apart)."""
    return _combine(base, per_unit, lambda x, y: x + units * y)
