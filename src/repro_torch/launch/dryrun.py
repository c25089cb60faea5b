"""One-rank dry run: build every (architecture x input-shape) step of the
port at full size on the meta device, run it once (nothing is allocated,
nothing computes), count it, and report its three-term roofline on the
H100 (the JAX package's ``launch/dryrun.py`` on the (1, 1) mesh).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gpt-1.3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl

The reference lowers and compiles each step against ``ShapeDtypeStruct``s
on its production meshes and reads FLOPs, bytes and wire bytes from the
HLO.  The port has no HLO: it runs the eager step on meta tensors under
``roofline.counter.Counter``, which counts every op it dispatches, the
backward and the checkpoints' recompute included, and charges the
hand-written kernels (which take a meta path in ``kernels.ops``) by their
own byte and operation formulas.  No card is needed.

Per pair this prints the roofline summary and the counting time, the
state's bytes and the peak of live bytes above them; ``--out`` writes one
JSON record per pair per line (the format ``experiments.roofline_report``
reads).  The mesh is ``1x1`` (one chip): the reference's production meshes
(``--multi-pod``, ``--both-meshes``) wait for a dry run over ranks (ROADMAP
A12e), its two-level gathers (``--hierarchical``) for A3b.

A train step runs ``global_batch`` one-row microbatches at one rank (the
reference's ``n_micro = global_batch // fsdp_size``).  The dry run counts
the step at 1 and at 2 microbatches and charges the rest as the second
(microbatch 0 sets each gradient, later ones add to it); the update is
charged once.  Parameters and optimizer state are built on meta from each
``ParamSpec.rest_shape``, never initialised.  Decode and prefill run the
card's path, ``DecodeModel`` at blocks of ``models.decode.LANE_BLOCK``
lanes, with every slot at the shape's last position (``configs.inputs``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Callable, NamedTuple

import torch

from .. import configs
from ..configs.inputs import META, input_specs
from ..core.qsdp import MeshSpec, QSDPConfig, step_comm_bytes
from ..core.quant import QuantizedParam
from ..models.config import SHAPES
from ..models.decode import LANE_BLOCK, DecodeModel, make_decode_spec
from ..models.transformer import Model
from ..optim import AdamWConfig, make_adamw
from ..roofline import HW_H100, Counter, marginal, roofline, scaled
from ..train.step import TrainState, build_train_step

DEFAULT_QSDP = dict(weight_bits=8, grad_bits=8, bucket_size=1024)
MESH = "1x1"
N_CHIPS = 1
MS11 = MeshSpec(("data", "model"), (1, 1))


class Step(NamedTuple):
    """A step ready to count: ``run(k)`` runs it once on meta (a train step
    over its first k microbatches; `k` is ignored otherwise); `state` holds
    the tensors alive before it (parameters and optimizer state, or the
    parameters and the decode cache), `inputs` its batch or tokens."""

    kind: str
    model: Model
    run: Callable[[int], object]
    state: object
    inputs: object
    n_micro: int


def storages(tree) -> dict[int, int]:
    """{storage id: bytes} of every tensor in `tree` (dicts, tuples, lists,
    NamedTuples and QuantizedParam wires), each storage once."""
    out = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[st._cdata] = st.nbytes()
        elif isinstance(x, QuantizedParam):
            walk(x.wire)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
    walk(tree)
    return out


def tensors_bytes(tree) -> int:
    return sum(storages(tree).values())


def meta_params(model: Model) -> dict:
    """Every parameter's rest-layout f32 tensor on meta (no init)."""
    return {name: torch.empty(spec.rest_shape(model.ms), dtype=torch.float32, device=META)
            for name, spec in sorted(model.specs.items())}


def _rows(batch: dict, a: int, b: int) -> dict:
    """Rows [a, b) of every leaf of a train batch (M-RoPE's positions on
    axis 1)."""
    return {k: v[:, a:b] if k == "positions" else v[a:b] for k, v in batch.items()}


def train_step(model: Model, optimizer, batch: dict, n_micro: int, key=None) -> Step:
    """`model`'s train step on meta under `optimizer`, over `batch` (meta
    tensors, split into `n_micro` microbatches), its state built from the
    parameter specs."""
    params = meta_params(model)
    state = TrainState(params=params, opt=optimizer.init(params))
    rows = next(iter(batch.values())).shape[0] // n_micro
    key = key or (0, 0)

    def run(k: int):
        step = build_train_step(model, optimizer, n_micro=k, device=META)
        return step(state, _rows(batch, 0, k * rows), key)
    return Step("train", model, run, state, batch, n_micro)


def build_step(arch: str, shape_name: str, qsdp: QSDPConfig, n_micro: int | None = None,
               cfg=None) -> Step:
    """The step of (arch, shape) on meta at one rank, under AdamW (the
    reference dry run's optimizer); `cfg` overrides the arch's config (a
    smoke config in the tests)."""
    cfg = cfg or configs.get_config(arch)
    shape = SHAPES[shape_name]
    model = Model(cfg, MS11, qsdp)
    if shape.kind == "train":
        _, (batch, key) = input_specs(model, shape)
        n_micro = n_micro or max(1, shape.global_batch // MS11.fsdp_size)
        return train_step(model, make_adamw(AdamWConfig()), batch, n_micro, key)
    params = meta_params(model)
    dm = DecodeModel(model, make_decode_spec(model, shape), lane_block=LANE_BLOCK)
    kind, args = input_specs(model, shape, dm)
    if kind == "prefill":
        batch, key = args

        def run(_):
            return dm.prefill_fn(params, batch, key, dm.init_cache_local(META))
        return Step(kind, model, run, params, batch, 1)
    cache, tokens, pos, key = args

    def run(_):
        return dm.decode_fn(params, cache, tokens, pos, key)
    return Step(kind, model, run, {"params": params, "cache": cache}, tokens, 1)


def count(step: Step, k: int = 1) -> dict:
    """The counter's dict for one run of `step` (k microbatches)."""
    base = tensors_bytes(step.state) + tensors_bytes(step.inputs)
    with Counter("meta", base=base) as c:
        out = step.run(k)
    res = c.counts()
    res["base_bytes"] = base
    state = storages(step.state)
    res["out_bytes"] = sum(n for sid, n in storages(out).items() if sid not in state)
    return res


def count_step(step: Step) -> dict:
    """The whole step's counts: a train step counted at 1 and 2
    microbatches, the rest charged as the second."""
    if step.kind != "train":
        return count(step)
    one = count(step, 1)
    if step.n_micro == 1:
        return one
    two = count(step, 2)
    total = scaled(one, marginal(two, one), step.n_micro - 1)
    for k in ("peak_live_bytes", "host_tensor_bytes"):  # maxima, not sums
        total[k] = max(one[k], two[k])
    total["out_bytes"] = two["out_bytes"]
    return total


def collectives(model: Model, kind: str, counts: dict) -> dict:
    """The counter's collective dict with the wire bytes of the engine's
    own accounting (``step_comm_bytes``): a train step's 2 gathers and 1
    reduce-scatter per parameter, a serving step's 1 gather.  0 at one
    rank, where no collective is launched."""
    train = kind == "train"
    comm = step_comm_bytes(model.engine, gathers_per_param=2 if train else 1,
                           reduces_per_param=1 if train else 0)
    coll = dict(counts["collectives"])
    coll["all-gather"] = comm["weight_gather"]
    coll["reduce-scatter"] = comm["grad_reduce"]
    coll["total"] = comm["total"]
    return coll


def model_flops(cfg, shape) -> float:
    """The reference's MODEL_FLOPS: 6·N·T to train, 2·N·T to prefill, 2·N
    per sequence to decode (N active parameters)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def run_one(arch: str, shape_name: str, qsdp: QSDPConfig | None = None,
            verbose: bool = True, n_micro: int | None = None, cfg=None) -> dict:
    """Count one (arch, shape) step and return its record: the roofline
    report's fields, ``ok``, ``t_count_s``, ``memory`` (``args``: the
    state's bytes; ``temp``: the peak of live bytes above them; ``out``: the
    new bytes the step returns), ``qsdp``, ``flops_by_dtype`` and
    ``launches``."""
    qsdp = qsdp or QSDPConfig(**DEFAULT_QSDP)
    t0 = time.time()
    step = build_step(arch, shape_name, qsdp, n_micro=n_micro, cfg=cfg)
    counts = count_step(step)
    counts["collectives"] = collectives(step.model, step.kind, counts)
    t_count = time.time() - t0
    args_b = tensors_bytes(step.state)
    temp = counts["peak_live_bytes"] - args_b
    shape = SHAPES[shape_name]
    rep = roofline(arch, shape_name, MESH, counts, N_CHIPS, model_flops(step.model.cfg, shape),
                   HW_H100, peak_memory=temp)
    result = rep.to_dict()
    result.update(
        ok=True, t_count_s=t_count,
        memory=dict(temp=temp, args=args_b, out=counts["out_bytes"]),
        qsdp=dict(w=qsdp.weight_bits if qsdp.quantize_weights else "fp32",
                  g=qsdp.grad_bits if qsdp.quantize_grads else "bf16",
                  hierarchical=False),
        flops_by_dtype=counts["flops_by_dtype"], launches=counts["launches"],
        peak_live_bytes=counts["peak_live_bytes"], n_micro=step.n_micro,
        host_tensor_bytes=counts["host_tensor_bytes"],
    )
    if verbose:
        print(rep.summary())
        print(f"  count {t_count:.1f}s  mem(temp)={_fmt(temp)} args={_fmt(args_b)}  "
              f"coll={_fmt(result['collective_bytes'])} ({result['collectives']['counts']})  "
              f"flops {counts['flops_by_dtype']}  launches {counts['launches']}")
    return result


def _fmt(b):
    if b is None:
        return "n/a"
    for u in ("B", "KB", "MB", "GB", "TB"):
        if b < 1024:
            return f"{b:.1f}{u}"
        b /= 1024
    return f"{b:.1f}PB"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--baseline-fsdp", action="store_true",
                    help="count the unquantized FSDP baseline instead of QSDP")
    ap.add_argument("--hierarchical", action="store_true")
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    for flag, item in ((args.multi_pod, "--multi-pod"), (args.both_meshes, "--both-meshes")):
        if flag:
            sys.exit(f"{item}: the production meshes need a dry run over ranks (ROADMAP "
                     f"A12e); the port's dry run counts the {MESH} mesh")
    if args.hierarchical:
        sys.exit("--hierarchical: two-level gathers are not ported yet (ROADMAP A3b)")
    if not args.all and args.arch is None:
        ap.error("give --arch (and --shape) or --all")

    qsdp = (QSDPConfig.baseline() if args.baseline_fsdp
            else QSDPConfig(weight_bits=args.bits, grad_bits=args.bits))
    archs = configs.ASSIGNED if args.all else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]

    results = []
    for arch in archs:
        for shape in shapes:
            try:
                results.append(run_one(arch, shape, qsdp))
            except Exception as e:  # a pair that fails is a record, as in the reference
                print(f"FAIL {arch} x {shape} x {MESH}: {e}")
                traceback.print_exc()
                results.append(dict(arch=arch, shape=shape, mesh=MESH, ok=False, error=str(e)))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
        print(f"wrote {args.out}")
    n_ok = sum(bool(r.get("ok")) for r in results)
    print(f"{n_ok}/{len(results)} pairs counted OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
