"""Shared set-up of the port's multi-rank tests (``test_torch_dist_*.py``,
``test_torch_tp_*.py``); imports no JAX.

The port's ranks are fresh interpreters (never forks of the pytest worker,
which has imported JAX), one per rank, started by :func:`run_ranks`: each
runs this file as a script, forms the gloo groups of a (P, M) mesh of P·M
ranks that meet through a ``FileStore`` in the test's temporary directory
(no ports to collide between test workers), runs one of the rank functions
below on one intra-op thread and writes what it returns to
``rank{r}.npz``.  A rank function of the (P, 1) mesh takes ``(group, rank,
p, workdir)``; one whose name starts with ``tp_`` takes ``(groups, (d, m),
(P, M), workdir)``, its data and model groups and its place on the mesh;
one whose name starts with ``pod_`` runs on a (Q, D, M) ("pod", "data",
"model") mesh of Q·D·M ranks and takes ``((fsdp_group, model_group,
pod_group, inner_group), (q, d, m), (Q, D, M), workdir)``.  Every wait has
a deadline; a rank that fails or outlives it fails the test with the
ranks' stderr.

The JAX package's side runs in a process of its own as well
(``_torch_dist_jax.py``, :func:`start_reference`), with XLA's host device
count set before JAX is imported, and writes ``reference.npz``; a test file
starts it once (a module-scoped fixture) and runs its ranks meanwhile.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"

# the train tests' configuration: gpt-1.3b's smoke config, B x S tokens a
# step, split over the P ranks and then into n_micro microbatches
ARCH, B, S, LR, STEPS = "gpt-1.3b", 4, 32, 1e-3, 10
N_MICRO = {1: 2, 2: 2, 4: 1}
# f32 compute, as the one-rank step comparisons run (both sides compute the
# same function; in bf16 the two frameworks' roundings of the activations
# differ by more than the step tolerances)
COMPUTE_DTYPE = "float32"


def _env(threads=1):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(TESTS), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = str(threads)
    env.pop("XLA_FLAGS", None)
    return env


def _wait(procs, logs, deadline, what):
    """Wait for every process until `deadline`; kill them all and fail with
    their stderr if one fails or the deadline passes."""
    failed = None
    for i, pr in enumerate(procs):
        try:
            if pr.wait(timeout=max(deadline - time.time(), 0.1)) != 0 and failed is None:
                failed = f"{what} {i} exited with {pr.returncode}"
        except subprocess.TimeoutExpired:
            failed = failed or f"{what} {i} did not finish in time"
            break
    if failed:
        for pr in procs:
            pr.kill()
            pr.wait()
        tails = "\n".join(f"--- {what} {i} stderr ---\n" + Path(log).read_text()[-3000:]
                          for i, log in enumerate(logs))
        raise AssertionError(f"{failed}\n{tails}")


def run_ranks(fn: str, p: int, workdir, timeout: float = 240.0, m: int = 1,
              q: int = None) -> list[dict]:
    """Run rank function `fn` of this module as ranks 0..P·M-1 of the gloo
    groups of a (P, M) mesh, each in its own interpreter; returns each
    rank's results, by global rank ``d·M + m``.  With `q`, the Q·P·M ranks
    of the (Q, P, M) pod mesh, by global rank ``q·P·M + d·M + m``."""
    workdir = Path(workdir)
    tag = f"{fn}_Q{q}D{p}M{m}" if q else f"{fn}_P{p}" + (f"M{m}" if m > 1 else "")
    store = workdir / f"store_{tag}"
    procs, logs = [], []
    world = p * m * (q or 1)
    for r in range(world):
        log = workdir / f"{tag}_rank{r}.err"
        logs.append(log)
        with open(log, "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, fn, str(r), str(p), str(m), str(workdir), tag,
                 str(store), *([str(q)] if q else [])],
                stdout=subprocess.DEVNULL, stderr=err, env=_env()))
    _wait(procs, logs, time.time() + timeout, f"{tag} rank")
    return [dict(np.load(workdir / f"{tag}_rank{r}.npz")) for r in range(world)]


def start_reference(what: str, workdir, ps, devices: int = 4):
    """`ps`: the P of each (P,) or (P, 1) mesh, or "PxM" strings."""
    """Start the JAX package's side (``_torch_dist_jax.py what``) on `devices`
    host devices; :func:`reference` waits for it."""
    env = _env(threads=2)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    log = Path(workdir) / f"reference_{what}.err"
    with open(log, "w") as err:
        proc = subprocess.Popen([sys.executable, str(TESTS / "_torch_dist_jax.py"), what,
                                 str(workdir), *map(str, ps)],
                                stdout=subprocess.DEVNULL, stderr=err, env=env)
    return proc, log, time.time()


def reference(started, workdir, timeout: float = 300.0) -> dict:
    proc, log, t0 = started
    _wait([proc], [log], t0 + timeout, "reference")
    return dict(np.load(Path(workdir) / "reference.npz"))


# ---------------------------------------------------------------------------
# inputs (numpy, from seeds)
# ---------------------------------------------------------------------------


def layer_names():
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    m = Model(configs.get_smoke(ARCH), MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
    return tuple(sorted(n for n in m.specs if n.startswith("layers/"))), m.specs


def collective_inputs(ps, seed=0) -> dict:
    """Per P: x (P, 3000) the ranks' shards (3 buckets of 1,024, the last
    padded), g (P, P * 2500) the ranks' full gradients, and a smoke layer's
    shards and gradients at the (P, 1) mesh."""
    rng = np.random.default_rng(seed)
    names, specs = layer_names()
    out = {}
    for p in ps:
        out[f"P{p}/x"] = (rng.standard_normal((p, 3000)) * 0.02).astype(np.float32)
        out[f"P{p}/g"] = (rng.standard_normal((p, p * 2500)) * 1e-3).astype(np.float32)
        from repro_torch.core.qsdp import MeshSpec
        ms = MeshSpec(("data", "model"), (p, 1))
        for i, n in enumerate(names):
            nl = specs[n].n_local(ms)
            out[f"P{p}/layer_x{i}"] = (rng.standard_normal((p, nl)) * 0.02).astype(np.float32)
            out[f"P{p}/layer_g{i}"] = (rng.standard_normal((p, p * nl)) * 1e-3).astype(
                np.float32)
    return out


def train_inputs(ps, seed=0) -> dict:
    """Per P: the initial state S0 (params drawn as the port's init draws
    them, as whole (stack?, 1, P, n_local) leaves), a later state S1 (what
    one AdamW step with a random gradient leaves: params moved, moments,
    step 1) and two global batches."""
    import torch
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig, init_param
    from repro_torch.models.transformer import Model
    rng = np.random.default_rng(seed)
    out = {"meta": np.array(json.dumps(dict(lr=LR, steps=STEPS, n_micro=N_MICRO,
                                            compute_dtype=COMPUTE_DTYPE)))}
    for p in ps:
        ms = MeshSpec(("data", "model"), (p, 1))
        specs = Model(configs.get_smoke(ARCH), MeshSpec(("data", "model"), (1, 1)),
                      QSDPConfig()).specs
        gen = torch.Generator().manual_seed(seed)
        for n, spec in sorted(specs.items()):
            w = init_param(gen, spec, ms, "cpu").numpy()
            out[f"P{p}/S0/params/{n}"] = w
            # the state one AdamW step (betas 0.9, 0.95) with a random
            # gradient g1 leaves
            g1 = (1e-3 * rng.standard_normal(w.shape)).astype(np.float32)
            out[f"P{p}/S1/params/{n}"] = (w - LR * np.sign(g1)).astype(np.float32)
            out[f"P{p}/S1/mu/{n}"] = (0.1 * g1).astype(np.float32)
            out[f"P{p}/S1/nu/{n}"] = (0.05 * g1 * g1).astype(np.float32)
        out[f"P{p}/S1/step"] = np.array(1, np.int32)
        for i in (0, 1):
            for k in ("tokens", "labels"):
                out[f"P{p}/batch{i}/{k}"] = rng.integers(0, 1024, (B, S)).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# rank functions: (group, rank, p, workdir) -> {name: numpy array}
# ---------------------------------------------------------------------------


def _np(t):
    import torch
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def collectives_rank(group, rank, p, workdir):
    """Every exchange and collective of ``core.collectives`` on this rank's
    inputs, as ``_torch_dist_jax.collectives`` runs the reference's."""
    import torch
    from repro_torch import configs
    from repro_torch.core import collectives as coll
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.core.quant import QuantConfig, quantize
    from repro_torch.models.transformer import Model

    z = np.load(Path(workdir) / "inputs.npz")
    x = torch.from_numpy(z[f"P{p}/x"][rank].copy())
    g = torch.from_numpy(z[f"P{p}/g"][rank].copy())
    key = prng.PRNGKey(7)
    out = {}
    coll.reset_comm()
    for dt in ("float32", "bfloat16"):
        out[f"fp_gather_{dt}"] = _np(coll.all_gather_fp(
            x, group, None if dt == "float32" else torch.bfloat16))
    for name, cfg in (("w8", QuantConfig(bits=8, mode="shift")),
                      ("w4", QuantConfig(bits=4, mode="shift"))):
        out[f"q_gather_{name}"] = _np(coll.all_gather_quantized(x, cfg, key, group,
                                                                out_dtype=torch.float32))
        q = quantize(x, cfg, key)
        out[f"q_gather_{name}_codes"] = _np(coll._gather(q.codes, group).reshape(-1))
        out[f"q_gather_{name}_scale"] = _np(coll._gather(q.scale, group))
        out[f"q_gather_{name}_zero"] = _np(coll._gather(q.zero, group))
    out["q_rs_g8"] = _np(coll.reduce_scatter_quantized(
        g, QuantConfig(bits=8, mode="stochastic"), key, group))
    out["fp_rs_bfloat16"] = _np(coll.reduce_scatter_fp(g, group, torch.bfloat16))

    eng = Model(configs.get_smoke(ARCH), MeshSpec(("data", "model"), (p, 1)), QSDPConfig(),
                group).engine
    names = tuple(sorted(n for n in eng.specs if n.startswith("layers/")))
    lay, rs_lay = eng.layout(names), eng.rs_layout(names)
    out["layer_segments"] = np.array([[s.n, s.cfg is not None, s.cfg.bits if s.cfg else 0]
                                      for s in lay.segments])
    out["layer_rs_segments"] = np.array([[s.n, s.cfg is not None] for s in rs_lay.segments])
    keys = [None if s.cfg is None else prng.fold_in(prng.PRNGKey(5), i)
            for i, s in enumerate(lay.segments)]
    rkeys = [None if s.cfg is None else prng.fold_in(prng.PRNGKey(5), i)
             for i, s in enumerate(rs_lay.segments)]
    xs = [torch.from_numpy(z[f"P{p}/layer_x{i}"][rank].copy()) for i in range(len(names))]
    gs = [torch.from_numpy(z[f"P{p}/layer_g{i}"][rank].copy()) for i in range(len(names))]
    out_dts = [torch.bfloat16 if s.cfg is not None else torch.float32 for s in lay.segments]
    out["layer_gbuf"] = _np(coll.gather_wire(coll.encode_wire(xs, lay, keys), group))
    for i, v in enumerate(coll.all_gather_coalesced(xs, lay, keys, out_dts, group)):
        out[f"layer_gather{i}"] = _np(v)
    for i, v in enumerate(coll.reduce_scatter_coalesced(gs, rs_lay, rkeys, group)):
        out[f"layer_rs{i}"] = _np(v)
    for op in coll.COMM_OPS:
        out[f"comm/{op}"] = np.array([coll.COMM[op], coll.COMM_BYTES[op]])
    return out


def train_models(p, group=None, prefetch=False):
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
    model = Model(configs.get_smoke(ARCH), MeshSpec(("data", "model"), (p, 1)),
                  QSDPConfig(compute_dtype=COMPUTE_DTYPE, prefetch=prefetch), group)
    opts = [make_adamw(AdamWConfig(lr=LR, schedule=cosine_schedule(LR, 2, STEPS),
                                   moment_bits=mb)) for mb in (None, 8)]
    return model, opts


def _flat_out(prefix, state):
    from repro_torch.train.checkpoint import state_to_flat
    flat, _ = state_to_flat(state)
    # copies: a CPU tensor's numpy view would follow the next in-place update
    return {f"{prefix}/{k}": np.array(v) for k, v in flat.items()}


def train_rank(group, rank, p, workdir):
    """The four steps of ``_torch_dist_jax.train`` on this rank's block of
    the states and its rows of the batches: A and B f32 state, Q
    quantized_state, P step A under ``QSDPConfig(prefetch=True)``; the
    wire traffic of A and of P by op, and A's first gathered buffer (the
    embedding's)."""
    import torch
    from repro_torch.core import collectives as coll
    from repro_torch.core import prng
    from repro_torch.train.step import (TrainState, build_train_step, local_batch,
                                        quantize_train_state)
    from repro_torch.weights import params_from_jax, train_state_from_jax

    z = np.load(Path(workdir) / "inputs.npz")
    model, (opt, opt8) = train_models(p, group)
    model_pf, _ = train_models(p, group, prefetch=True)
    names = sorted(model.specs)
    s0 = {n: z[f"P{p}/S0/params/{n}"] for n in names}

    def start(tag, o):
        if tag == "S0":
            params = params_from_jax(s0, "cpu", model, rank)
            return TrainState(params=params, opt=o.init(params))
        flat = {f"params/{n}": z[f"P{p}/S1/params/{n}"] for n in names}
        flat.update({f"opt/{k}/{n}": z[f"P{p}/S1/{k}/{n}"] for k in ("mu", "nu") for n in names})
        flat["opt/step"] = z[f"P{p}/S1/step"]
        return train_state_from_jax(flat, {}, "cpu", model, rank)

    def batch(i):
        b = {k: torch.from_numpy(z[f"P{p}/batch{i}/{k}"]).long() for k in ("tokens", "labels")}
        return local_batch(b, rank, p)

    out = {}
    first = []
    orig = coll.gather_wire

    def capture(buf, *groups):
        res = orig(buf, *groups)
        if not first:
            first.append(_np(res))
        return res

    for tag, (src, i, qstate, o) in {"A": ("S0", 0, False, opt), "B": ("S1", 1, False, opt),
                                     "Q": ("S0", 0, True, opt8),
                                     "P": ("S0", 0, False, opt)}.items():
        st = start(src, o)
        if qstate:
            st = quantize_train_state(st, model, prng.PRNGKey(2))
            out.update(_flat_out(f"{tag}/start", st))
        step = build_train_step(model_pf if tag == "P" else model, o, n_micro=N_MICRO[p],
                                quantized_state=qstate, device="cpu")
        coll.reset_comm()
        coll.gather_wire = capture if tag == "A" else orig
        try:
            st, m = step(st, batch(i), prng.fold_in(prng.PRNGKey(1), i))
        finally:
            coll.gather_wire = orig
        if tag == "A":
            out["A/first_gbuf"] = first[0]
            out.update(_step_accounting(model, group))
        if tag in ("A", "P"):
            for op in coll.COMM_OPS:
                out[f"{tag}/comm/{op}"] = np.array([coll.COMM[op], coll.COMM_BYTES[op]])
        out[f"{tag}/loss"] = _np(m["loss"])
        out[f"{tag}/grad_norm"] = _np(m["grad_norm"])
        out.update(_flat_out(f"{tag}/flat", st))
    return out


def _step_accounting(model, group, model_group=None) -> dict:
    """What one microbatch of a step moves by the analytic model: the
    stacked params gathered twice and the top-level ones once
    (``step_comm_bytes`` of an engine over each set), every one
    reduce-scattered once."""
    from repro_torch.core.qsdp import QSDPEngine, step_comm_bytes
    specs = model.specs
    stacked = {n: s for n, s in specs.items() if s.stack is not None}
    top = {n: s for n, s in specs.items() if s.stack is None}
    eng_l, eng_t = (QSDPEngine(model.ms, model.qcfg, sp, group, model_group)
                    for sp in (stacked, top))
    wl, wt = step_comm_bytes(eng_l, 2, 1), step_comm_bytes(eng_t, 1, 1)
    return {"A/want_bytes": np.array([wl["weight_gather"], wt["weight_gather"],
                                      wl["grad_reduce"], wt["grad_reduce"]])}


def one_rank_rank(group, rank, p, workdir):
    """One step of the smoke config through a gloo group of one rank and
    with ``group=None``, from the same state: both results."""
    import torch
    from repro_torch.core import collectives as coll
    from repro_torch.core import prng
    from repro_torch.train.step import build_train_step, init_train_state

    out = {}
    z = np.load(Path(workdir) / "inputs.npz")
    b = {k: torch.from_numpy(z[f"P2/batch0/{k}"]).long() for k in ("tokens", "labels")}
    for tag, grp in (("group", group), ("none", None)):
        model, (opt, _) = train_models(1, grp)
        step = build_train_step(model, opt, n_micro=N_MICRO[1], device="cpu")
        coll.reset_comm()
        st, m = step(init_train_state(model, opt, 0, "cpu"), b, prng.fold_in(prng.PRNGKey(1), 0))
        out[f"{tag}/loss"] = _np(m["loss"])
        out[f"{tag}/grad_norm"] = _np(m["grad_norm"])
        out.update(_flat_out(f"{tag}/flat", st))
        out[f"{tag}/calls"] = np.array([coll.COMM[op] for op in coll.COMM_OPS])
    return out


def ckpt_rank(group, rank, p, workdir):
    """The reference's states after steps A and Q (its (P, 1) mesh, from
    ``reference.npz``), each rank taking its block, saved over the group
    (rank 0 writes) and loaded back block by block."""
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint, state_to_flat
    from repro_torch.weights import train_state_from_jax

    ref = np.load(Path(workdir) / "reference.npz")
    model, _ = train_models(p, group)
    out = {}
    for tag in ("A", "Q"):
        pre = f"P{p}/{tag}/flat/"
        flat = {k[len(pre):]: ref[k] for k in ref.files if k.startswith(pre)}
        leaves = json.loads(str(ref[f"P{p}/{tag}/leaves"]))
        st = train_state_from_jax(flat, leaves, "cpu", model, rank)
        path = str(Path(workdir) / f"port_ckpt_{tag}")
        save_checkpoint(path, st, meta=dict(arch="gpt-1.3b-smoke", steps=1), group=group)
        back = load_checkpoint(path, "cpu", mesh_sizes=(1, p), rank=rank)
        a, b = state_to_flat(st)[0], state_to_flat(back)[0]
        out[f"{tag}/reloaded_equal"] = np.array(
            list(a) == list(b) and all(a[k].tobytes() == b[k].tobytes() for k in a))
    return out


def launch_rank(group, rank, p, workdir):
    """The train launcher's run (``--smoke --device cpu --data-par P --steps
    2 --batch 4 --seq 32``) through the library: the same model, state, batches
    and keys on this rank's rows; the losses."""
    from repro_torch.core import prng
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.train.step import build_train_step, init_train_state, local_batch
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw

    cfg = configs.get_smoke(ARCH)
    model = Model(cfg, MeshSpec(("data", "model"), (p, 1)), QSDPConfig(), group)
    opt = make_adamw(AdamWConfig(lr=6e-4, schedule=cosine_schedule(6e-4, 10, 2)))
    state = init_train_state(model, opt, 0, "cpu")
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0)
    step = build_train_step(model, opt, n_micro=1, device="cpu")
    losses = []
    for i in range(2):
        state, m = step(state, local_batch(make_batch(data, i, "cpu"), rank, p),
                        prng.fold_in(prng.PRNGKey(1), i))
        losses.append(float(m["loss"]))
    return {"losses": np.array(losses)}


# ---------------------------------------------------------------------------
# the (P, M) mode: tensor parallelism on the model axis
# ---------------------------------------------------------------------------

# the dense layer's archs: gpt-1.3b (KV split over the model ranks) and
# qwen2.5-3b (qkv bias; its 2 KV heads split at M = 2, replicated at M = 4)
TP_ARCHS = ("gpt-1.3b", "qwen2.5-3b")
# the embedding and cross-entropy case: a (V, d) shard split on V, T tokens
XENT_V, XENT_D, XENT_BS = 256, 32, (2, 12)
LAYER_BS = (2, 16)


def tp_model(arch, p, m, group=None, model_group=None, model_rank=None, compute_dtype=None,
             prefetch=False):
    """`arch`'s smoke config on the (P, M) mesh; without a model group the
    engine computes `model_rank`'s share (0 unless given)."""
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    if model_group is None and model_rank is None:
        model_rank = 0
    return Model(configs.get_smoke(arch), MeshSpec(("data", "model"), (p, m)),
                 QSDPConfig(compute_dtype=compute_dtype or COMPUTE_DTYPE, prefetch=prefetch),
                 group, model_group, model_rank)


def tp_local(full: np.ndarray, spec, m: int) -> np.ndarray:
    """A logical (unstacked) tensor -> its M TP-local shards, (M, *tp-local
    shape), as ``to_rest`` lays them out on the model axis."""
    import dataclasses

    import torch
    from repro_torch.core.qsdp import MeshSpec, to_rest
    spec = dataclasses.replace(spec, stack=None)
    rest = to_rest(torch.from_numpy(full), spec, MeshSpec(("data", "model"), (1, m))).numpy()
    n = spec.n_logical_local(m)
    return rest[:, 0, :n].reshape(m, *spec.tp_local_shape(m)).copy()


def tp_block_inputs(ms, seed=0) -> dict:
    """Per (1, M) mesh: (a) the tp ops' inputs and cotangents, (b) the
    embedding's and the cross-entropy's (a vocabulary of XENT_V split on its
    rows, labels every fifth masked), (c) one smoke layer of each of TP_ARCHS:
    its weights drawn at their logical shapes and split by ``tp_local``, x
    and the output's cotangent."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = {"meta": np.array(json.dumps(dict(archs=TP_ARCHS)))}
    v, d, (b, s) = XENT_V, XENT_D, XENT_BS
    for m in ms:
        pre = f"1x{m}/"
        out[pre + "tp/xl"] = rng.standard_normal((m, 96)).astype(f32)
        out[pre + "tp/xr"] = rng.standard_normal(96).astype(f32)
        out[pre + "tp/ctc"] = rng.standard_normal((m, 96)).astype(f32)
        out[pre + "tp/ctr"] = rng.standard_normal(96).astype(f32)
        out[pre + "xent/tokens"] = rng.integers(0, v, (b, s)).astype(np.int32)
        out[pre + "xent/emb"] = (0.5 * rng.standard_normal((v, d))).astype(f32).reshape(
            m, v // m, d)
        out[pre + "xent/cte"] = rng.standard_normal((b, s, d)).astype(f32)
        out[pre + "xent/h"] = rng.standard_normal((b * s, d)).astype(f32)
        out[pre + "xent/w"] = (0.5 * rng.standard_normal((v, d))).astype(f32).reshape(
            m, v // m, d)
        labels = rng.integers(0, v, b * s).astype(np.int32)
        labels[::5] = -1
        out[pre + "xent/labels"] = labels
        for arch in TP_ARCHS:
            model = tp_model(arch, 1, m)
            dm = model.cfg.d_model
            for k, spec in model.specs.items():
                if not k.startswith("layers/"):
                    continue
                if spec.init == "ones":
                    full = 1.0 + 0.1 * rng.standard_normal(spec.shape)
                elif spec.init == "zeros":
                    full = 0.1 * rng.standard_normal(spec.shape)
                else:
                    full = rng.standard_normal(spec.shape) / np.sqrt(spec.shape[0])
                out[f"{pre}layer/{arch}/w/{k[len('layers/'):]}"] = tp_local(
                    full.astype(f32), spec, m)
            out[f"{pre}layer/{arch}/x"] = rng.standard_normal((*LAYER_BS, dm)).astype(f32)
            out[f"{pre}layer/{arch}/ct"] = rng.standard_normal((*LAYER_BS, dm)).astype(f32)
    return out


def tp_blocks_rank(groups, coords, shape, workdir):
    """``_torch_dist_jax.tp_blocks`` on this model rank's inputs, its
    collectives over the model group."""
    import torch
    from repro_torch.core.tp import tp_copy, tp_reduce
    from repro_torch.models import layers as L

    group, model_group = groups
    _, m = coords
    p, n_m = shape
    z = np.load(Path(workdir) / "inputs.npz")
    pre = f"{p}x{n_m}/"

    def t(k, grad=False):
        x = torch.from_numpy(np.array(z[pre + k]))
        return x.requires_grad_() if grad else x

    def leaf(k):
        return t(k)[m].clone().requires_grad_()

    out = {}
    xl, xr = leaf("tp/xl"), t("tp/xr", True)
    y = tp_reduce(xl, model_group)
    out["tp/reduce"] = _np(y)
    out["tp/reduce_dx"] = _np(torch.autograd.grad(y, xl, t("tp/ctr"))[0])
    y = tp_copy(xr, model_group)
    out["tp/copy"] = _np(y)
    out["tp/copy_dx"] = _np(torch.autograd.grad(y, xr, t("tp/ctc")[m])[0])

    emb = leaf("xent/emb")
    e = L.embed_vocab_parallel(t("xent/tokens").long(), emb, m, model_group)
    out["xent/embed"] = _np(e)
    out["xent/embed_dw"] = _np(torch.autograd.grad(e, emb, t("xent/cte"))[0])
    h, w = t("xent/h", True), leaf("xent/w")
    loss = L.vocab_parallel_xent(h, w, t("xent/labels").long(), m, model_group)
    out["xent/loss"] = _np(loss)
    out["xent/dh"], out["xent/dw"] = map(_np, torch.autograd.grad(loss, (h, w)))

    for arch in TP_ARCHS:
        model = tp_model(arch, p, n_m, group, model_group, compute_dtype="float32")
        wpre = f"{pre}layer/{arch}/w/"
        names = sorted(k[len(wpre):] for k in z.files if k.startswith(wpre))
        ws = {n: leaf(f"layer/{arch}/w/{n}") for n in names}
        x = t(f"layer/{arch}/x", True)
        pos = torch.arange(x.shape[1])
        cos, sin = L.rope_cos_sin(pos, model.cfg.head_dim, model.cfg.rope_theta)
        y = model._dense_layer(x, ws, cos, sin, pos)
        out[f"layer/{arch}/y"] = _np(y)
        grads = torch.autograd.grad(y, [x, *ws.values()], t(f"layer/{arch}/ct"))
        out[f"layer/{arch}/dx"] = _np(grads[0])
        for n, g in zip(ws, grads[1:]):
            out[f"layer/{arch}/dw/{n}"] = _np(g)
    return out


def tp_launch_rank(groups, coords, shape, workdir):
    """``launch_rank`` on the (P, M) mesh: the train launcher's run at
    ``--data-par P --model-par M`` through the library, this rank's data
    rank's rows; the losses."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
    from repro_torch.train.step import build_train_step, init_train_state, local_batch

    group, model_group = groups
    d, _ = coords
    p, m = shape
    model = tp_model(ARCH, p, m, group, model_group, compute_dtype="bfloat16")
    opt = make_adamw(AdamWConfig(lr=6e-4, schedule=cosine_schedule(6e-4, 10, 2)))
    state = init_train_state(model, opt, 0, "cpu")
    data = SyntheticLM(vocab_size=configs.get_smoke(ARCH).vocab_size, seq_len=S, global_batch=B,
                       seed=0)
    step = build_train_step(model, opt, n_micro=1, device="cpu")
    losses = []
    for i in range(2):
        state, mt = step(state, local_batch(make_batch(data, i, "cpu"), d, p),
                         prng.fold_in(prng.PRNGKey(1), i))
        losses.append(float(mt["loss"]))
    return {"losses": np.array(losses)}


# per arch, the meshes of the step comparisons and the runs at each (U: Q's
# update alone, from Q's start state decoded to f32, without re-encoding)
TP_TRAIN = {"gpt-1.3b": (((1, 2), (2, 2), (1, 4)), ("A", "B", "Q", "U")),
            "qwen2.5-3b": (((1, 4), (2, 2)), ("A",))}
TP_CKPT_ARCH = "gpt-1.3b"   # the (2, 2) checkpoint: its states after A and Q
# run P (step A under QSDPConfig(prefetch=True)) of TP_CKPT_ARCH at these meshes
TP_PREFETCH = ((1, 2),)


def tp_train_inputs(archs=tuple(TP_TRAIN), seed=0) -> dict:
    """Per arch and (P, M) mesh: the initial state S0 (the port's init, as
    whole (stack?, M, P, n_local) leaves), a later state S1 (one AdamW step
    with a random gradient drawn at the logical shapes, so a model-
    replicated leaf's M rows stay equal) and two global batches."""
    import torch
    from repro_torch.core.qsdp import MeshSpec, init_param, to_rest
    rng = np.random.default_rng(seed)
    out = {"meta": np.array(json.dumps(dict(
        lr=LR, steps=STEPS, n_micro=N_MICRO, compute_dtype=COMPUTE_DTYPE,
        runs={a: TP_TRAIN[a][1] for a in archs}, meshes={a: TP_TRAIN[a][0] for a in archs},
        ckpt_arch=TP_CKPT_ARCH, prefetch=TP_PREFETCH)))}
    for arch in archs:
        for p, m in TP_TRAIN[arch][0]:
            pre = f"{arch}/{p}x{m}/"
            ms = MeshSpec(("data", "model"), (p, m))
            gen = torch.Generator().manual_seed(seed)
            # the specs depend on M alone (the KV mode)
            for n, spec in sorted(tp_model(arch, 1, m).specs.items()):
                out[f"{pre}S0/params/{n}"] = init_param(gen, spec, ms, "cpu").numpy()
                lead = (spec.stack,) if spec.stack is not None else ()
                g1 = torch.from_numpy((1e-3 * rng.standard_normal(lead + spec.shape)).astype(
                    np.float32))
                w0 = torch.from_numpy(out[f"{pre}S0/params/{n}"])
                rest = lambda x, spec=spec: to_rest(x, spec, ms).numpy()  # noqa: E731
                out[f"{pre}S1/params/{n}"] = (w0 - LR * torch.sign(torch.from_numpy(
                    rest(g1)))).numpy()
                out[f"{pre}S1/mu/{n}"] = rest(0.1 * g1)
                out[f"{pre}S1/nu/{n}"] = rest(0.05 * g1 * g1)
            out[f"{pre}S1/step"] = np.array(1, np.int32)
            for i in (0, 1):
                for k in ("tokens", "labels"):
                    out[f"{pre}batch{i}/{k}"] = rng.integers(0, 1024, (B, S)).astype(np.int32)
    return out


def tp_train_rank(groups, coords, shape, workdir):
    """``_torch_dist_jax.tp_train``'s runs of every arch at this mesh on
    this rank's block of the states and its data rank's rows of the
    batches; run A's first gathered buffer, its wire traffic by op, and
    per leaf the sum of squares of its gradient (the step's
    ``global_norm`` input) with the leaf's model-replication; run U's new
    state encoded as Q's step encodes its master (``U/encoded``); at the
    meshes of ``meta["prefetch"]`` run P, step A of the prefetch model."""
    import torch
    from repro_torch.core import collectives as coll
    from repro_torch.core import prng
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
    from repro_torch.train import step as step_mod
    from repro_torch.train.step import (TrainState, build_train_step,
                                        dequantize_train_state, local_batch,
                                        quantize_train_state)
    from repro_torch.weights import params_from_jax, train_state_from_jax

    group, model_group = groups
    d, m = coords
    p, n_m = shape
    z = np.load(Path(workdir) / "inputs.npz")
    meta = json.loads(str(z["meta"]))
    out = {}
    for arch, runs in meta["runs"].items():
        if [p, n_m] not in meta["meshes"][arch]:
            continue
        pre = f"{arch}/{p}x{n_m}/"
        model = tp_model(arch, p, n_m, group, model_group)
        model_pf = tp_model(arch, p, n_m, group, model_group, prefetch=True)
        tags = runs
        if arch == meta["ckpt_arch"] and [p, n_m] in meta["prefetch"]:
            tags = [*runs, "P"]
        sched = cosine_schedule(LR, 2, STEPS)
        opt = make_adamw(AdamWConfig(lr=LR, schedule=sched))
        opt8 = make_adamw(AdamWConfig(lr=LR, schedule=sched, moment_bits=8))
        names = sorted(model.specs)

        def start(tag, o):
            if tag == "S0":
                params = params_from_jax({n: z[f"{pre}S0/params/{n}"] for n in names}, "cpu",
                                         model, d, m)
                return TrainState(params=params, opt=o.init(params))
            flat = {f"params/{n}": z[f"{pre}S1/params/{n}"] for n in names}
            flat.update({f"opt/{k}/{n}": z[f"{pre}S1/{k}/{n}"] for k in ("mu", "nu")
                         for n in names})
            flat["opt/step"] = z[f"{pre}S1/step"]
            return train_state_from_jax(flat, {}, "cpu", model, d, m)

        first, sq = [], {}
        orig_gw, orig_norm = coll.gather_wire, step_mod.global_norm

        def capture(buf, *groups):
            res = orig_gw(buf, *groups)
            if not first:
                first.append(_np(res))
            return res

        def norm(grads, *a):
            for k, g in grads.items():
                sq[k] = sum(float(torch.sum(x.double() ** 2)) for x in
                            (g if isinstance(g, list) else [g]))
            return orig_norm(grads, *a)

        for tag in tags:
            src, i, qstate, o = {"A": ("S0", 0, False, opt), "B": ("S1", 1, False, opt),
                                 "Q": ("S0", 0, True, opt8), "U": ("S0", 0, False, opt8),
                                 "P": ("S0", 0, False, opt)}[tag]
            st = start(src, o)
            if tag in ("Q", "U"):
                st = quantize_train_state(st, model, prng.PRNGKey(2))
            if tag == "Q":
                out.update(_flat_out(f"{arch}/{tag}/start", st))
            if tag == "U":
                st = TrainState(params=dequantize_train_state(st).params, opt=st.opt)
            step = build_train_step(model_pf if tag == "P" else model, o, n_micro=N_MICRO[p],
                                    quantized_state=qstate, device="cpu")
            b = {k: torch.from_numpy(z[f"{pre}batch{i}/{k}"]).long()
                 for k in ("tokens", "labels")}
            coll.reset_comm()
            if tag == "A":
                coll.gather_wire, step_mod.global_norm = capture, norm
            try:
                st, mt = step(st, local_batch(b, d, p), prng.fold_in(prng.PRNGKey(1), i))
            finally:
                coll.gather_wire, step_mod.global_norm = orig_gw, orig_norm
            if tag == "A":
                out[f"{arch}/A/first_gbuf"] = first[0]
                out[f"{arch}/A/sq"] = np.array([sq[k] for k in names])
                out[f"{arch}/A/replicated"] = np.array(
                    [model.specs[k].tp_axis is None for k in names])
                out[f"{arch}/A/want_bytes"] = _step_accounting(model, group, model_group)[
                    "A/want_bytes"]
                for op in coll.COMM_OPS:
                    out[f"{arch}/A/comm/{op}"] = np.array([coll.COMM[op], coll.COMM_BYTES[op]])
            out[f"{arch}/{tag}/loss"] = _np(mt["loss"])
            out[f"{arch}/{tag}/grad_norm"] = _np(mt["grad_norm"])
            out.update(_flat_out(f"{arch}/{tag}/flat", st))
            if tag == "U":
                out.update(_flat_out(f"{arch}/U/encoded", quantize_train_state(
                    st, model, prng.fold_in(prng.PRNGKey(1), i))))
    return out


def tp_ckpt_rank(groups, coords, shape, workdir):
    """The reference's states after steps A and Q of TP_CKPT_ARCH at this
    mesh (from ``reference.npz``), each rank taking its (d, m) block, saved
    over both groups (global rank 0 writes) and loaded back block by
    block."""
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint, state_to_flat
    from repro_torch.weights import train_state_from_jax

    group, model_group = groups
    d, m = coords
    p, n_m = shape
    ref = np.load(Path(workdir) / "reference.npz")
    model = tp_model(TP_CKPT_ARCH, p, n_m, group, model_group)
    out = {}
    for tag in ("A", "Q"):
        pre = f"{TP_CKPT_ARCH}/{p}x{n_m}/{tag}/flat/"
        flat = {k[len(pre):]: ref[k] for k in ref.files if k.startswith(pre)}
        leaves = json.loads(str(ref[f"{TP_CKPT_ARCH}/{p}x{n_m}/{tag}/leaves"]))
        st = train_state_from_jax(flat, leaves, "cpu", model, d, m)
        path = str(Path(workdir) / f"port_ckpt_{tag}")
        save_checkpoint(path, st, meta=dict(arch=f"{TP_CKPT_ARCH}-smoke", steps=1), group=group,
                        model_group=model_group)
        back = load_checkpoint(path, "cpu", mesh_sizes=(n_m, p), rank=d, model_rank=m)
        a, b = state_to_flat(st)[0], state_to_flat(back)[0]
        out[f"{tag}/reloaded_equal"] = np.array(
            list(a) == list(b) and all(a[k].tobytes() == b[k].tobytes() for k in a))
    return out


# ---------------------------------------------------------------------------
# the (Q, D, M) mode: the pod axis and the two-level exchanges
# ---------------------------------------------------------------------------

POD_MESHES = ((2, 2, 1), (2, 2, 2))
POD_X, POD_CHUNK = 3000, 2500   # a rank's shard; a gradient's chunk at Q·D ranks
POD_KEY, POD_LAYER_KEY = 7, 5   # as the (P,) mode's KEY and LAYER_KEY
# the train runs: mesh, hierarchical, prefetch (F flat, H two-level, HP
# two-level under the prefetch pipeline); the checkpoint is H's state
POD_TRAIN = {"F": ((2, 2, 1), False, False), "H": ((2, 2, 1), True, False),
             "HP": ((2, 2, 2), True, True)}
POD_CKPT = "H"


def pod_key(shape) -> str:
    return "x".join(map(str, shape))


def pod_layouts(shape):
    """One gpt-1.3b smoke layer on the (Q, D, M) mesh under the default
    policy, from the tp-local specs of M model ranks: (names, the gather
    layout, the flat reduce-scatter layout (n_local a chunk; the pod level's
    too), the inner level's (D chunks: n_local·Q))."""
    from repro_torch.core import collectives as coll
    from repro_torch.core.qsdp import MeshSpec
    q, d, m = shape
    eng = tp_model(ARCH, 1, m).engine
    names = tuple(sorted(n for n in eng.specs if n.startswith("layers/")))
    ms = MeshSpec(("pod", "data", "model"), shape)
    c = eng.cfg

    def lay(grad, mult=1):
        return coll.WireLayout(tuple(
            coll.WireSegment(eng.specs[n].n_local(ms) * mult,
                             (c.gcfg() if eng._is_grad_quantized(eng.specs[n]) else None)
                             if grad else (c.wcfg() if eng._is_quantized(eng.specs[n])
                                           else None),
                             c.grad_wire_dtype if grad else c.weight_wire_dtype)
            for n in names))
    return names, lay(False), lay(True), lay(True, q)


def pod_collective_inputs(meshes=POD_MESHES, seed=0) -> dict:
    """Per (Q, D, M) mesh, row r global rank r's: x (N, POD_X) shards, g (N,
    Q·D·POD_CHUNK) full gradients, and the smoke layer's shards and full
    gradients (N = Q·D·M)."""
    rng = np.random.default_rng(seed)
    out = {}
    for shape in meshes:
        q, d, m = shape
        n, pre = q * d * m, pod_key(shape) + "/"
        out[pre + "x"] = (rng.standard_normal((n, POD_X)) * 0.02).astype(np.float32)
        out[pre + "g"] = (rng.standard_normal((n, q * d * POD_CHUNK)) * 1e-3).astype(np.float32)
        _, lay, rs, _ = pod_layouts(shape)
        for i, (sw, sg) in enumerate(zip(lay.segments, rs.segments)):
            out[f"{pre}layer_x{i}"] = (rng.standard_normal((n, sw.n)) * 0.02).astype(np.float32)
            out[f"{pre}layer_g{i}"] = (rng.standard_normal((n, q * d * sg.n)) * 1e-3).astype(
                np.float32)
    return out


def _capture(obj, attr, store):
    """Wrap obj.attr so each call's result is appended to `store`;
    returns the original, to set back."""
    orig = getattr(obj, attr)

    def f(*a, **k):
        res = orig(*a, **k)
        store.append(res)
        return res
    setattr(obj, attr, f)
    return orig


def _comm():
    from repro_torch.core import collectives as coll
    return {f"comm/{op}": np.array([coll.COMM[op], coll.COMM_BYTES[op]])
            for op in coll.COMM_OPS}


def pod_collectives_rank(groups, coords, shape, workdir):
    """``_torch_dist_jax.pod_collectives`` on this rank's inputs: the flat
    forms over the joint (data, pod) group; the per-tensor two-level gather
    and reduce-scatter with what each level delivered; the smoke layer's
    coalesced gathers and reduce-scatters, flat and two-level, the latter
    also step by step (the inner rows, the inner sums, the pod rows); each
    two-level call's wire traffic by op (``hier_*/comm/...``)."""
    import torch
    from repro_torch.core import collectives as coll
    from repro_torch.core import prng
    from repro_torch.core.quant import QuantConfig

    group, _, pod_group, inner_group = groups
    q, d, m = coords
    n_q, n_d, n_m = shape
    r = (q * n_d + d) * n_m + m
    z = np.load(Path(workdir) / "inputs.npz")
    pre = pod_key(shape) + "/"
    x = torch.from_numpy(z[pre + "x"][r].copy())
    g = torch.from_numpy(z[pre + "g"][r].copy())
    key = prng.PRNGKey(POD_KEY)
    w8, g8 = QuantConfig(bits=8, mode="shift"), QuantConfig(bits=8, mode="stochastic")
    out = {"fsdp_index": np.array(coll.fsdp_index(group))}
    out["flat/fp_gather"] = _np(coll.all_gather_fp(x, group))
    out["flat/q_gather_w8"] = _np(coll.all_gather_quantized(x, w8, key, group, torch.float32))
    out["flat/q_rs_g8"] = _np(coll.reduce_scatter_quantized(g, g8, key, group))
    out["flat/fp_rs_bfloat16"] = _np(coll.reduce_scatter_fp(g, group, torch.bfloat16))

    got = []
    orig = _capture(coll, "_gather", got)
    coll.reset_comm()
    try:
        out["hier/q_gather_w8"] = _np(coll.all_gather_hierarchical(
            x, w8, key, pod_group, inner_group, torch.float32))
    finally:
        coll._gather = orig
    out.update({f"hier_gather/{k}": v for k, v in _comm().items()})
    for lvl, part, t in zip(("pod", "pod", "pod", "inner", "inner", "inner"),
                            ("codes", "scale", "zero") * 2, got):
        out[f"hier/gather_{lvl}_{part}"] = _np(t)
    rows, sums = [], []
    orig = _capture(coll, "_all_to_all_rows", rows)
    orig_rs = _capture(coll, "reduce_scatter_quantized", sums)
    coll.reset_comm()
    try:
        out["hier/q_rs_g8"] = _np(coll.reduce_scatter_hierarchical(g, g8, key, pod_group,
                                                                   inner_group))
    finally:
        coll._all_to_all_rows, coll.reduce_scatter_quantized = orig, orig_rs
    out.update({f"hier_rs/{k}": v for k, v in _comm().items()})
    for lvl, part, t in zip(("inner", "inner", "inner", "pod", "pod", "pod"),
                            ("codes", "scale", "zero") * 2, rows):
        out[f"hier/rs_{lvl}_{part}"] = _np(t)
    out["hier/rs_inner_sum"] = _np(sums[0])

    names, lay, rs, rs_inner = pod_layouts(shape)
    out["layer_segments"] = np.array([[s.n, s.cfg is not None] for s in lay.segments])
    out["layer_rs_segments"] = np.array([[s.n, s.cfg is not None] for s in rs.segments])
    keys = [None if s.cfg is None else prng.fold_in(prng.PRNGKey(POD_LAYER_KEY), i)
            for i, s in enumerate(lay.segments)]
    rkeys = [None if s.cfg is None else prng.fold_in(prng.PRNGKey(POD_LAYER_KEY), i)
             for i, s in enumerate(rs.segments)]
    xs = [torch.from_numpy(z[f"{pre}layer_x{i}"][r].copy()) for i in range(len(names))]
    gs = [torch.from_numpy(z[f"{pre}layer_g{i}"][r].copy()) for i in range(len(names))]
    out_dts = [torch.bfloat16 if s.cfg is not None else torch.float32 for s in lay.segments]
    buf = coll.encode_wire(xs, lay, keys)
    out["layer/flat_gbuf"] = _np(coll.gather_wire(buf, group))
    out["layer/pod_gbuf"] = _np(coll.gather_wire(buf, pod_group))
    coll.reset_comm()
    out["layer/hier_gbuf"] = _np(coll.gather_wire(buf, inner_group, pod_group))
    out.update({f"hier_layer_gather/{k}": v for k, v in _comm().items()})
    for i, v in enumerate(coll.all_gather_coalesced(xs, lay, keys, out_dts, inner_group,
                                                    pod_group)):
        out[f"layer/hier_gather{i}"] = _np(v)
    for i, v in enumerate(coll.reduce_scatter_coalesced(gs, rs, rkeys, group)):
        out[f"layer/flat_rs{i}"] = _np(v)
    coll.reset_comm()
    for i, v in enumerate(coll.reduce_scatter_coalesced_hierarchical(
            gs, rs_inner, rs, rkeys, pod_group, inner_group)):
        out[f"layer/hier_rs{i}"] = _np(v)
    out.update({f"hier_layer_rs/{k}": v for k, v in _comm().items()})
    # the two levels step by step, as reduce_scatter_coalesced_hierarchical
    # runs them
    halves = [None if k is None else prng.split(k) for k in rkeys]
    inner_rows = coll._all_to_all_rows(
        coll.encode_rs_rows(gs, rs_inner, [h and h[0] for h in halves], n_d), inner_group)
    part = coll.decode_rs_rows(inner_rows, rs_inner)
    pod_rows = coll._all_to_all_rows(
        coll.encode_rs_rows(part, rs, [h and h[1] for h in halves], n_q), pod_group)
    out["layer/inner_rows"] = _np(inner_rows)
    out["layer/pod_rows"] = _np(pod_rows)
    for i, v in enumerate(part):
        out[f"layer/inner_sum{i}"] = _np(v)
    return out


def pod_train_inputs(seed=0) -> dict:
    """Per mesh of POD_TRAIN: the initial state S0 (the port's init, as whole
    (stack?, M, Q·D, n_local) leaves, the specs of M model ranks) and a
    global batch."""
    import torch
    from repro_torch.core.qsdp import MeshSpec, init_param
    rng = np.random.default_rng(seed)
    out = {"meta": np.array(json.dumps(dict(
        lr=LR, steps=STEPS, n_micro=N_MICRO, compute_dtype=COMPUTE_DTYPE,
        runs={t: [list(s), h, pf] for t, (s, h, pf) in POD_TRAIN.items()}, ckpt=POD_CKPT)))}
    for shape in sorted({s for s, _, _ in POD_TRAIN.values()}):
        pre = pod_key(shape) + "/"
        ms = MeshSpec(("pod", "data", "model"), shape)
        gen = torch.Generator().manual_seed(seed)
        for n, spec in sorted(tp_model(ARCH, 1, shape[2]).specs.items()):
            out[f"{pre}S0/params/{n}"] = init_param(gen, spec, ms, "cpu").numpy()
        for k in ("tokens", "labels"):
            out[f"{pre}batch/{k}"] = rng.integers(0, 1024, (B, S)).astype(np.int32)
    return out


def pod_model(shape, groups=(None, None, None, None), hierarchical=False, prefetch=False):
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    group, model_group, pod_group, inner_group = groups
    return Model(configs.get_smoke(ARCH), MeshSpec(("pod", "data", "model"), shape),
                 QSDPConfig(compute_dtype=COMPUTE_DTYPE, hierarchical=hierarchical,
                            prefetch=prefetch),
                 group, model_group, None, pod_group, inner_group)


def _chip_smoke():
    import importlib
    sys.path.insert(0, str(TESTS.parent))
    return importlib.import_module("chip_smoke")


def pod_train_rank(groups, coords, shape, workdir):
    """The runs of POD_TRAIN at this mesh, step A of ``_torch_dist_jax.
    pod_train`` (the initial state, the batch, key index 0) on this rank's
    (FSDP index, model rank) block and its rows of the batch: loss, grad
    norm, new state, the first gathered buffer, the K1/K2 calls (the plain
    versions' calls: the wrappers count launches on a device only) and the
    calls into torch.distributed by op, beside ``chip_smoke.py``'s
    ``expected_train_launches`` and ``expected_train_comm`` for the rank's
    model."""
    import torch
    from repro_torch.core import collectives as coll
    from repro_torch.core import prng
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
    from repro_torch.train.step import TrainState, build_train_step, local_batch
    from repro_torch.weights import params_from_jax

    z = np.load(Path(workdir) / "inputs.npz")
    meta = json.loads(str(z["meta"]))
    cs = _chip_smoke()
    pre = pod_key(shape) + "/"
    p = shape[0] * shape[1]
    out = {}
    for tag, (s, hier, pf) in meta["runs"].items():
        if tuple(s) != tuple(shape):
            continue
        model = pod_model(shape, groups, hier, pf)
        rank, m = model.engine.rank, model.engine.model_rank
        out["fsdp_index"] = np.array(rank)
        opt = make_adamw(AdamWConfig(lr=LR, schedule=cosine_schedule(LR, 2, STEPS)))
        params = params_from_jax({n: z[f"{pre}S0/params/{n}"] for n in model.specs}, "cpu",
                                 model, rank, m)
        st = TrainState(params=params, opt=opt.init(params))
        b = {k: torch.from_numpy(z[f"{pre}batch/{k}"]).long() for k in ("tokens", "labels")}
        step = build_train_step(model, opt, n_micro=N_MICRO[p], device="cpu")
        first, counts = [], {"quantize_pack": 0, "unpack_dequantize": 0}
        saved = {"gather_wire": _capture(coll, "gather_wire", first)}
        for name, kernel in (("quantize_pack", "quantize_pack"),
                             ("unpack_dequantize_wire", "unpack_dequantize"),
                             ("unpack_dequantize", "unpack_dequantize")):
            def counted(*a, _orig=getattr(ops, name), _kernel=kernel, **k):
                counts[_kernel] += 1
                return _orig(*a, **k)
            saved[name] = getattr(ops, name)
            setattr(ops, name, counted)
        coll.reset_comm()
        try:
            st, mt = step(st, local_batch(b, rank, p), prng.fold_in(prng.PRNGKey(1), 0))
        finally:
            coll.gather_wire = saved.pop("gather_wire")
            for name, f in saved.items():
                setattr(ops, name, f)
        want = cs.expected_train_launches(model, N_MICRO[p])
        out[f"{tag}/launches"] = np.array([counts["quantize_pack"], counts["unpack_dequantize"]])
        out[f"{tag}/want_launches"] = np.array([want["quantize_pack"],
                                                want["unpack_dequantize"]])
        out[f"{tag}/comm"] = np.array([coll.COMM[op] for op in coll.COMM_OPS])
        out[f"{tag}/want_comm"] = np.array(
            [cs.expected_train_comm(model, N_MICRO[p])[op] for op in coll.COMM_OPS])
        out[f"{tag}/first_gbuf"] = _np(first[0])
        out[f"{tag}/loss"] = _np(mt["loss"])
        out[f"{tag}/grad_norm"] = _np(mt["grad_norm"])
        out.update(_flat_out(f"{tag}/flat", st))
    return out


def pod_ckpt_rank(groups, coords, shape, workdir):
    """The reference's state after run POD_CKPT (from ``reference.npz``),
    each rank taking its (FSDP index, model rank) block, saved over the
    flat and the model groups (global rank 0 writes) and loaded back block
    by block at (model, fsdp) = (M, Q·D)."""
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint, state_to_flat
    from repro_torch.weights import train_state_from_jax

    group, model_group, _, _ = groups
    ref = np.load(Path(workdir) / "reference.npz")
    model = pod_model(shape, groups, hierarchical=True)
    rank, m = model.engine.rank, model.engine.model_rank
    pre = f"{POD_CKPT}/flat/"
    flat = {k[len(pre):]: ref[k] for k in ref.files if k.startswith(pre)}
    leaves = json.loads(str(ref[f"{POD_CKPT}/leaves"]))
    st = train_state_from_jax(flat, leaves, "cpu", model, rank, m)
    path = str(Path(workdir) / "port_ckpt")
    save_checkpoint(path, st, meta=dict(arch=f"{ARCH}-smoke", steps=1), group=group,
                    model_group=model_group)
    back = load_checkpoint(path, "cpu", mesh_sizes=(shape[2], shape[0] * shape[1]), rank=rank,
                           model_rank=m)
    a, b = state_to_flat(st)[0], state_to_flat(back)[0]
    return {"reloaded_equal": np.array(
        list(a) == list(b) and all(a[k].tobytes() == b[k].tobytes() for k in a))}


if __name__ == "__main__":
    fn, rank, p, m, workdir, tag, store_path, *pod = sys.argv[1:]
    rank, p, m = int(rank), int(p), int(m)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.core.qsdp import MeshSpec
    from repro_torch.launch.mesh import init_distributed
    if pod:
        q = int(pod[0])
        group, model_group, coords, _, pod_group, inner_group = init_distributed(
            "cpu", MeshSpec(("pod", "data", "model"), (q, p, m)),
            store=dist.FileStore(store_path, q * p * m), rank=rank, world_size=q * p * m)
        res = globals()[fn]((group, model_group, pod_group, inner_group), coords, (q, p, m),
                            workdir)
        np.savez(Path(workdir) / f"{tag}_rank{rank}.npz", **res)
        dist.destroy_process_group()
        sys.exit(0)
    group, model_group, (d, mr), _ = init_distributed(
        "cpu", MeshSpec(("data", "model"), (p, m)), store=dist.FileStore(store_path, p * m),
        rank=rank, world_size=p * m)
    if fn.startswith("tp_"):
        res = globals()[fn]((group, model_group), (d, mr), (p, m), workdir)
    else:
        res = globals()[fn](group, d, p, workdir)
    np.savez(Path(workdir) / f"{tag}_rank{rank}.npz", **res)
    dist.destroy_process_group()
