"""Shared set-up of the port's data-parallel tests (``test_torch_dist_*.py``);
imports no JAX.

The port's ranks are fresh interpreters (never forks of the pytest worker,
which has imported JAX), one per rank, started by :func:`run_ranks`: each
runs this file as a script, forms a gloo group of P ranks that meets
through a ``FileStore`` in the test's temporary directory (no ports to
collide between test workers), runs one of the rank functions below on one
intra-op thread and writes what it returns to ``rank{r}.npz``.  Every wait
has a deadline; a rank that fails or outlives it fails the test with the
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


def run_ranks(fn: str, p: int, workdir, timeout: float = 240.0) -> list[dict]:
    """Run rank function `fn` of this module as ranks 0..p-1 of a gloo group,
    each in its own interpreter; returns each rank's results."""
    workdir = Path(workdir)
    tag = f"{fn}_P{p}"
    store = workdir / f"store_{tag}"
    procs, logs = [], []
    for r in range(p):
        log = workdir / f"{tag}_rank{r}.err"
        logs.append(log)
        with open(log, "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, fn, str(r), str(p), str(workdir), str(store)],
                stdout=subprocess.DEVNULL, stderr=err, env=_env()))
    _wait(procs, logs, time.time() + timeout, f"{tag} rank")
    return [dict(np.load(workdir / f"{tag}_rank{r}.npz")) for r in range(p)]


def start_reference(what: str, workdir, ps, devices: int = 4):
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


def train_models(p, group=None):
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    from repro_torch.optim import AdamWConfig, cosine_schedule, make_adamw
    model = Model(configs.get_smoke(ARCH), MeshSpec(("data", "model"), (p, 1)),
                  QSDPConfig(compute_dtype=COMPUTE_DTYPE), group)
    opts = [make_adamw(AdamWConfig(lr=LR, schedule=cosine_schedule(LR, 2, STEPS),
                                   moment_bits=mb)) for mb in (None, 8)]
    return model, opts


def _flat_out(prefix, state):
    from repro_torch.train.checkpoint import state_to_flat
    flat, _ = state_to_flat(state)
    # copies: a CPU tensor's numpy view would follow the next in-place update
    return {f"{prefix}/{k}": np.array(v) for k, v in flat.items()}


def train_rank(group, rank, p, workdir):
    """The three steps of ``_torch_dist_jax.train`` on this rank's block of
    the states and its rows of the batches: A and B f32 state, Q
    quantized_state; the wire traffic of A by op, and A's first gathered
    buffer (the embedding's)."""
    import torch
    from repro_torch.core import collectives as coll
    from repro_torch.core import prng
    from repro_torch.train.step import (TrainState, build_train_step, local_batch,
                                        quantize_train_state)
    from repro_torch.weights import params_from_jax, train_state_from_jax

    z = np.load(Path(workdir) / "inputs.npz")
    model, (opt, opt8) = train_models(p, group)
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

    def capture(buf, grp=None):
        res = orig(buf, grp)
        if not first:
            first.append(_np(res))
        return res

    for tag, (src, i, qstate, o) in {"A": ("S0", 0, False, opt), "B": ("S1", 1, False, opt),
                                     "Q": ("S0", 0, True, opt8)}.items():
        st = start(src, o)
        if qstate:
            st = quantize_train_state(st, model, prng.PRNGKey(2))
            out.update(_flat_out(f"{tag}/start", st))
        step = build_train_step(model, o, n_micro=N_MICRO[p], quantized_state=qstate,
                                device="cpu")
        coll.reset_comm()
        coll.gather_wire = capture if tag == "A" else orig
        try:
            st, m = step(st, batch(i), prng.fold_in(prng.PRNGKey(1), i))
        finally:
            coll.gather_wire = orig
        if tag == "A":
            out["A/first_gbuf"] = first[0]
            out.update(_step_accounting(model, group))
            for op in coll.COMM_OPS:
                out[f"A/comm/{op}"] = np.array([coll.COMM[op], coll.COMM_BYTES[op]])
        out[f"{tag}/loss"] = _np(m["loss"])
        out[f"{tag}/grad_norm"] = _np(m["grad_norm"])
        out.update(_flat_out(f"{tag}/flat", st))
    return out


def _step_accounting(model, group) -> dict:
    """What one microbatch of a step moves by the analytic model: the
    stacked params gathered twice and the top-level ones once
    (``step_comm_bytes`` of an engine over each set), every one
    reduce-scattered once."""
    from repro_torch.core.qsdp import QSDPEngine, step_comm_bytes
    specs = model.specs
    stacked = {n: s for n, s in specs.items() if s.stack is not None}
    top = {n: s for n, s in specs.items() if s.stack is None}
    eng_l, eng_t = (QSDPEngine(model.ms, model.qcfg, sp, group) for sp in (stacked, top))
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


if __name__ == "__main__":
    fn, rank, p, workdir, store_path = sys.argv[1:]
    rank, p = int(rank), int(p)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed
    group, rank, _ = init_distributed("cpu", store=dist.FileStore(store_path, p), rank=rank,
                                      world_size=p)
    res = globals()[fn](group, rank, p, workdir)
    np.savez(Path(workdir) / f"{fn}_P{p}_rank{rank}.npz", **res)
    dist.destroy_process_group()
