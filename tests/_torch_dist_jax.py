"""The JAX package's side of the port's data-parallel tests
(``tests/test_torch_dist_*.py``), run as a script in a process of its own
so that XLA's host device count is set before JAX is imported:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_dist_jax.py {collectives|train} WORKDIR P [P ...]

It reads ``WORKDIR/inputs.npz`` (made with numpy by the test) and writes
``WORKDIR/reference.npz``: per case an array whose row r is what device r of
the (P,) or (P, 1) mesh returned.  Every output is converted with
``np.asarray`` before it is indexed (JAX 0.9 refuses to index a sharded
array eagerly).
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

import _torch_jax_cache  # noqa: E402,F401  (each program compiles once a run)
from repro.compat import shard_map  # noqa: E402
from repro.core import collectives as coll  # noqa: E402
from repro.core.quant import QuantConfig, quantize  # noqa: E402

KEY = 7          # the collectives' PRNG key
LAYER_KEY = 5    # the coalesced layer's per-segment keys: fold_in(LAYER_KEY, i)


def _mesh(p, axes=("data",)):
    shape = (p,) if len(axes) == 1 else (p, 1)
    return Mesh(np.array(jax.devices()[:p]).reshape(shape), axes)


def _rows(a, p):
    """(P * m, ...) out_specs P("data") output -> (P, m, ...) by device."""
    a = np.asarray(a)
    return a.reshape(p, -1, *a.shape[1:])


def _smap(p, fn, n_in, n_out=1):
    mesh = _mesh(p)
    outs = P("data") if n_out == 1 else (P("data"),) * n_out
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("data"),) * n_in + (P(),),
                             out_specs=outs, check_vma=False))


def _layer_layouts(p):
    """(gather layout, reduce-scatter layout) of one gpt-1.3b smoke layer at
    the (P, 1) mesh, as the engine builds them, and the segment names."""
    from repro import configs
    from repro.core.qsdp import MeshSpec, QSDPConfig
    from repro.models.transformer import Model
    eng = Model(configs.get_smoke("gpt-1.3b"), MeshSpec(("data", "model"), (p, 1)),
                QSDPConfig()).engine
    names = tuple(sorted(n for n in eng.specs if n.startswith("layers/")))
    st = eng._layer_static(names)
    # _LayerStatic.rs_layout(P) asks the mesh for P, which only shard_map
    # binds: at one level its chunks are the shards, n_local each
    rs = coll.WireLayout(tuple(coll.WireSegment(n, st.gcfg if q else None, st.grad_wire_dtype)
                               for n, q in zip(st.n_locals, st.gquant)))
    return st.gather_layout(), rs, names


def collectives(workdir, ps):
    z = dict(np.load(os.path.join(workdir, "inputs.npz")))
    key = jax.random.PRNGKey(KEY)
    out = {}
    for p in ps:
        x = jnp.asarray(z[f"P{p}/x"].reshape(-1))          # rank r: x[r]
        g = jnp.asarray(z[f"P{p}/g"].reshape(-1))          # rank r: g[r]
        ax = ("data",)
        for dt in ("float32", "bfloat16"):
            f = _smap(p, lambda a, k, dt=dt: coll.all_gather_fp(
                a, ax, None if dt == "float32" else jnp.bfloat16), 1)
            out[f"P{p}/fp_gather_{dt}"] = _rows(f(x, key), p)
        for name, cfg in (("w8", QuantConfig(bits=8, mode="shift")),
                          ("w4", QuantConfig(bits=4, mode="shift"))):
            f = _smap(p, lambda a, k, cfg=cfg: coll.all_gather_quantized(
                a, ax, cfg, k, out_dtype=jnp.float32), 1)
            out[f"P{p}/q_gather_{name}"] = _rows(f(x, key), p)

            def parts(a, k, cfg=cfg):
                q = quantize(a, cfg, k)
                return (jax.lax.all_gather(q.codes, ax, tiled=True).reshape(-1),
                        jax.lax.all_gather(q.scale, ax, tiled=True),
                        jax.lax.all_gather(q.zero, ax, tiled=True))
            f = _smap(p, parts, 1, 3)
            for part, v in zip(("codes", "scale", "zero"), f(x, key)):
                out[f"P{p}/q_gather_{name}_{part}"] = _rows(v, p)
        g8 = QuantConfig(bits=8, mode="stochastic")
        f = _smap(p, lambda a, k: coll.reduce_scatter_quantized(a, ax, g8, k), 1)
        out[f"P{p}/q_rs_g8"] = _rows(f(g, key), p)
        f = _smap(p, lambda a, k: coll.reduce_scatter_fp(a, ax, jnp.bfloat16), 1)
        out[f"P{p}/fp_rs_bfloat16"] = _rows(f(g, key), p)

        # the coalesced gather and reduce-scatter of a smoke layer
        lay, rs_lay, names = _layer_layouts(p)
        out[f"P{p}/layer_segments"] = np.array(
            [[s.n, s.cfg is not None, s.cfg.bits if s.cfg else 0] for s in lay.segments])
        out[f"P{p}/layer_rs_segments"] = np.array(
            [[s.n, s.cfg is not None] for s in rs_lay.segments])
        keys = [None if s.cfg is None else jax.random.fold_in(jax.random.PRNGKey(LAYER_KEY), i)
                for i, s in enumerate(lay.segments)]
        rkeys = [None if s.cfg is None else jax.random.fold_in(jax.random.PRNGKey(LAYER_KEY), i)
                 for i, s in enumerate(rs_lay.segments)]
        xs = [jnp.asarray(z[f"P{p}/layer_x{i}"].reshape(-1)) for i in range(len(names))]
        gs = [jnp.asarray(z[f"P{p}/layer_g{i}"].reshape(-1)) for i in range(len(names))]
        out_dts = [jnp.bfloat16 if s.cfg is not None else jnp.float32 for s in lay.segments]
        mesh = _mesh(p)
        n = len(names)

        def gather(*xs_):
            buf = coll.gather_wire(coll.encode_wire(xs_, lay, keys), ax)
            return (buf, *coll.decode_gathered_wire(buf, lay, p, out_dts))
        f = jax.jit(shard_map(gather, mesh=mesh, in_specs=(P("data"),) * n,
                              out_specs=(P("data"),) * (n + 1), check_vma=False))
        res = f(*xs)
        out[f"P{p}/layer_gbuf"] = _rows(res[0], p)
        for i, v in enumerate(res[1:]):
            out[f"P{p}/layer_gather{i}"] = _rows(np.asarray(v.astype(jnp.float32)), p)

        def rs(*gs_):
            return tuple(coll.reduce_scatter_coalesced(gs_, ax, rs_lay, rkeys))
        f = jax.jit(shard_map(rs, mesh=mesh, in_specs=(P("data"),) * n,
                              out_specs=(P("data"),) * n, check_vma=False))
        for i, v in enumerate(f(*gs)):
            out[f"P{p}/layer_rs{i}"] = _rows(v, p)
    np.savez(os.path.join(workdir, "reference.npz"), **out)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def train(workdir, ps):
    """Per P: the gpt-1.3b smoke config's step on the (P, 1) mesh with
    ``batch_pspec P("data")`` from the test's states: A (the initial state,
    batch 0, key index 0), B (a later state, batch 1, key index 1) and Q
    (the initial state quantized, quantized_state, batch 0); at P = 2 the
    states after A and after Q are saved as v2 checkpoints and kept in
    their flat form."""
    from repro import configs
    from repro.core.qsdp import MeshSpec, QSDPConfig
    from repro.models.transformer import Model
    from repro.optim import AdamWConfig, OptState, cosine_schedule, make_adamw
    from repro.train.checkpoint import _flatten, save_checkpoint
    from repro.train.step import (TrainState, make_jitted_train_step, quantize_train_state,
                                  state_pspecs)

    z = dict(np.load(os.path.join(workdir, "inputs.npz")))
    meta = json.loads(str(z["meta"]))
    out = {}
    for p in ps:
        mesh = _mesh(p, ("data", "model"))
        model = Model(configs.get_smoke("gpt-1.3b"), MeshSpec(("data", "model"), (p, 1)),
                      QSDPConfig(compute_dtype=meta["compute_dtype"]))
        sched = cosine_schedule(meta["lr"], 2, meta["steps"])
        opt = make_adamw(AdamWConfig(lr=meta["lr"], schedule=sched))
        opt8 = make_adamw(AdamWConfig(lr=meta["lr"], schedule=sched, moment_bits=8))
        names = sorted(model.specs)

        def state(tag, o=opt):
            params = {n: jnp.asarray(z[f"P{p}/{tag}/params/{n}"]) for n in names}
            if tag == "S0":
                return TrainState(params=params, opt=o.init(params))
            mom = {k: {n: jnp.asarray(z[f"P{p}/{tag}/{k}/{n}"]) for n in names}
                   for k in ("mu", "nu")}
            return TrainState(params=params, opt=OptState(
                step=jnp.asarray(int(z[f"P{p}/{tag}/step"]), jnp.int32), **mom))

        def place(st, qstate=False, o=opt):
            specs = state_pspecs(model, quantized_state=qstate,
                                 quantized_moments=getattr(o, "quantized_moments", False))
            return jax.device_put(st, jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                                   is_leaf=lambda x: isinstance(x, P)))

        batch = {i: {k: jnp.asarray(z[f"P{p}/batch{i}/{k}"]) for k in ("tokens", "labels")}
                 for i in (0, 1)}
        bspec = {k: P("data") for k in ("tokens", "labels")}
        runs = {"A": ("S0", 0, False, opt), "B": ("S1", 1, False, opt),
                "Q": ("S0", 0, True, opt8)}
        for tag, (src, i, qstate, o) in runs.items():
            st = state(src, o)
            if qstate:
                st = quantize_train_state(st, model, jax.random.PRNGKey(2))
            step = make_jitted_train_step(model, o, mesh, n_micro=meta["n_micro"][str(p)],
                                          batch_pspec=bspec, donate=False,
                                          quantized_state=qstate)
            with mesh:
                new, m = step(place(st, qstate, o), batch[i],
                              jax.random.fold_in(jax.random.PRNGKey(1), i))
            out[f"P{p}/{tag}/loss"] = np.asarray(m["loss"])
            out[f"P{p}/{tag}/grad_norm"] = np.asarray(m["grad_norm"])
            flat, leaves = _flatten(new)
            for k, v in flat.items():
                out[f"P{p}/{tag}/flat/{k}"] = np.asarray(v)
            out[f"P{p}/{tag}/leaves"] = np.array(json.dumps(leaves))
            if qstate:  # the state the step started from, in its flat form
                for k, v in _flatten(st)[0].items():
                    out[f"P{p}/{tag}/start/{k}"] = np.asarray(v)
            if tag == "A":  # the step's first gathered buffer: the embedding's
                from repro.core.qsdp import _stable_hash
                lay = model.engine._layer_static(("embed",)).gather_layout()
                ekey = jax.random.fold_in(jax.random.fold_in(
                    jax.random.fold_in(jax.random.PRNGKey(1), 0), 0), _stable_hash("embed"))
                f = jax.jit(shard_map(
                    lambda e: coll.gather_wire(coll.encode_wire([e.reshape(-1)], lay, [ekey]),
                                               ("data",)),
                    mesh=mesh, in_specs=(P("model", "data", None),), out_specs=P("data"),
                    check_vma=False))
                out[f"P{p}/A/first_gbuf"] = _rows(f(st.params["embed"]), p)
            if p == 2 and tag in ("A", "Q"):
                save_checkpoint(os.path.join(workdir, f"ref_ckpt_{tag}"), new,
                                meta=dict(arch="gpt-1.3b-smoke", steps=1))
    np.savez(os.path.join(workdir, "reference.npz"), **out)


if __name__ == "__main__":
    what, workdir, *ps = sys.argv[1:]
    {"collectives": collectives, "train": train}[what](workdir, [int(p) for p in ps])
