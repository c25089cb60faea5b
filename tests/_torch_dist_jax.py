"""The JAX package's side of the port's multi-rank tests
(``tests/test_torch_dist_*.py``, ``tests/test_torch_tp_*.py``), run as a
script in a process of its own so that XLA's host device count is set
before JAX is imported:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_dist_jax.py {collectives|train} WORKDIR P [P ...]
    ... python tests/_torch_dist_jax.py {tp_blocks|tp_train|reshard} WORKDIR PxM [PxM ...]
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_torch_dist_jax.py {pod_collectives|pod_train} WORKDIR QxDxM [...]

It reads ``WORKDIR/inputs.npz`` (made with numpy by the test) and writes
``WORKDIR/reference.npz``: per case an array whose row r is what device r of
the (P,), (P, 1) or (P, M) mesh returned (device ``d·M + m`` at data rank d
and model rank m; on a (Q, D, M) ("pod", "data", "model") mesh device
``q·D·M + d·M + m``).  Every output is converted with ``np.asarray`` before it
is indexed (JAX 0.9 refuses to index a sharded array eagerly).
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
    batch 0, key index 0), B (a later state, batch 1, key index 1), Q
    (the initial state quantized, quantized_state, batch 0) and P (step A
    under ``QSDPConfig(prefetch=True)``); at P = 2 the
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
        model_pf = Model(configs.get_smoke("gpt-1.3b"), MeshSpec(("data", "model"), (p, 1)),
                         QSDPConfig(compute_dtype=meta["compute_dtype"], prefetch=True))
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
                "Q": ("S0", 0, True, opt8), "P": ("S0", 0, False, opt)}
        for tag, (src, i, qstate, o) in runs.items():
            st = state(src, o)
            if qstate:
                st = quantize_train_state(st, model, jax.random.PRNGKey(2))
            step = make_jitted_train_step(model_pf if tag == "P" else model, o, mesh,
                                          n_micro=meta["n_micro"][str(p)],
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


# ---------------------------------------------------------------------------
# the (P, M) mode: tensor parallelism on the model axis
# ---------------------------------------------------------------------------


def _grid(p, m):
    return Mesh(np.array(jax.devices()[:p * m]).reshape(p, m), ("data", "model"))


def _per_device(p, m, fn, in_specs, n_out):
    """jit(shard_map(fn)) over the (P, M) mesh whose `n_out` outputs are
    each device's own value: fn's outputs get a leading axis of 1, laid
    out by device (row d·M + m)."""
    def body(*a):
        return tuple(o[None] for o in fn(*a))
    return jax.jit(shard_map(body, mesh=_grid(p, m), in_specs=in_specs,
                             out_specs=(P(("data", "model")),) * n_out, check_vma=False))


def tp_blocks(workdir, meshes):
    """Per (1, M) mesh: (a) tp_copy and tp_reduce forward and backward; (b)
    embed_vocab_parallel with its vjp, and vocab_parallel_xent's loss, dh
    and dw; (c) one dense layer of each arch's smoke config, its output and
    its vjp (dx and every TP-local weight's gradient), f32 compute.  Each
    model rank's inputs are row m of a (M, ...) array (sharded P("model"))
    or replicated."""
    from repro import configs
    from repro.core.qsdp import MeshSpec, QSDPConfig
    from repro.core.tp import tp_copy, tp_reduce
    from repro.models import layers as L
    from repro.models.transformer import Model

    z = dict(np.load(os.path.join(workdir, "inputs.npz")))
    meta = json.loads(str(z["meta"]))
    out = {}
    rep, sh = P(), P("model")
    for p, m in meshes:
        pre = f"{p}x{m}/"
        g = {k[len(pre):]: jnp.asarray(v) for k, v in z.items() if k.startswith(pre)}

        def ops_(xl, xr, ctc, ctr):
            y_r, f_r = jax.vjp(tp_reduce, xl[0])
            y_c, f_c = jax.vjp(tp_copy, xr)
            return y_r, f_r(ctr)[0], y_c, f_c(ctc[0])[0]
        f = _per_device(p, m, ops_, (sh, rep, sh, rep), 4)
        for k, v in zip(("reduce", "reduce_dx", "copy", "copy_dx"),
                        f(g["tp/xl"], g["tp/xr"], g["tp/ctc"], g["tp/ctr"])):
            out[f"{pre}tp/{k}"] = np.asarray(v)

        def xent(tokens, emb, cte, h, w, labels):
            e, f_e = jax.vjp(lambda a: L.embed_vocab_parallel(tokens, a), emb[0])
            loss, f_x = jax.vjp(lambda a, b: L.vocab_parallel_xent(a, b, labels), h, w[0])
            dh, dw = f_x(jnp.ones((), jnp.float32))
            return e, f_e(cte)[0], loss, dh, dw
        f = _per_device(p, m, xent, (rep, sh, rep, rep, sh, rep), 5)
        for k, v in zip(("embed", "embed_dw", "loss", "dh", "dw"),
                        f(*(g[f"xent/{k}"] for k in ("tokens", "emb", "cte", "h", "w",
                                                     "labels")))):
            out[f"{pre}xent/{k}"] = np.asarray(v)

        for arch in meta["archs"]:
            model = Model(configs.get_smoke(arch), MeshSpec(("data", "model"), (p, m)),
                          QSDPConfig(compute_dtype="float32"))
            names = sorted(k[len(f"layer/{arch}/w/"):] for k in g
                           if k.startswith(f"layer/{arch}/w/"))
            cfg = model.cfg

            def layer(x, ct, *ws, model=model, names=names, cfg=cfg):
                s_ = x.shape[1]
                pos = jnp.arange(s_)
                cos, sin = L.rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
                y, f_l = jax.vjp(lambda x_, *w_: model._dense_layer(
                    x_, dict(zip(names, w_)), cos, sin, pos), x, *(w[0] for w in ws))
                return (y, *f_l(ct))
            f = _per_device(p, m, layer, (rep, rep) + (sh,) * len(names), 2 + len(names))
            res = f(g[f"layer/{arch}/x"], g[f"layer/{arch}/ct"],
                    *(g[f"layer/{arch}/w/{n}"] for n in names))
            for k, v in zip(("y", "dx", *(f"dw/{n}" for n in names)), res):
                out[f"{pre}layer/{arch}/{k}"] = np.asarray(v)
    np.savez(os.path.join(workdir, "reference.npz"), **out)


def tp_train(workdir, meshes):
    """Per (P, M) mesh and arch of ``meta["runs"]``: the smoke config's step
    on the (P, M) mesh with ``batch_pspec P("data")`` from the test's whole
    states, as ``train`` runs it on the (P, 1) mesh: runs A (the initial
    state, batch 0), B (a later state, batch 1), Q (quantized_state, 8-bit
    moments) and U (Q's update alone: its start state decoded to f32, 8-bit
    moments, no re-encoding) and, at the meshes of ``meta["prefetch"]``,
    P (run A under ``QSDPConfig(prefetch=True)``); run A's first gathered
    buffer by device; at
    the (2, 2) mesh the states after A and Q of ``meta["ckpt_arch"]`` saved
    as v2 checkpoints."""
    from repro import configs
    from repro.core.qsdp import MeshSpec, QSDPConfig, _stable_hash
    from repro.models.transformer import Model
    from repro.optim import AdamWConfig, OptState, cosine_schedule, make_adamw
    from repro.train.checkpoint import _flatten, save_checkpoint
    from repro.train.step import (TrainState, dequantize_train_state, make_jitted_train_step,
                                  quantize_train_state, state_pspecs)

    z = dict(np.load(os.path.join(workdir, "inputs.npz")))
    meta = json.loads(str(z["meta"]))
    out = {}
    for arch, runs in meta["runs"].items():
        for p, m in meshes:
            if [p, m] not in meta["meshes"][arch]:
                continue
            pre = f"{arch}/{p}x{m}/"
            mesh = _grid(p, m)
            model = Model(configs.get_smoke(arch), MeshSpec(("data", "model"), (p, m)),
                          QSDPConfig(compute_dtype=meta["compute_dtype"]))
            model_pf = Model(configs.get_smoke(arch), MeshSpec(("data", "model"), (p, m)),
                             QSDPConfig(compute_dtype=meta["compute_dtype"], prefetch=True))
            tags = runs
            if arch == meta["ckpt_arch"] and [p, m] in meta["prefetch"]:
                tags = [*runs, "P"]
            sched = cosine_schedule(meta["lr"], 2, meta["steps"])
            opt = make_adamw(AdamWConfig(lr=meta["lr"], schedule=sched))
            opt8 = make_adamw(AdamWConfig(lr=meta["lr"], schedule=sched, moment_bits=8))
            names = sorted(model.specs)

            def state(tag, o, pre=pre, names=names):
                params = {n: jnp.asarray(z[f"{pre}{tag}/params/{n}"]) for n in names}
                if tag == "S0":
                    return TrainState(params=params, opt=o.init(params))
                mom = {k: {n: jnp.asarray(z[f"{pre}{tag}/{k}/{n}"]) for n in names}
                       for k in ("mu", "nu")}
                return TrainState(params=params, opt=OptState(
                    step=jnp.asarray(int(z[f"{pre}{tag}/step"]), jnp.int32), **mom))

            def place(st, qstate, o, mesh=mesh, model=model):
                specs = state_pspecs(model, quantized_state=qstate,
                                     quantized_moments=getattr(o, "quantized_moments", False))
                return jax.device_put(st, jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                                       is_leaf=lambda x: isinstance(x, P)))

            batch = {i: {k: jnp.asarray(z[f"{pre}batch{i}/{k}"]) for k in ("tokens", "labels")}
                     for i in (0, 1)}
            bspec = {k: P("data") for k in ("tokens", "labels")}
            steps = {}
            for tag in tags:
                src, i, qstate, o = {"A": ("S0", 0, False, opt), "B": ("S1", 1, False, opt),
                                     "Q": ("S0", 0, True, opt8), "U": ("S0", 0, False, opt8),
                                     "P": ("S0", 0, False, opt)}[tag]
                st = state(src, o)
                if tag in ("Q", "U"):
                    st = quantize_train_state(st, model, jax.random.PRNGKey(2))
                if tag == "U":
                    st = TrainState(params=dequantize_train_state(st).params, opt=st.opt)
                sk = (qstate, o is opt8, tag == "P")
                if sk not in steps:
                    steps[sk] = make_jitted_train_step(
                        model_pf if tag == "P" else model, o, mesh,
                        n_micro=meta["n_micro"][str(p)], batch_pspec=bspec, donate=False,
                        quantized_state=qstate)
                with mesh:
                    new, mt = steps[sk](
                        place(st, qstate, o), batch[i],
                        jax.random.fold_in(jax.random.PRNGKey(1), i))
                out[f"{pre}{tag}/loss"] = np.asarray(mt["loss"])
                out[f"{pre}{tag}/grad_norm"] = np.asarray(mt["grad_norm"])
                flat, leaves = _flatten(new)
                for k, v in flat.items():
                    out[f"{pre}{tag}/flat/{k}"] = np.asarray(v)
                out[f"{pre}{tag}/leaves"] = np.array(json.dumps(leaves))
                if qstate:
                    for k, v in _flatten(st)[0].items():
                        out[f"{pre}{tag}/start/{k}"] = np.asarray(v)
                if tag == "A":  # the first gathered buffer, each device's
                    lay = model.engine._layer_static(("embed",)).gather_layout()
                    ekey = jax.random.fold_in(jax.random.fold_in(
                        jax.random.fold_in(jax.random.PRNGKey(1), 0), 0), _stable_hash("embed"))
                    f = _per_device(p, m, lambda e, lay=lay, ekey=ekey: (coll.gather_wire(
                        coll.encode_wire([e.reshape(-1)], lay, [ekey]), ("data",)),),
                        (P("model", "data", None),), 1)
                    out[f"{pre}A/first_gbuf"] = np.asarray(f(st.params["embed"])[0])
                if (p, m) == (2, 2) and arch == meta["ckpt_arch"] and tag in ("A", "Q"):
                    save_checkpoint(os.path.join(workdir, f"ref_ckpt_{tag}"), new,
                                    meta=dict(arch=f"{arch}-smoke", steps=1))
    np.savez(os.path.join(workdir, "reference.npz"), **out)


def reshard(workdir, meshes):
    """Checkpoint resharding: per (P, M) layout of `meshes`, the smoke
    config's state saved at that layout as ``ckpt_{P}x{M}_{kind}`` (kind
    "f32": f32 params and moments; "q8": quantized_state params and 8-bit
    moments), the params and moments drawn from the seeds in
    ``inputs.npz``; then every file loaded at every other layout of
    `meshes` by the reference's ``load_checkpoint`` (``model=`` the target
    model, ``dequantize=True`` for "q8"): each loaded leaf as a whole
    rest-layout array, ``{src}/{tgt}/{kind}/{key}``."""
    from repro import configs
    from repro.core.qsdp import MeshSpec, QSDPConfig, to_rest
    from repro.core.quant import QuantConfig as JQC, qparam_encode
    from repro.models.transformer import Model
    from repro.optim import OptState
    from repro.train.checkpoint import _flatten, load_checkpoint, save_checkpoint
    from repro.train.step import TrainState, quantize_train_state, state_pspecs

    z = dict(np.load(os.path.join(workdir, "inputs.npz")))
    meta = json.loads(str(z["meta"]))
    mq = JQC(bits=8, bucket_size=meta["moment_bucket"], mode="nearest")

    def model(p, m):
        return Model(configs.get_smoke(meta["arch"]), MeshSpec(("data", "model"), (p, m)),
                     QSDPConfig())

    out = {}
    for p, m in meshes:
        mdl = model(p, m)
        names = sorted(mdl.specs)

        def rest(kind, n, mdl=mdl):
            return to_rest(jnp.asarray(z[f"{kind}/{n}"]), mdl.specs[n], mdl.ms)

        params = {n: rest("params", n) for n in names}
        mom = {k: {n: rest(k, n) for n in names} for k in ("mu", "nu")}
        st = TrainState(params=params, opt=OptState(step=jnp.asarray(3, jnp.int32), **mom))
        save_checkpoint(os.path.join(workdir, f"ckpt_{p}x{m}_f32"), st)
        qmom = {k: {n: qparam_encode(v, mq) for n, v in d.items()} for k, d in mom.items()}
        qst = quantize_train_state(TrainState(params=params, opt=OptState(
            step=st.opt.step, **qmom)), mdl, jax.random.PRNGKey(2))
        save_checkpoint(os.path.join(workdir, f"ckpt_{p}x{m}_q8"), qst)
    for sp, sm in meshes:
        for tp_, tm in meshes:
            if (sp, sm) == (tp_, tm):
                continue
            tgt = model(tp_, tm)
            for kind in ("f32", "q8"):
                got = load_checkpoint(os.path.join(workdir, f"ckpt_{sp}x{sm}_{kind}"),
                                      _grid(tp_, tm), state_pspecs(tgt), model=tgt,
                                      dequantize=kind == "q8")
                for k, v in _flatten(got)[0].items():
                    out[f"{sp}x{sm}/{tp_}x{tm}/{kind}/{k}"] = np.asarray(v)
    np.savez(os.path.join(workdir, "reference.npz"), **out)


# ---------------------------------------------------------------------------
# the (Q, D, M) mode: the pod axis and the two-level exchanges
# ---------------------------------------------------------------------------

POD_AXES = ("pod", "data", "model")


def _pod_mesh(shape):
    q, d, m = shape
    return Mesh(np.array(jax.devices()[:q * d * m]).reshape(q, d, m), POD_AXES)


def _pod_per_device(shape, fn, n_in, in_specs=None):
    """jit(shard_map(fn)) over the (Q, D, M) mesh whose inputs are per-device
    rows (row r: device r = q·D·M + d·M + m; unless `in_specs`) and whose
    outputs (a tuple or dict) are each device's own values, row r of each
    result."""
    every = P(POD_AXES)

    def body(*a):
        a = a if in_specs is not None else tuple(x[0] for x in a)
        return jax.tree.map(lambda o: o[None], fn(*a))
    return jax.jit(shard_map(body, mesh=_pod_mesh(shape), in_specs=in_specs or (every,) * n_in,
                             out_specs=every, check_vma=False))


def _pod_layouts(shape):
    """The smoke layer's (names, gather layout, flat reduce-scatter layout
    (the pod level's too), inner level's) on the pod mesh, as the engine's
    ``_LayerStatic`` builds them (``rs_layout(chunk_div)`` asks shard_map
    for the FSDP size, so they are built here from its fields)."""
    from repro import configs
    from repro.core.qsdp import MeshSpec, QSDPConfig
    from repro.models.transformer import Model
    q = shape[0]
    eng = Model(configs.get_smoke("gpt-1.3b"), MeshSpec(POD_AXES, shape), QSDPConfig()).engine
    names = tuple(sorted(n for n in eng.specs if n.startswith("layers/")))
    st = eng._layer_static(names)

    def rs(mult):
        return coll.WireLayout(tuple(
            coll.WireSegment(n * mult, st.gcfg if g else None, st.grad_wire_dtype)
            for n, g in zip(st.n_locals, st.gquant)))
    return names, st.gather_layout(), rs(1), rs(q)


def _a2a_rows(gs, axes, layout, keys):
    """The (p, layout.nbytes) rows a device receives in
    ``reduce_scatter_coalesced`` over `axes` (its body up to the
    all_to_all)."""
    from repro.core.quant import fp_pack, wire_pack
    p = coll._axis_size(axes)
    rows = []
    for g, seg, key in zip(gs, layout.segments, keys):
        chunks = g.reshape(p, seg.n)
        if seg.cfg is None:
            rows.append(jax.vmap(lambda c, seg=seg: fp_pack(c, seg.fp_dtype))(chunks))
        else:
            qs = jax.vmap(lambda c, k, seg=seg: quantize(c, seg.cfg, k))(
                chunks, jax.random.split(key, p))
            rows.append(jax.vmap(wire_pack)(qs))
    return jax.lax.all_to_all(jnp.concatenate(rows, axis=1), axes, 0, 0, tiled=True)


def _q_rows(g, axes, cfg, key):
    """What a device receives in ``reduce_scatter_quantized`` over `axes`:
    the codes, scale and zero rows."""
    p = coll._axis_size(axes)
    q = jax.vmap(lambda c, k: quantize(c, cfg, k))(g.reshape(p, -1), jax.random.split(key, p))
    return tuple(jax.lax.all_to_all(t, axes, 0, 0, tiled=True)
                 for t in (q.codes, q.scale, q.zero))


def pod_collectives(workdir, meshes):
    """Per (Q, D, M) mesh, every device's row of the inputs, in one program:
    the flat forms over ("data", "pod"); ``all_gather_hierarchical`` and
    ``reduce_scatter_hierarchical`` with what each level delivered; the
    smoke layer's coalesced gathers (flat, the pod level alone, two-level)
    and reduce-scatters (flat, ``reduce_scatter_coalesced_hierarchical``,
    and its two levels step by step)."""
    z = dict(np.load(os.path.join(workdir, "inputs.npz")))
    key = jax.random.PRNGKey(KEY)
    w8, g8 = QuantConfig(bits=8, mode="shift"), QuantConfig(bits=8, mode="stochastic")
    fsdp, inner = ("data", "pod"), ("data",)
    out = {}
    for shape in meshes:
        pre = "x".join(map(str, shape)) + "/"
        names, lay, rs, rs_inner = _pod_layouts(shape)
        n = len(names)
        keys = [None if s.cfg is None else jax.random.fold_in(jax.random.PRNGKey(LAYER_KEY), i)
                for i, s in enumerate(lay.segments)]
        rkeys = [None if s.cfg is None else jax.random.fold_in(jax.random.PRNGKey(LAYER_KEY), i)
                 for i, s in enumerate(rs.segments)]
        out_dts = [jnp.bfloat16 if s.cfg is not None else jnp.float32 for s in lay.segments]
        out[pre + "layer_segments"] = np.array([[s.n, s.cfg is not None] for s in lay.segments])
        out[pre + "layer_rs_segments"] = np.array([[s.n, s.cfg is not None]
                                                   for s in rs.segments])
        def prog(x, g, *layer):
            xs, gs = layer[:n], layer[n:]
            res = {}
            res["flat/fp_gather"] = coll.all_gather_fp(x, fsdp)
            res["flat/q_gather_w8"] = coll.all_gather_quantized(x, fsdp, w8, key,
                                                                out_dtype=jnp.float32)
            res["flat/q_rs_g8"] = coll.reduce_scatter_quantized(g, fsdp, g8, key)
            res["flat/fp_rs_bfloat16"] = coll.reduce_scatter_fp(g, fsdp, jnp.bfloat16)
            res["hier/q_gather_w8"] = coll.all_gather_hierarchical(
                x, "pod", inner, w8, key, out_dtype=jnp.float32)
            qx = quantize(x, w8, key)
            parts = (qx.codes, qx.scale, qx.zero)
            for lvl, axes in (("pod", "pod"), ("inner", inner)):
                parts = tuple(jax.lax.all_gather(t, axes, tiled=True) for t in parts)
                for part, t in zip(("codes", "scale", "zero"), parts):
                    res[f"hier/gather_{lvl}_{part}"] = t
            res["hier/q_rs_g8"] = coll.reduce_scatter_hierarchical(g, "pod", inner, g8, key)
            k1, k2 = jax.random.split(key)
            part_sum = coll.reduce_scatter_quantized(g, inner, g8, k1)
            res["hier/rs_inner_sum"] = part_sum
            for lvl, axes, v, k in (("inner", inner, g, k1), ("pod", ("pod",), part_sum, k2)):
                for part, t in zip(("codes", "scale", "zero"), _q_rows(v, axes, g8, k)):
                    res[f"hier/rs_{lvl}_{part}"] = t
            buf = coll.encode_wire(xs, lay, keys)
            res["layer/flat_gbuf"] = coll.gather_wire(buf, fsdp)
            res["layer/pod_gbuf"] = coll.gather_wire(buf, ("pod",))
            res["layer/hier_gbuf"] = coll.gather_wire(buf, fsdp, pod_axis="pod")
            for i, v in enumerate(coll.all_gather_coalesced(xs, fsdp, lay, keys, out_dts,
                                                            pod_axis="pod")):
                res[f"layer/hier_gather{i}"] = v.astype(jnp.float32)
            for i, v in enumerate(coll.reduce_scatter_coalesced(gs, fsdp, rs, rkeys)):
                res[f"layer/flat_rs{i}"] = v
            for i, v in enumerate(coll.reduce_scatter_coalesced_hierarchical(
                    gs, "pod", inner, rs_inner, rs, rkeys)):
                res[f"layer/hier_rs{i}"] = v
            k1s = [None if k is None else jax.random.split(k)[0] for k in rkeys]
            k2s = [None if k is None else jax.random.split(k)[1] for k in rkeys]
            inner_rows = _a2a_rows(gs, inner, rs_inner, k1s)
            sums = [jnp.sum(v, axis=0) for v in coll._decode_segments(inner_rows, rs_inner)]
            res["layer/inner_rows"] = inner_rows
            res["layer/pod_rows"] = _a2a_rows(sums, ("pod",), rs, k2s)
            for i, v in enumerate(sums):
                res[f"layer/inner_sum{i}"] = v
            return res

        args = [z[pre + "x"], z[pre + "g"]] + [z[f"{pre}layer_x{i}"] for i in range(n)] + \
            [z[f"{pre}layer_g{i}"] for i in range(n)]
        for k, v in _pod_per_device(shape, prog, len(args))(*args).items():
            out[pre + k] = np.asarray(v)
    np.savez(os.path.join(workdir, "reference.npz"), **out)


def pod_train(workdir, meshes):
    """The runs of ``meta["runs"]`` (tag: mesh, hierarchical, prefetch) at
    the meshes given: the smoke config's step on the (Q, D, M) mesh with
    ``batch_pspec P(("data", "pod"))`` from the test's initial state and
    batch, key index 0; the first gathered buffer (the embedding's, two
    levels under hierarchical) by device; the state after run
    ``meta["ckpt"]`` saved as a v2 checkpoint and kept in its flat form."""
    from repro import configs
    from repro.core.qsdp import MeshSpec, QSDPConfig, _stable_hash
    from repro.models.transformer import Model
    from repro.optim import AdamWConfig, cosine_schedule, make_adamw
    from repro.train.checkpoint import _flatten, save_checkpoint
    from repro.train.step import TrainState, make_jitted_train_step, state_pspecs

    z = dict(np.load(os.path.join(workdir, "inputs.npz")))
    meta = json.loads(str(z["meta"]))
    out = {}
    for tag, (shape, hier, pf) in meta["runs"].items():
        shape = tuple(shape)
        if shape not in meshes:
            continue
        pre = "x".join(map(str, shape)) + "/"
        mesh = _pod_mesh(shape)
        model = Model(configs.get_smoke("gpt-1.3b"), MeshSpec(POD_AXES, shape),
                      QSDPConfig(compute_dtype=meta["compute_dtype"], hierarchical=hier,
                                 prefetch=pf))
        opt = make_adamw(AdamWConfig(lr=meta["lr"],
                                     schedule=cosine_schedule(meta["lr"], 2, meta["steps"])))
        names = sorted(model.specs)
        params = {n: jnp.asarray(z[f"{pre}S0/params/{n}"]) for n in names}
        st = TrainState(params=params, opt=opt.init(params))
        specs = state_pspecs(model)
        st = jax.device_put(st, jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                             is_leaf=lambda x: isinstance(x, P)))
        batch = {k: jnp.asarray(z[f"{pre}batch/{k}"]) for k in ("tokens", "labels")}
        bspec = {k: P(("data", "pod")) for k in ("tokens", "labels")}
        p = shape[0] * shape[1]
        step = make_jitted_train_step(model, opt, mesh, n_micro=meta["n_micro"][str(p)],
                                      batch_pspec=bspec, donate=False)
        with mesh:
            new, mt = step(st, batch, jax.random.fold_in(jax.random.PRNGKey(1), 0))
        out[f"{tag}/loss"] = np.asarray(mt["loss"])
        out[f"{tag}/grad_norm"] = np.asarray(mt["grad_norm"])
        flat, leaves = _flatten(new)
        for k, v in flat.items():
            out[f"{tag}/flat/{k}"] = np.asarray(v)
        out[f"{tag}/leaves"] = np.array(json.dumps(leaves))
        lay = model.engine._layer_static(("embed",)).gather_layout()
        ekey = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(1), 0), 0), _stable_hash("embed"))
        f = _pod_per_device(shape, lambda e, lay=lay, ekey=ekey, hier=hier: (coll.gather_wire(
            coll.encode_wire([e.reshape(-1)], lay, [ekey]), ("data", "pod"),
            pod_axis="pod" if hier else None),), 1,
            in_specs=(P("model", ("data", "pod"), None),))
        out[f"{tag}/first_gbuf"] = np.asarray(f(params["embed"])[0])
        if tag == meta["ckpt"]:
            save_checkpoint(os.path.join(workdir, "ref_ckpt"), new,
                            meta=dict(arch="gpt-1.3b-smoke", steps=1))
    np.savez(os.path.join(workdir, "reference.npz"), **out)


if __name__ == "__main__":
    what, workdir, *ps = sys.argv[1:]
    if what.startswith("pod_"):
        {"pod_collectives": pod_collectives, "pod_train": pod_train}[what](
            workdir, [tuple(int(a) for a in s.split("x")) for s in ps])
    elif what.startswith("tp_") or what == "reshard":
        {"tp_blocks": tp_blocks, "tp_train": tp_train, "reshard": reshard}[what](
            workdir, [tuple(int(a) for a in pm.split("x")) for pm in ps])
    else:
        {"collectives": collectives, "train": train}[what](workdir, [int(p) for p in ps])
