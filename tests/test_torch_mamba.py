"""The Mamba2 mixer of the port (``models/mamba.py``) against the JAX
package's on the CPU, on the same inputs made from a numpy seed:
``_causal_conv``, ``segsum_decay``, ``ssd_chunked`` (a length that pads to
whole chunks, and an initial state), ``mamba2_block(return_state=True)``
and ``mamba2_decode`` (run through ``shard_map`` on the (1, 1) mesh, whose
``tp_reduce``/``psum`` are the identity there), in f32 and bf16 compute.
Then the short-prompt case (ROADMAP C7): what the reference returns for a
prompt shorter than the conv state, and the port's refusal.  Last, the
family's registry entries and parameter specs against the reference's, and
the serve and train launchers."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.models.mamba as jmamba
from repro.compat import shard_map
from repro_torch.models import mamba
from repro_torch.models.decode import DecodeModel, DecodeSpec
from repro_torch.models.transformer import Model
from repro_torch.core.qsdp import MeshSpec, QSDPConfig
from repro_torch.models.config import ModelConfig

torch.set_num_threads(1)
MESH = jax.make_mesh((1, 1), ("data", "model"))
# d_model 32, N 8, P 8, expand 2 (d_inner 64, 8 heads), conv 4, chunk 8
D, N, HP, EXPAND, K, CHUNK = 32, 8, 8, 2, 4, 8
B, S = 2, 20  # 20 tokens pad to 3 chunks of 8
# f32: summation order and the libm of exp/softplus (block output 7.2e-7
# measured on values up to 4.4).  bf16: the projections and the gated norm
# round to bf16, and XLA may keep a fused chain in f32 where PyTorch rounds
# each op (1.6e-2 measured on outputs up to 4.4, where one bf16 ulp is
# 3.1e-2; the f32 state 2.3e-3 on values up to 1.4)
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
STATE_ATOL = {"float32": 2e-5, "bfloat16": 2e-3}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs():
    kw = dict(d_model=D, d_state=N, head_dim=HP, expand=EXPAND, conv_k=K, chunk=CHUNK, tp=1)
    return jmamba.MambaConfig(**kw), mamba.MambaConfig(**kw)


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    din, h = EXPAND * D, EXPAND * D // HP

    def nrm(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return {"w_z": nrm(D, din, s=D ** -0.5), "w_x": nrm(D, din, s=D ** -0.5),
            "w_bc": nrm(D, 2 * N, s=D ** -0.5), "w_dt": nrm(D, h, s=D ** -0.5),
            "conv_x": nrm(din, K, s=0.3), "conv_bc": nrm(2 * N, K, s=0.3),
            "a_log": np.full(h, 0.5, np.float32) + nrm(h, s=0.1),
            "dt_bias": np.full(h, -1.0, np.float32) + nrm(h, s=0.3),
            "d_skip": 1.0 + nrm(h, s=0.1), "norm": 1.0 + nrm(din, s=0.1),
            "w_out": nrm(din, D, s=din ** -0.5)}


def _as(w: dict, dt: str):
    jdt, tdt = DTYPES[dt]
    return ({k: jnp.asarray(v, jdt) for k, v in w.items()},
            {k: torch.from_numpy(v).to(tdt) for k, v in w.items()})


def _close(got: torch.Tensor, want, atol, what=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dt):
    rng = np.random.default_rng(1)
    x, w = rng.standard_normal((B, S, 24)).astype(np.float32), rng.standard_normal((24, K))
    jdt, tdt = DTYPES[dt]
    want = jmamba._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    got = mamba._causal_conv(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and got.shape == (B, S, 24)
    _close(got, want, ATOL[dt])
    # causal: the first output sees the first input only
    _close(got[:, 0], np.asarray(x[:, 0] * w[:, -1], np.float32), ATOL[dt])


def test_segsum_decay_matches_jax():
    da_cs = np.cumsum(-np.random.default_rng(2).random((B, 3, CHUNK, 5)), axis=2)
    want = jmamba.segsum_decay(jnp.asarray(da_cs, jnp.float32))
    got = mamba.segsum_decay(torch.from_numpy(da_cs).float())
    _close(got, want, 1e-6)
    assert not got[:, :, 0, 1:].any()  # masked to j <= i


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(with_h0):
    """20 tokens at chunk 8 pad with 4 dt = 0 steps; the final state is the
    last real token's (checked against chunk 20, no padding, too)."""
    rng = np.random.default_rng(3)
    h = 5
    x = rng.standard_normal((B, S, h, HP)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bm, cm = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, h, HP, N)).astype(np.float32) if with_h0 else None
    want_y, want_h = jmamba.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), CHUNK,
                                        h0=None if h0 is None else jnp.asarray(h0))
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    got_y, got_h = mamba.ssd_chunked(*t, CHUNK, h0=th0)
    assert got_y.shape == (B, S, h, HP) and got_h.shape == (B, h, HP, N)
    _close(got_y, want_y, 1e-4, "y")
    _close(got_h, want_h, 1e-4, "state")
    one_y, one_h = mamba.ssd_chunked(*t, S, h0=th0)  # one chunk, no padding
    _close(got_y, one_y.numpy(), 1e-4, "y vs one chunk")
    _close(got_h, one_h.numpy(), 1e-4, "state vs one chunk")


def _jax_block(x, jw, jcfg):
    fn = jax.jit(shard_map(lambda xx: jmamba.mamba2_block(xx, jw, jcfg, return_state=True),
                           mesh=MESH, in_specs=P(), out_specs=P(), check_vma=False))
    return fn(x)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mamba2_block_matches_jax(dt):
    jcfg, tcfg = _cfgs()
    jw, tw = _as(_weights(), dt)
    x = np.random.default_rng(4).standard_normal((B, S, D)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    jout, (jcx, jcbc, jh) = _jax_block(jnp.asarray(x, jdt), jw, jcfg)
    out, (cx, cbc, hf) = mamba.mamba2_block(torch.from_numpy(x).to(tdt), tw, tcfg,
                                            return_state=True)
    assert out.dtype == tdt and cx.dtype == tdt and cbc.dtype == tdt
    assert hf.dtype == torch.float32
    assert cx.shape == (B, K - 1, EXPAND * D) and cbc.shape == (B, K - 1, 2 * N)
    _close(out, jout, ATOL[dt], "out")
    _close(cx, jcx, ATOL[dt], "conv_x state")
    _close(cbc, jcbc, ATOL[dt], "conv_bc state")
    _close(hf, jh, STATE_ATOL[dt] * max(1.0, float(np.abs(np.asarray(jh)).max())), "ssm state")
    assert torch.equal(mamba.mamba2_block(torch.from_numpy(x).to(tdt), tw, tcfg), out)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mamba2_decode_matches_jax(dt):
    """Three recurrent steps from a random state, the state carried."""
    jcfg, tcfg = _cfgs()
    jw, tw = _as(_weights(5), dt)
    rng = np.random.default_rng(6)
    c = EXPAND * D + 2 * N
    conv = rng.standard_normal((B, K - 1, c)).astype(np.float32)
    ssm = rng.standard_normal((B, EXPAND * D // HP, HP, N)).astype(np.float32) * 0.3
    fn = jax.jit(shard_map(lambda x, cv, st: jmamba.mamba2_decode(x, jw, jcfg, cv, st),
                           mesh=MESH, in_specs=(P(), P(), P()), out_specs=(P(), P(), P()),
                           check_vma=False))
    jdt, tdt = DTYPES[dt]
    jc, js, tc, ts = jnp.asarray(conv), jnp.asarray(ssm), torch.from_numpy(conv), \
        torch.from_numpy(ssm)
    for step in range(3):
        x = rng.standard_normal((B, D)).astype(np.float32)
        jout, jc, js = fn(jnp.asarray(x, jdt), jc, js)
        prev = tc
        out, tc, ts = mamba.mamba2_decode(torch.from_numpy(x).to(tdt), tw, tcfg, tc, ts)
        assert out.dtype == tdt and tc.dtype == ts.dtype == torch.float32
        _close(out, jout, ATOL[dt], f"out, step {step}")
        _close(tc, jc, ATOL[dt], f"conv ring, step {step}")
        _close(ts, js, STATE_ATOL[dt], f"ssm state, step {step}")
        # the ring shifts by one, the current token's inputs entering last
        assert torch.equal(tc[:, :-1], prev[:, 1:])


@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_reference_state_and_port_refusal(s):
    """ROADMAP C7: the reference slices the conv state as ``xin_raw[:, s -
    (k - 1):]``, so a prompt of fewer than K-1 tokens leaves a state of
    fewer than K-1 rows (one row for s = 1 and s = 2: the negative start
    index counts from the end); the port refuses such a prompt instead, in
    the mixer and in prefill."""
    jcfg, tcfg = _cfgs()
    jw, tw = _as(_weights(), "float32")
    x = np.random.default_rng(7).standard_normal((1, s, D)).astype(np.float32)
    _, (jcx, jcbc, _) = _jax_block(jnp.asarray(x), jw, jcfg)
    assert jcx.shape == (1, 1, EXPAND * D) and jcbc.shape == (1, 1, 2 * N)
    assert jcx.shape[1] < K - 1
    with pytest.raises(ValueError, match="shorter than the conv state"):
        mamba.mamba2_block(torch.from_numpy(x), tw, tcfg, return_state=True)
    mamba.mamba2_block(torch.from_numpy(x), tw, tcfg)  # no state asked: runs
    cfg = ModelConfig(name="ssm", arch_type="ssm", n_layers=1, d_model=64, vocab_size=128,
                      ssm_state=16, ssm_head_dim=32)
    model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
    dm = DecodeModel(model, DecodeSpec(cache_len=0, batch_global=1, batch_sharded=False))
    assert dm.min_prompt_len == K - 1
    params = model.init_params(0, "cpu")
    with pytest.raises(ValueError, match="shorter than the ssm prefill's minimum"):
        dm.prefill_fn(params, {"tokens": torch.zeros((1, s), dtype=torch.int64)},
                      (0, 0), dm.init_cache_local("cpu"))
    dm.prefill_fn(params, {"tokens": torch.zeros((1, K - 1), dtype=torch.int64)}, (0, 0),
                  dm.init_cache_local("cpu"))


# -- the family's registry, specs and entry points -------------------------------

@pytest.mark.parametrize("name", ["mamba2_370m", "zamba2_7b"])
def test_ssm_family_ported(name):
    """The registry entry field-equal to the reference's (full and smoke) with
    its parameter count; the parameter specs equal the reference's (names
    in order, shapes, flags, init), which fixes the wire layout."""
    from repro import configs as jconfigs
    from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
    from repro.models.transformer import Model as JModel
    from repro_torch import configs
    want_params = {"mamba2_370m": 367_632_384, "zamba2_7b": 6_632_579_072}[name]
    for tget, jget in ((configs.get_config, jconfigs.get_config),
                       (configs.get_smoke, jconfigs.get_smoke)):
        t, j = tget(name.replace("_", "-")), jget(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.n_params() == j.n_params()
        tm = Model(t, MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
        jm = JModel(j, JMeshSpec(("data", "model"), (1, 1)), JQSDPConfig())
        assert list(tm.specs) == list(jm.specs)
        for n, ts in tm.specs.items():
            js = jm.specs[n]
            assert (ts.shape, ts.tp_axis, ts.stack, ts.init, ts.init_scale, ts.quantize,
                    ts.grad_sync_model) == (js.shape, js.tp_axis, js.stack, js.init,
                                            js.init_scale, js.quantize, js.grad_sync_model), n
    assert configs.get_config(name).n_params() == want_params


@pytest.mark.parametrize("flags", [[], ["--continuous", "--requests", "4", "--temperature",
                                        "0.8", "--top-k", "40"]])
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_serve_launcher_ssm(arch, flags, capsys):
    from repro_torch.launch import serve as launch_serve
    rc = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                            "--prompt-len", "8", "--gen", "4", *flags])
    out = capsys.readouterr().out
    assert rc == 0 and arch.split("-")[0] + "-smoke" in out and "sample:" in out
    if flags:
        assert "4 requests" in out


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_train_launcher_ssm(arch, tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    out_json = tmp_path / "log.json"
    rc = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                            "--batch", "4", "--seq", "32", "--log-every", "1",
                            "--out-json", str(out_json)])
    out = capsys.readouterr().out
    assert rc == 0 and arch.split("-")[0] + "-smoke" in out
    log = json.loads(out_json.read_text())["log"]
    assert [r["step"] for r in log] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["gnorm"]) for r in log)
    assert abs(log[0]["loss"] - np.log(1024)) < 0.5
