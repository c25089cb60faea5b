"""The port's one-rank dry run (``launch/dryrun.py`` with
``configs/inputs.py`` and ``roofline/counter.py``) on the CPU: every
family's smoke config x the four assigned shapes counted on the meta device
(launches equal to ``chip_smoke.py``'s formulas, the state's bytes equal to
a real CPU init's, nothing on the host but the control tensors); the
counted FLOPs against the JAX package's ``analyze_hlo`` of its dry run's
steps compiled on the (1, 1) mesh, with the products the port computes
otherwise by design named and computed; 8-bit moments through the meta
K1/K2 path; the CLI and its refusals; a CPU rehearsal of ``chip_smoke.py``'s
roofline phase."""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.compat import shard_map
from repro.configs.inputs import input_specs as jinput_specs
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.models.decode import DecodeModel as JDecodeModel, make_decode_spec as jdecode_spec
from repro.models.transformer import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig, OptState as JOptState
from repro.optim import make_adamw as jmake_adamw
from repro.roofline.hlo_analyzer import analyze_hlo
from repro.train.step import (TrainState as JTrainState, build_train_step as jbuild_train_step,
                              state_pspecs)
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.experiments import roofline_report
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES
from repro_torch.models.decode import LANE_BLOCK, DecodeModel, make_decode_spec
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamWConfig, make_adamw
from repro_torch.roofline import Counter
from repro_torch.train.step import (build_train_step, init_train_state, master_eligible,
                                    quantize_train_state)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("gpt-1.3b", "olmoe-1b-7b", "mamba2-370m", "zamba2-7b", "qwen2-vl-72b",
            "seamless-m4t-large-v2")
# the reference dry run's steps the counts are held against
REF_PAIRS = (("gpt-1.3b", "train_4k"), ("gpt-1.3b", "decode_32k"),
             ("olmoe-1b-7b", "train_4k"), ("mamba2-370m", "train_4k"))
FLOPS_RTOL = 0.01
# the host control tensors: a decode step's positions and lane blocks, the
# optimizer's scalars; no tensor of the model's widths
HOST_BYTES = 64 << 10


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.fixture(scope="module")
def cs():
    return _chip_smoke()


@pytest.fixture(scope="module")
def record():
    """The dry run's record of (arch's smoke config, shape), counted once."""
    cache = {}

    def get(arch, shape):
        if (arch, shape) not in cache:
            cache[arch, shape] = dryrun.run_one(arch, shape, verbose=False,
                                                cfg=configs.get_smoke(arch))
        return cache[arch, shape]
    return get


def _tensor_bytes(tree) -> int:
    return dryrun.tensors_bytes(tree)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_dry_run_pair(record, cs, arch, shape):
    """One (smoke config, shape) pair counted on meta: ok at mesh 1x1 with
    the reference's record keys; K1/K2 launches equal to the chip script's
    formulas for the step (a train step's over its 256 one-row
    microbatches: 1 and 2 counted, the rest charged as the second); the
    state's bytes equal to a real CPU init's (the decode cache by its
    shapes: the lanes of LANE_BLOCK blocks); no tensor on the host larger
    than the control tensors; wire bytes 0 at one rank."""
    r = record(arch, shape)
    assert r["ok"] and r["mesh"] == "1x1" and r["arch"] == arch and r["shape"] == shape
    assert {"flops_per_device", "bytes_per_device", "bytes_min_per_device", "t_compute",
            "t_memory", "t_memory_min", "t_collective", "bottleneck", "useful_flops_ratio",
            "collectives", "memory", "qsdp", "t_count_s", "flops_by_dtype",
            "launches"} <= set(r)
    assert r["collective_bytes"] == 0 and r["t_collective"] == 0
    assert r["qsdp"] == {"w": 8, "g": 8, "hierarchical": False}
    cfg = configs.get_smoke(arch)
    model = Model(cfg, dryrun.MS11, QSDPConfig(**dryrun.DEFAULT_QSDP))
    sh = SHAPES[shape]
    params = _tensor_bytes(model.init_params(0, "cpu"))
    if sh.kind == "train":
        assert r["n_micro"] == sh.global_batch
        want = cs.expected_train_launches(model, sh.global_batch)
        want = (want["quantize_pack"], want["unpack_dequantize"], 0)
        state = _tensor_bytes(init_train_state(model, make_adamw(AdamWConfig()), 0, "cpu"))
    else:
        if cfg.arch_type in ("dense", "moe"):
            per = cs.expected_launches(model, 1, False)
            prefill = (per["quantize_pack"], per["unpack_dequantize"], 0)
            step = per["per_step"]
        else:
            per = cs.expected_serve_launches(model, False)
            prefill, step = per["prefill"], per["step"]
        want = prefill if sh.kind == "prefill" else step
        dm = DecodeModel(model, make_decode_spec(model, sh), lane_block=LANE_BLOCK)
        cache = sum(torch.Size((s[0], dm.lanes, *s[2:])).numel() * dt.itemsize
                    for s, dt in dm.cache_struct().values())
        state = params + (cache if sh.kind == "decode" else 0)
    got = r["launches"]
    assert (got.get("quantize_pack", 0), got.get("unpack_dequantize", 0),
            got.get("rowquant_matmul", 0)) == tuple(want)
    assert set(got) <= {"quantize_pack", "unpack_dequantize"}
    assert r["memory"]["args"] == state
    assert r["memory"]["temp"] > 0 and r["peak_memory_bytes"] == r["memory"]["temp"]
    assert r["host_tensor_bytes"] <= HOST_BYTES


# ---------------------------------------------------------------------------
# against the reference's HLO
# ---------------------------------------------------------------------------


def _reference_hlo(arch: str, shape_name: str) -> str:
    """The reference dry run's step of (arch's smoke config, shape)
    (``src/repro/launch/dryrun.py::build_step``) on the (1, 1) mesh,
    lowered and compiled: its HLO text."""
    ms = JMeshSpec(("data", "model"), (1, 1))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    shape = SHAPES[shape_name]
    model = JModel(jconfigs.get_smoke(arch), ms, JQSDPConfig(**dryrun.DEFAULT_QSDP))
    kind, structs, specs = jinput_specs(model, shape)
    params = {n: jax.ShapeDtypeStruct(s.rest_shape(ms), jnp.float32)
              for n, s in model.specs.items()}
    if kind == "train":
        step = jbuild_train_step(model, jmake_adamw(JAdamWConfig()), n_micro=shape.global_batch)
        sspec = state_pspecs(model)
        state = JTrainState(params=params, opt=JOptState(
            step=jax.ShapeDtypeStruct((), jnp.int32), mu=params, nu=params))
        fn = shard_map(step, mesh=mesh, in_specs=(sspec, *specs),
                       out_specs=(sspec, {"loss": P(), "grad_norm": P(), "step": P()}),
                       check_vma=False)
        args, donate = (state, *structs), (0,)
    else:
        assert kind == "decode", kind
        dm = JDecodeModel(model, jdecode_spec(model, shape))
        fn = shard_map(dm.decode_fn, mesh=mesh, in_specs=(model.param_pspecs(), *specs),
                       out_specs=(specs[1], specs[0]), check_vma=False)
        args, donate = (params, *structs), (1,)
    return jax.jit(fn, donate_argnums=donate).lower(*args).compile().as_text()


def named_differences(arch: str, shape_name: str) -> dict:
    """The products the port computes otherwise than the reference's
    compiled step, by design, in FLOPs (port less reference) from the smoke
    config's shapes.  A train step of T = seq_len tokens a microbatch:

    * the vocab-parallel cross-entropy's backward recomputes the f32 logits
      (2·T·d·V), as the reference's custom VJP does, but XLA merges the
      reference's recompute with its forward's (CSE);
    * attention: per layer, microbatch and (1024 x 1024) chunk pair the
      port's autograd evaluates 8 chunk products (2 forward, 2 replayed by
      the layer's checkpoint, 4 backward), the reference's autodiff of its
      rematerialized query-chunk scan (``models/attention.py:126``) 11;
    * the SSM's depthwise causal convs: the reference's backward is two
      convolutions a conv, the input gradient (2·T·C·K) and the weight
      gradient, which XLA's CPU backend computes as a (K, C, C) product
      over the tokens (2·K·C²·T); the port's backward is K shifted
      elementwise products (no product FLOPs).
    """
    shape = SHAPES[shape_name]
    if shape.kind != "train":
        return {}
    cfg = configs.get_smoke(arch)
    model = Model(cfg, dryrun.MS11, QSDPConfig())
    n, t = shape.global_batch, shape.seq_len  # one-row microbatches
    out = {"xent backward's logits recompute": n * 2 * t * cfg.d_model * model.vp}
    if cfg.has_attention:
        c = min(1024, t)
        product = 2 * model.acfg.heads_local * c * c * cfg.head_dim
        out["attention chunk products, 8 vs 11"] = -3 * n * cfg.n_layers * (t // c) ** 2 * product
    if cfg.arch_type == "ssm":
        mc = model.mcfg
        k = mc.conv_k
        out["conv backward"] = -n * cfg.n_layers * sum(
            2 * t * ch * k + 2 * k * ch * ch * t for ch in (mc.d_inner_local, 2 * mc.d_state))
    return out


@pytest.mark.parametrize("arch,shape", REF_PAIRS)
def test_flops_against_reference(record, arch, shape):
    """The counted FLOPs of each pair == the reference's ``analyze_hlo``
    FLOPs of its dry run's step (trip counts multiplied through), plus the
    named differences, within 1 %; the decode step's exactly."""
    ref = analyze_hlo(_reference_hlo(arch, shape))
    got = record(arch, shape)["flops_per_device"]
    diffs = named_differences(arch, shape)
    want = ref["flops"] + sum(diffs.values())
    assert abs(got - want) <= FLOPS_RTOL * ref["flops"], (got, ref["flops"], diffs)
    if not diffs:
        assert got == ref["flops"]
    assert ref["collectives"]["total"] == 0


# ---------------------------------------------------------------------------
# moments, the CLI, chip_smoke's phase
# ---------------------------------------------------------------------------


def test_eight_bit_moments_and_quantized_state_on_meta(cs):
    """AdamW with 8-bit moments on meta: the moments are encoded by the
    meta K1 path at init, and a step's launches are the structure's with
    the chunked moment decodes (K2) and re-encodes (K1).  With the master
    kept as wire codes (``quantized_state``, encoded on meta by
    ``quantize_train_state``) the step also decodes each master-eligible
    leaf at entry (K2) and re-encodes it at exit (K1), one launch each."""
    model = Model(configs.get_smoke("gpt-1.3b"), dryrun.MS11, QSDPConfig())
    opt = make_adamw(AdamWConfig(moment_bits=8))
    batch = {k: torch.empty((4, 32), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    step = dryrun.train_step(model, opt, batch, 2)
    assert all(q.wire.device.type == "meta" for q in step.state.opt.mu.values())
    got = dryrun.count(step, 2)["launches"]
    want = cs.expected_train_launches(model, 2, moments=True)
    assert got == {k: want[k] for k in ("quantize_pack", "unpack_dequantize")}
    qs = quantize_train_state(step.state, model, prng.PRNGKey(2))
    qstep = build_train_step(model, opt, n_micro=2, quantized_state=True, device="meta")
    n = sum(master_eligible(model, k) for k in model.specs)
    with Counter("meta") as c:
        qstep(qs, batch, prng.PRNGKey(3))
    assert c.counts()["launches"] == {"quantize_pack": want["quantize_pack"] + n,
                                      "unpack_dequantize": want["unpack_dequantize"] + n}


def test_cli_and_refusals(tmp_path, monkeypatch, capsys):
    """``main`` writes one JSON record a line, which the report twin
    reads; the production meshes name A12e and two-level gathers A3b."""
    for flags, item in ((["--multi-pod"], "A12e"), (["--both-meshes"], "A12e"),
                        (["--hierarchical"], "A3b")):
        with pytest.raises(SystemExit, match=item):
            dryrun.main(["--arch", "gpt-1.3b"] + flags)
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    out = tmp_path / "q.jsonl"
    assert dryrun.main(["--arch", "gpt-1.3b", "--shape", "long_500k", "--baseline-fsdp",
                        "--out", str(out)]) == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["ok"] and rec["qsdp"]["w"] == "fp32" and rec["launches"] == {}
    assert "1/1 pairs counted OK" in capsys.readouterr().out
    assert roofline_report.main(["--qsdp", str(out), "--baseline", str(out)],
                                out_dir=str(tmp_path)) == 1
    assert "INCOMPLETE (1/40)" in capsys.readouterr().out


def test_chip_smoke_roofline_phase_rehearsal(monkeypatch, cs):
    """``chip_smoke.py``'s roofline phase on the CPU at the gpt-1.3b smoke
    config: a real CPU train step (batch 4 x 32, 2 microbatches) stands in
    for the profiled one, its wrapper calls as the launches and its own
    count's product FLOPs as the profiler's (device busy time and memory
    are not measured here, so the floor and peak gates get stand-ins that
    pass); the meta count's launches and FLOPs must equal the real step's,
    and the dry run's pair runs."""
    cfg = configs.get_smoke("gpt-1.3b")
    model = Model(cfg, dryrun.MS11, QSDPConfig())
    opt = make_adamw(AdamWConfig())
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
             for k in ("tokens", "labels")}
    calls = {k: 0 for k in ops.KERNELS}
    for name, kernel in (("quantize_pack", "quantize_pack"),
                         ("unpack_dequantize", "unpack_dequantize"),
                         ("unpack_dequantize_wire", "unpack_dequantize")):
        def counted(*a, _orig=getattr(ops, name), _kernel=kernel, **k):
            calls[_kernel] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    step = build_train_step(model, opt, n_micro=2, device="cpu")
    state = init_train_state(model, opt, 0, "cpu")
    with Counter("cpu") as c:
        step(state, batch, prng.PRNGKey(1))
    monkeypatch.undo()
    real = c.counts()
    mm = sum(v for k, v in real["flops_by_op"].items() if "aten::" + k in cs.PROFILER_PRODUCTS)
    counted_meta = cs.count_cell(torch, dict(model=model, opt=opt, n_micro=2, batch=batch))
    stand_in = dict(busy_ms=1e9, wall_ms=1e9, mm_flops=mm, mm_unlaunched=0, mem_before=0,
                    mem_peak=counted_meta["peak_live_bytes"] - counted_meta["base_bytes"])
    measured = {"gpt-1.3b train": dict(model=model, opt=opt, n_micro=2, batch=batch,
                                       step_ms=0.0, launches=calls, prof=stand_in)}
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    lines = []
    out = cs.roofline_phase(torch, lines.append, measured, "a CPU stand-in")
    assert out["gpt-1.3b train"]["flops_per_device"] == real["flops"]
    assert out[cs.ROOFLINE_PAIR]["ok"]
    assert any("dry run gpt-1.3b x decode_32k" in x for x in lines)
