"""Data-parallel QSDP training of gpt-1.3b's smoke config over P gloo ranks
on the CPU, against the JAX package's ``make_jitted_train_step`` on its
(P, 1) mesh with ``batch_pspec P("data")``, at P = 2 and 4 (set-up in
``_torch_dist_common.py``; the reference runs in ``_torch_dist_jax.py``).

Both packages step the same states (made with numpy by the test, whole
``(stack?, 1, P, n_local)`` leaves of which each port rank takes its
block) on the same batches (each rank its rows):

  * steps A (the initial state) and B (a later one: moved params, random
    moments, step 1) with f32 state, P (step A under ``QSDPConfig(
    prefetch=True)``; also bit-equal to A in both packages, its calls and
    bytes those of each layer gathered once), and Q (quantized_state, 8-bit
    moments): loss and grad norm, and each rank's block of the updated
    params, within ``assert_step_close``'s tolerances
    (``tests/_torch_train_common.py``); Q's quantized start state
    byte-equal;
  * step A's first gathered buffer (the embedding's) byte-equal;
  * step A's wire bytes by op equal to ``core/qsdp.py::step_comm_bytes`` at
    P (the layers gathered twice a microbatch, the top-level tensors once),
    and its calls into torch.distributed to the structure's;
  * at P = 2, the reference's states after A and Q saved over the port's
    group: ``manifest.json`` byte-equal to the reference's and every member
    of ``state.npz`` byte-equal, in the same order (the zip container's
    member timestamps are the time of writing); loaded back rank by rank;
  * a gloo group of one rank bit-equal to ``group=None``;
  * a model axis above 1 accepted by the engine and the mesh (the (P, M)
    grid's tests are ``test_torch_tp_*.py``); the refusals: a "pod" axis
    and ``--hierarchical`` (A3b), a load on another layout without the
    model (the reference's ValueError; with it, resharded), serving
    over ranks, either axis (A10e), the other families over ranks, either
    axis (A11h).
"""
import json
import zipfile

import numpy as np
import pytest
import torch

import _torch_dist_common as dc
from _torch_train_common import assert_step_close

PS = (2, 4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist_train")
    np.savez(work / "inputs.npz", **dc.train_inputs(PS))
    started = dc.start_reference("train", work, PS)
    ranks = {p: dc.run_ranks("train_rank", p, work) for p in PS}
    ref = dc.reference(started, work)
    ranks["ckpt"] = dc.run_ranks("ckpt_rank", 2, work)
    return work, ref, ranks


def _blocks(ref, p, tag, r, kind="params"):
    """Rank r's block of the reference's leaves after step `tag`."""
    pre = f"P{p}/{tag}/flat/{kind}/"
    return {k[len(pre):]: ref[k][..., r:r + 1, :] for k in ref if k.startswith(pre)}


def _port(got, tag, kind="params"):
    pre = f"{tag}/flat/{kind}/"
    return {k[len(pre):]: got[k] for k in got if k.startswith(pre)}


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("tag", ("A", "B", "P"))
def test_f32_step_matches_reference(results, p, tag):
    _, ref, ranks = results
    for r, got in enumerate(ranks[p]):
        rows = [(float(ref[f"P{p}/{tag}/loss"]), float(got[f"{tag}/loss"]),
                 float(ref[f"P{p}/{tag}/grad_norm"]), float(got[f"{tag}/grad_norm"]))]
        # LR is the schedule's peak; an AdamW update of these states moves a
        # param by at most about LR
        assert_step_close(rows, (_blocks(ref, p, tag, r), _port(got, tag), dc.LR))
        for kind in ("mu", "nu"):
            jm, tm = _blocks(ref, p, tag, r, f"opt/{kind}"), _port(got, tag, f"opt/{kind}")
            assert sorted(jm) == sorted(tm)
        assert int(got[f"{tag}/flat/opt/step"]) == int(ref[f"P{p}/{tag}/flat/opt/step"])


def _decoded(flat: dict, leaves: dict) -> dict:
    """The params of a flat state (wire leaves decoded), by name."""
    from repro_torch.train.checkpoint import state_from_flat
    from repro_torch.train.step import dequantize_train_state
    st = dequantize_train_state(state_from_flat(flat, leaves, "cpu"))
    return {k: v.numpy() for k, v in st.params.items()}


@pytest.mark.parametrize("p", PS)
def test_quantized_state_step_matches_reference(results, p):
    _, ref, ranks = results
    leaves = json.loads(str(ref[f"P{p}/Q/leaves"]))
    for r, got in enumerate(ranks[p]):
        # the quantized start state: each rank's wire cells byte-equal
        pre = f"P{p}/Q/start/"
        for k in (k for k in ref if k.startswith(pre)):
            want = ref[k][..., r:r + 1, :] if ref[k].ndim >= 3 else ref[k]
            assert got[f"Q/start/{k[len(pre):]}"].tobytes() == want.tobytes(), k
        jflat = {k[len(f"P{p}/Q/flat/"):]: (v[..., r:r + 1, :] if v.ndim >= 3 else v)
                 for k, v in ((k, ref[k]) for k in ref if k.startswith(f"P{p}/Q/flat/"))}
        tflat = {k[len("Q/flat/"):]: v for k, v in got.items() if k.startswith("Q/flat/")}
        rows = [(float(ref[f"P{p}/Q/loss"]), float(got["Q/loss"]),
                 float(ref[f"P{p}/Q/grad_norm"]), float(got["Q/grad_norm"]))]
        assert_step_close(rows, (_decoded(jflat, leaves), _decoded(tflat, leaves), dc.LR))


@pytest.mark.parametrize("p", PS)
def test_first_gathered_buffer_byte_equal(results, p):
    _, ref, ranks = results
    for r, got in enumerate(ranks[p]):
        assert got["A/first_gbuf"].tobytes() == ref[f"P{p}/A/first_gbuf"][r].tobytes()


@pytest.mark.parametrize("p", PS)
def test_wire_bytes_equal_step_comm_bytes(results, p):
    """Per microbatch the layers are gathered twice (forward and the
    checkpoint's replay) and reduce-scattered once; the embedding and the
    final norm, gathered outside every checkpoint, once each.  The rank
    computed ``step_comm_bytes`` of engines of its own mesh over the stacked
    and the top-level params; the calls are ``chip_smoke.py``'s
    ``expected_train_comm``."""
    from test_torch_continuous import _chip_smoke
    _, _, ranks = results
    n_micro = dc.N_MICRO[p]
    model, _ = dc.train_models(1)
    want_calls = _chip_smoke().expected_train_comm(model, n_micro)
    for got in ranks[p]:
        calls = {op: got[f"A/comm/{op}"].tolist() for op in ("all_gather", "all_to_all",
                                                            "reduce_scatter", "all_reduce")}
        w_layers, w_top, g_layers, g_top = got["A/want_bytes"].tolist()
        assert {op: c for op, (c, _) in calls.items()} == want_calls
        assert {op: b for op, (_, b) in calls.items()} == {
            "all_gather": n_micro * (w_layers + w_top),
            "all_to_all": n_micro * (g_layers + g_top), "reduce_scatter": 0,
            # the loss and the norm: one f32 each from every other rank
            "all_reduce": 2 * 4 * (p - 1)}


@pytest.mark.parametrize("p", PS)
def test_prefetch_step_bit_equal_to_unpipelined(results, p):
    """Step P (step A under ``QSDPConfig(prefetch=True)``): on every rank its
    loss, grad norm and new state byte-equal to step A's, as the
    reference's P to its A; its calls into torch.distributed those of
    ``expected_train_comm`` for the prefetch model (each layer gathered once
    a microbatch: the backward decodes the buffer its forward gathered),
    its gathered bytes the layers' once and the top-level tensors'."""
    from test_torch_continuous import _chip_smoke
    _, ref, ranks = results
    for tag_ref in ("loss", "grad_norm"):
        assert ref[f"P{p}/P/{tag_ref}"].tobytes() == ref[f"P{p}/A/{tag_ref}"].tobytes()
    for k in (k for k in ref if k.startswith(f"P{p}/A/flat/")):
        assert ref[k].tobytes() == ref[k.replace("/A/", "/P/", 1)].tobytes(), k
    model, _ = dc.train_models(1, prefetch=True)
    want_calls = _chip_smoke().expected_train_comm(model, dc.N_MICRO[p])
    for got in ranks[p]:
        for k in [k for k in got if k.startswith("A/flat/")] + ["A/loss", "A/grad_norm"]:
            assert got[k].tobytes() == got["P/" + k[2:]].tobytes(), k
        calls = {op: got[f"P/comm/{op}"].tolist() for op in ("all_gather", "all_to_all",
                                                            "reduce_scatter", "all_reduce")}
        assert {op: c for op, (c, _) in calls.items()} == want_calls
        w_layers, w_top, _, _ = got["A/want_bytes"].tolist()
        assert calls["all_gather"][1] == dc.N_MICRO[p] * (w_layers // 2 + w_top)
        assert calls["all_to_all"][1] == got["A/comm/all_to_all"][1]


def test_checkpoint_byte_equal_to_reference(results):
    work, ref, ranks = results
    for tag in ("A", "Q"):
        assert all(bool(r[f"{tag}/reloaded_equal"]) for r in ranks["ckpt"]), tag
        a, b = work / f"ref_ckpt_{tag}", work / f"port_ckpt_{tag}"
        assert (a / "manifest.json").read_bytes() == (b / "manifest.json").read_bytes(), tag
        with zipfile.ZipFile(a / "state.npz") as za, zipfile.ZipFile(b / "state.npz") as zb:
            assert za.namelist() == zb.namelist(), tag
            for name in za.namelist():
                assert za.read(name) == zb.read(name), (tag, name)


def test_one_rank_group_bit_equal_to_none(tmp_path):
    np.savez(tmp_path / "inputs.npz", **{k: v for k, v in dc.train_inputs((2,)).items()
                                         if "batch0" in k})
    got, = dc.run_ranks("one_rank_rank", 1, tmp_path)
    for k in got:
        if k.startswith("group/") and not k.endswith("/calls"):
            other = got["none/" + k[len("group/"):]]
            assert got[k].tobytes() == other.tobytes(), k
    calls_group, calls_none = got["group/calls"], got["none/calls"]
    assert calls_none.sum() == 0 and calls_group[0] > 0 and calls_group[1] > 0
    assert calls_group[3] == 2  # the loss and the grad norm


def test_refusals_name_their_items(tmp_path, capsys, monkeypatch):
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig, QSDPEngine
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import Model
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.step import init_train_state

    assert QSDPEngine(MeshSpec(("data", "model"), (1, 2)), QSDPConfig(), {},
                      model_rank=0).model_rank == 0
    with pytest.raises(NotImplementedError, match="ROADMAP A3b"):
        QSDPEngine(MeshSpec(("pod", "data", "model"), (1, 1, 1)), QSDPConfig(), {})
    with pytest.raises(ValueError, match="process group has 1"):
        QSDPEngine(MeshSpec(("data", "model"), (2, 1)), QSDPConfig(), {})
    # the model axis passes the mesh check; the grid must fill the world
    with pytest.raises(ValueError, match="has 8 ranks, the world 4"):
        tmesh.init_distributed("cpu", tmesh.make_small_spec(2, 4), rank=0, world_size=4)
    for mesh, item in ((tmesh.make_mesh_spec(multi_pod=True), "A3b"),
                       (MeshSpec(("pod", "data", "model"), (2, 2, 1)), "A3b")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            tmesh.init_distributed("cpu", mesh, rank=0, world_size=4)
    for arch, family in (("olmoe-1b-7b", "moe"), ("zamba2-7b", "hybrid")):
        for shape in ((2, 1), (1, 2)):
            with pytest.raises(NotImplementedError, match="ROADMAP A11h"):
                Model(configs.get_smoke(arch), MeshSpec(("data", "model"), shape), QSDPConfig())
    for argv, item in ((["--arch", "olmoe-1b-7b", "--smoke", "--model-par", "2"], "ROADMAP A11h"),
                       (["--hierarchical"], "ROADMAP A3b"),
                       (["--prefetch", "--no-coalesce"], "--prefetch requires coalescing")):
        with pytest.raises(SystemExit):
            launch_train.parse_args(argv)
        assert item in capsys.readouterr().err
    assert launch_train.parse_args(["--prefetch"]).prefetch
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--arch", "olmoe-1b-7b", "--smoke", "--data-par", "2"])
    assert "ROADMAP A11h" in capsys.readouterr().err
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--data-par", "2"])
    assert "torchrun --nproc_per_node 2" in capsys.readouterr().err
    for argv, item in ((["--data-par", "2"], "A10e"), (["--model-par", "2"], "A10e")):
        with pytest.raises(SystemExit):
            launch_serve.parse_args(argv)
        assert f"ROADMAP {item}" in capsys.readouterr().err
    m, (opt, _) = dc.train_models(1)
    save_checkpoint(str(tmp_path), init_train_state(m, opt, 0, "cpu"))
    with pytest.raises(ValueError, match="resharding needs the `model` argument"):
        load_checkpoint(str(tmp_path), "cpu", mesh_sizes=(1, 2), rank=1)
    # with the model, the two ranks of the (2, 1) layout take their halves
    # of each leaf's flat values
    whole = load_checkpoint(str(tmp_path), "cpu")
    halves = [load_checkpoint(str(tmp_path), "cpu", mesh_sizes=(1, 2), rank=r, model=m)
              for r in (0, 1)]
    for k, v in whole.params.items():
        n = v.shape[-1]
        both = torch.cat([h.params[k] for h in halves], dim=-1)[..., :n]
        assert torch.equal(both, v), k
