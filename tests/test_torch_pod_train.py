"""QSDP training of gpt-1.3b's smoke config on a ("pod", "data", "model")
mesh over Q·D·M gloo ranks on the CPU, against the JAX package's
``make_jitted_train_step`` on its (Q, D, M) mesh of 8 host devices with
``batch_pspec P(("data", "pod"))`` (set-up in ``_torch_dist_common.py``'s
pod mode; the reference runs in ``_torch_dist_jax.py pod_train``), f32
compute, one step from the same initial state on the same batch:

  * run F, (2, 2, 1) flat; run H, (2, 2, 1) under ``hierarchical``; run
    HP, (2, 2, 2) under ``hierarchical`` and ``prefetch``: loss, grad norm
    and each rank's (FSDP index, model rank) block of the new parameters
    within ``assert_step_close``'s tolerances (``tests/_torch_train_common.
    py``), and of Adam's moments within ``MOMENT_RTOL``, the block taken at
    the data-major FSDP index ``d·Q + q``;
  * each run's first gathered buffer (the embedding's; two levels under
    ``hierarchical``) byte-equal on every rank;
  * each run's K1/K2 calls equal to ``chip_smoke.expected_train_launches``
    (``core.qsdp.layer_kernel_launches`` at the rank's mesh: the
    reduce-scatter's K1 once a chunk at each level) and, at M = 1, its calls
    into torch.distributed to ``expected_train_comm`` (one all-gather and
    one all-to-all a level a layer under ``hierarchical``);
  * the reference's state after H saved over the port's groups:
    ``manifest.json`` and every member of ``state.npz`` byte-equal to the
    reference's ``save_checkpoint``; loaded back block by block at (model,
    fsdp) = (1, 4), and resharded to (1, 1) (``load_checkpoint(...,
    model=)``) equal to the reference's state laid out at one rank;
  * ``hierarchical`` on a ("data", "model") mesh: a step byte-equal to the
    flat one (it changes no exchange without a "pod" axis, as in the
    reference).
"""
import json
import zipfile

import numpy as np
import pytest

import _torch_dist_common as dc
from _torch_train_common import assert_step_close

RUNS = tuple(dc.POD_TRAIN)
# Adam's moments after one step are (1 - b1)·g and (1 - b2)·g², so they hold
# each leaf's gradient at its own scale.  Where the frameworks' cotangents
# straddle a stochastic rounding threshold a G8 code moves by one level, at
# most 2/255 of the bucket's largest value, and the two-level form rounds
# twice: mu within 2·2/255 of the leaf's largest value, nu (a square) within
# twice that (measured on the CPU: at most 0.0063 for either).  A wrong
# divisor or a level summed twice moves a leaf by half its scale or more.
MOMENT_RTOL = {"opt/mu": 4 / 255, "opt/nu": 8 / 255}
MESHES = sorted({s for s, _, _ in dc.POD_TRAIN.values()})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("pod_train")
    np.savez(work / "inputs.npz", **dc.pod_train_inputs())
    started = dc.start_reference("pod_train", work, [dc.pod_key(s) for s in MESHES], devices=8)
    ranks = {s: dc.run_ranks("pod_train_rank", s[1], work, timeout=300, m=s[2], q=s[0])
             for s in MESHES}
    ref = dc.reference(started, work, timeout=400)
    shape = dc.POD_TRAIN[dc.POD_CKPT][0]
    ranks["ckpt"] = dc.run_ranks("pod_ckpt_rank", shape[1], work, timeout=300, m=shape[2],
                                 q=shape[0])
    return work, ref, ranks


def _blocks(ref, pre, rank, m, kind="params"):
    """The (FSDP index `rank`, model rank `m`) block of the reference's
    leaves under `pre`."""
    return {k[len(pre) + len(kind) + 1:]: (ref[k][..., m:m + 1, rank:rank + 1, :]
                                           if ref[k].ndim >= 3 else ref[k])
            for k in ref if k.startswith(f"{pre}{kind}/")}


def _port(got, pre, kind="params"):
    return {k[len(pre) + len(kind) + 1:]: got[k] for k in got if k.startswith(f"{pre}{kind}/")}


def _ranks(ranks, tag):
    shape = dc.POD_TRAIN[tag][0]
    q, d, m = shape
    out = []
    for r, got in enumerate(ranks[shape]):
        qq, rest = divmod(r, d * m)
        dd, mm = divmod(rest, m)
        assert int(got["fsdp_index"]) == dd * q + qq
        out.append((got, dd * q + qq, mm))
    return out


@pytest.mark.parametrize("tag", RUNS)
def test_step_matches_reference(results, tag):
    _, ref, ranks = results
    for got, rank, m in _ranks(ranks, tag):
        rows = [(float(ref[f"{tag}/loss"]), float(got[f"{tag}/loss"]),
                 float(ref[f"{tag}/grad_norm"]), float(got[f"{tag}/grad_norm"]))]
        assert_step_close(rows, (_blocks(ref, f"{tag}/flat/", rank, m),
                                 _port(got, f"{tag}/flat/"), dc.LR))
        for kind, rtol in MOMENT_RTOL.items():
            want = _blocks(ref, f"{tag}/flat/", rank, m, kind)
            have = _port(got, f"{tag}/flat/", kind)
            assert sorted(want) == sorted(have)
            for k, w in want.items():
                err = np.abs(have[k] - w).max()
                assert err <= rtol * np.abs(w).max(), (tag, rank, m, kind, k, err)
        assert int(got[f"{tag}/flat/opt/step"]) == int(ref[f"{tag}/flat/opt/step"])


@pytest.mark.parametrize("tag", RUNS)
def test_first_gathered_buffer_byte_equal(results, tag):
    _, ref, ranks = results
    want = ref[f"{tag}/first_gbuf"]
    shape = dc.POD_TRAIN[tag][0]
    assert want.shape[0] == len(ranks[shape])
    for r, got in enumerate(ranks[shape]):
        assert got[f"{tag}/first_gbuf"].tobytes() == want[r].tobytes(), r


@pytest.mark.parametrize("tag", RUNS)
def test_launches_and_calls_equal_formula(results, tag):
    _, _, ranks = results
    shape, hier, _ = dc.POD_TRAIN[tag]
    for got, _, _ in _ranks(ranks, tag):
        assert got[f"{tag}/launches"].tolist() == got[f"{tag}/want_launches"].tolist()
        if shape[2] == 1:
            assert got[f"{tag}/comm"].tolist() == got[f"{tag}/want_comm"].tolist()
    flat, two = (np.asarray(_ranks(ranks, t)[0][0][f"{t}/want_launches"]) for t in ("F", "H"))
    # the two levels' reduce-scatter encodes D + Q chunks a gradient, the
    # flat one Q·D: at (2, 2) as many
    assert flat[0] == two[0] and flat[1] <= two[1]


def test_checkpoint_byte_equal_to_reference(results):
    from repro_torch.train.checkpoint import load_checkpoint, state_to_flat
    work, ref, ranks = results
    shape = dc.POD_TRAIN[dc.POD_CKPT][0]
    assert all(bool(r["reloaded_equal"]) for r in ranks["ckpt"])
    a, b = work / "ref_ckpt", work / "port_ckpt"
    manifest = json.loads((b / "manifest.json").read_text())
    assert manifest["mesh"] == {"model_size": shape[2], "fsdp_size": shape[0] * shape[1]}
    assert (a / "manifest.json").read_bytes() == (b / "manifest.json").read_bytes()
    with zipfile.ZipFile(a / "state.npz") as za, zipfile.ZipFile(b / "state.npz") as zb:
        assert za.namelist() == zb.namelist()
        for name in za.namelist():
            assert za.read(name) == zb.read(name), name
    # resharded to (1, 1) through the logical form: each leaf the
    # reference's, re-laid out at one rank
    import torch
    from repro_torch.core.qsdp import MeshSpec, from_rest, to_rest
    one = dc.tp_model(dc.ARCH, 1, 1)
    whole = state_to_flat(load_checkpoint(str(b), "cpu", model=one))[0]
    pre = f"{dc.POD_CKPT}/flat/"
    want = {k[len(pre):]: ref[k] for k in ref if k.startswith(pre)}
    assert sorted(whole) == sorted(want)
    src = MeshSpec(("pod", "data", "model"), shape)
    for k, v in whole.items():
        w = want[k]
        if k != "opt/step":
            spec = one.specs[k.split("/", 1)[1] if k.startswith("params/") else
                             k.split("/", 2)[2]]
            w = to_rest(from_rest(torch.from_numpy(np.array(w)), spec, src), spec, one.ms).numpy()
        assert v.shape == w.shape and v.tobytes() == np.ascontiguousarray(w).tobytes(), k


def test_hierarchical_without_pod_axis_is_flat():
    import torch
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    from repro_torch.train.checkpoint import state_to_flat
    from repro_torch.train.step import build_train_step, init_train_state
    z = dc.train_inputs((2,))
    b = {k: torch.from_numpy(z[f"P2/batch0/{k}"]).long() for k in ("tokens", "labels")}
    _, (opt, _) = dc.train_models(1)
    runs = []
    for hier in (False, True):
        model = Model(configs.get_smoke(dc.ARCH), MeshSpec(("data", "model"), (1, 1)),
                      QSDPConfig(compute_dtype=dc.COMPUTE_DTYPE, hierarchical=hier))
        assert not model.engine.two_level
        step = build_train_step(model, opt, n_micro=2, device="cpu")
        runs.append(step(init_train_state(model, opt, 0, "cpu"), b,
                         prng.fold_in(prng.PRNGKey(1), 0)))
    (s0, m0), (s1, m1) = runs
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["grad_norm"]) == float(m1["grad_norm"])
    f0, f1 = state_to_flat(s0)[0], state_to_flat(s1)[0]
    assert sorted(f0) == sorted(f1)
    assert all(f0[k].tobytes() == f1[k].tobytes() for k in f0)
