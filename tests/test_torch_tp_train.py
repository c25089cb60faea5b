"""QSDP training with tensor parallelism on the model axis over (P, M) gloo
ranks on the CPU, against the JAX package's ``make_jitted_train_step`` on
its (P, M) ("data", "model") mesh with ``batch_pspec P("data")`` (set-up in
``_torch_dist_common.py``'s (P, M) mode; the reference runs in
``_torch_dist_jax.py tp_train``):

  * gpt-1.3b's smoke config at (1, 2), (2, 2) and (1, 4): steps A (the
    initial state) and B (a later one) with f32 state, loss, grad norm and
    each rank's (d, m) block of the new state within
    ``assert_step_close``'s tolerances; step Q (quantized_state, 8-bit
    moments) as its parts: its start state byte-equal, its loss and grad
    norm within those tolerances, its f32 update (run U: the same step
    from the decoded start, not re-encoded) within them, and its new state
    byte-equal to U's new state encoded as the step encodes its master;
  * qwen2.5-3b's smoke config (qkv bias, 2 KV heads) at (1, 4), its KV
    replicated and summed over the model group (``grad_sync_model``), and
    at (2, 2), its KV split: step A;
  * step A's first gathered buffer (the embedding's tp-local shard) byte-equal
    on every rank;
  * step A's wire bytes by op equal to ``step_comm_bytes`` of the rank's
    engines (tp-local sizes), and its model-group all-reduces the
    structure's count;
  * the (2, 2) checkpoint of the reference's states after A and Q saved
    over both groups: ``manifest.json`` and every ``state.npz`` member
    byte-equal to the reference's ``save_checkpoint``; loaded back by block;
  * at (1, 2), run P (step A under ``QSDPConfig(prefetch=True)``) within
    those tolerances of the reference's P, and byte-equal to run A in both
    packages;
  * the gradient norm counts a model-replicated leaf once per model rank,
    as the reference's ``psum`` over every axis does (ROADMAP C10).
"""
import json
import zipfile

import numpy as np
import pytest

import _torch_dist_common as dc
from _torch_train_common import GNORM_RTOL, assert_step_close

CASES = [(arch, pm) for arch, (meshes, _) in dc.TP_TRAIN.items() for pm in meshes]
RUNS = [(arch, pm, tag) for arch, (meshes, runs) in dc.TP_TRAIN.items() for pm in meshes
        for tag in runs if tag in ("A", "B")] + [(dc.TP_CKPT_ARCH, pm, "P")
                                                 for pm in dc.TP_PREFETCH]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_train")
    np.savez(work / "inputs.npz", **dc.tp_train_inputs())
    meshes = sorted({pm for _, pm in CASES})
    started = dc.start_reference("tp_train", work, [f"{p}x{m}" for p, m in meshes])
    ranks = {pm: dc.run_ranks("tp_train_rank", pm[0], work, m=pm[1]) for pm in meshes}
    ref = dc.reference(started, work)
    ranks["ckpt"] = dc.run_ranks("tp_ckpt_rank", 2, work, m=2)
    return work, ref, ranks


def _blocks(ref, pre, r, m, kind="params"):
    """Rank r's (d, m) block of the reference's leaves under `pre`."""
    d, mr = divmod(r, m)
    return {k[len(pre) + len(kind) + 1:]: (ref[k][..., mr:mr + 1, d:d + 1, :]
                                           if ref[k].ndim >= 3 else ref[k])
            for k in ref if k.startswith(f"{pre}{kind}/")}


def _port(got, pre, kind="params"):
    return {k[len(pre) + len(kind) + 1:]: got[k] for k in got if k.startswith(f"{pre}{kind}/")}


@pytest.mark.parametrize("arch,pm,tag", RUNS)
def test_f32_step_matches_reference(results, arch, pm, tag):
    _, ref, ranks = results
    pre = f"{arch}/{pm[0]}x{pm[1]}/{tag}"
    for r, got in enumerate(ranks[pm]):
        rows = [(float(ref[f"{pre}/loss"]), float(got[f"{arch}/{tag}/loss"]),
                 float(ref[f"{pre}/grad_norm"]), float(got[f"{arch}/{tag}/grad_norm"]))]
        assert_step_close(rows, (_blocks(ref, f"{pre}/flat/", r, pm[1]),
                                 _port(got, f"{arch}/{tag}/flat/"), dc.LR))
        for kind in ("opt/mu", "opt/nu"):
            assert sorted(_blocks(ref, f"{pre}/flat/", r, pm[1], kind)) == \
                sorted(_port(got, f"{arch}/{tag}/flat/", kind))
        assert int(got[f"{arch}/{tag}/flat/opt/step"]) == int(ref[f"{pre}/flat/opt/step"])


@pytest.mark.parametrize("pm", dc.TP_TRAIN["gpt-1.3b"][0])
def test_quantized_state_step_matches_reference(results, pm):
    """The quantized-state step is its f32 update followed by the master's
    re-encoding, held part by part.  Its decoded new state is not held
    value by value at ``assert_step_close``'s share: where the two
    frameworks' updates part by a rounding at a master bucket's extreme
    (rare: two of the four ranks at (1, 4) here), the re-encoding moves
    the whole bucket's 1,024 values by up to a code."""
    _, ref, ranks = results
    pre = f"gpt-1.3b/{pm[0]}x{pm[1]}"
    for r, got in enumerate(ranks[pm]):
        start = _blocks(ref, f"{pre}/Q/", r, pm[1], "start")
        for k, want in start.items():
            assert got[f"gpt-1.3b/Q/start/{k}"].tobytes() == want.tobytes(), k
        rows = [(float(ref[f"{pre}/Q/loss"]), float(got["gpt-1.3b/Q/loss"]),
                 float(ref[f"{pre}/Q/grad_norm"]), float(got["gpt-1.3b/Q/grad_norm"]))]
        assert_step_close(rows, (_blocks(ref, f"{pre}/U/flat/", r, pm[1]),
                                 _port(got, "gpt-1.3b/U/flat/"), dc.LR))
        assert got["gpt-1.3b/U/loss"] == got["gpt-1.3b/Q/loss"]
        assert got["gpt-1.3b/U/grad_norm"] == got["gpt-1.3b/Q/grad_norm"]
        q, u = _port(got, "gpt-1.3b/Q/", "flat"), _port(got, "gpt-1.3b/U/", "encoded")
        assert sorted(q) == sorted(u)
        for k in q:
            assert q[k].tobytes() == u[k].tobytes(), k


@pytest.mark.parametrize("arch,pm", CASES)
def test_first_gathered_buffer_byte_equal(results, arch, pm):
    _, ref, ranks = results
    want = ref[f"{arch}/{pm[0]}x{pm[1]}/A/first_gbuf"]
    assert len(ranks[pm]) == want.shape[0] == pm[0] * pm[1]
    for r, got in enumerate(ranks[pm]):
        assert got[f"{arch}/A/first_gbuf"].tobytes() == want[r].tobytes(), r


@pytest.mark.parametrize("arch,pm", CASES)
def test_wire_bytes_at_tp_local_sizes(results, arch, pm):
    """Step A's calls into torch.distributed and the bytes they brought in,
    by op.  Per microbatch the layers are gathered twice and
    reduce-scattered once, the embedding and the final norm gathered and
    reduce-scattered once, all at their tp-local shard sizes (the rank's
    ``step_comm_bytes``).  The model group sums in rank order (an
    all-gather of f32 values), per microbatch: the embedding's output and
    the cross-entropy's exp-sums and targets (forward) and dh (backward),
    each layer's attention and MLP outputs in the forward, the attention's
    again in the checkpoint's replay (which stops once it has rebuilt what
    the backward saved, before the MLP's sum), the attention's and the
    MLP's input cotangents (``tp_copy``), and each ``grad_sync_model``
    leaf's gradient shard; then the loss and the norm.  The cross-entropy's row max is the one all-reduce (``pmax``)
    besides the data group's loss and norm."""
    from repro_torch.core.qsdp import MeshSpec
    _, _, ranks = results
    p, m = pm
    n_micro = dc.N_MICRO[p]
    model = dc.tp_model(arch, 1, m)
    layers, d = model.cfg.n_layers, model.cfg.d_model
    t = dc.B // p // n_micro * dc.S
    sync = [s.n_local(MeshSpec(("data", "model"), pm)) for s in model.specs.values()
            if s.grad_sync_model]
    tp_calls = n_micro * (4 + layers * (5 + len(sync))) + 2
    tp_bytes = 4 * (m - 1) * (n_micro * (2 * t * d + 2 * t + layers * (5 * t * d + sum(sync)))
                              + 2)
    for got in ranks[pm]:
        comm = {op: got[f"{arch}/A/comm/{op}"].tolist() for op in
                ("all_gather", "all_to_all", "reduce_scatter", "all_reduce")}
        w_layers, w_top, g_layers, g_top = got[f"{arch}/A/want_bytes"].tolist()
        assert comm == {
            "all_gather": [n_micro * (2 * layers + 2) + tp_calls,
                           n_micro * (w_layers + w_top) + tp_bytes],
            "all_to_all": [n_micro * (layers + 2), n_micro * (g_layers + g_top)],
            "reduce_scatter": [0, 0],
            "all_reduce": [n_micro + 2, 4 * (n_micro * (m - 1) * t + 2 * (p - 1))]}


@pytest.mark.parametrize("pm", dc.TP_PREFETCH)
def test_prefetch_step_bit_equal_to_unpipelined(results, pm):
    """Run P (run A of the prefetch model): on every rank its loss, grad
    norm and new state byte-equal to run A's, as the reference's P to its
    A at the same mesh."""
    _, ref, ranks = results
    arch, pre = dc.TP_CKPT_ARCH, f"{dc.TP_CKPT_ARCH}/{pm[0]}x{pm[1]}"
    keys = [k for k in ref if k.startswith(f"{pre}/A/flat/")]
    assert keys
    for k in keys + [f"{pre}/A/loss", f"{pre}/A/grad_norm"]:
        assert ref[k].tobytes() == ref[k.replace("/A/", "/P/", 1)].tobytes(), k
    for got in ranks[pm]:
        keys = [k for k in got if k.startswith(f"{arch}/A/flat/")]
        assert keys
        for k in keys + [f"{arch}/A/loss", f"{arch}/A/grad_norm"]:
            assert got[k].tobytes() == got[k.replace("/A/", "/P/", 1)].tobytes(), k


def test_checkpoint_byte_equal_to_reference(results):
    work, _, ranks = results
    for tag in ("A", "Q"):
        assert all(bool(r[f"{tag}/reloaded_equal"]) for r in ranks["ckpt"]), tag
        a, b = work / f"ref_ckpt_{tag}", work / f"port_ckpt_{tag}"
        manifest = json.loads((b / "manifest.json").read_text())
        assert manifest["mesh"] == {"model_size": 2, "fsdp_size": 2}
        assert (a / "manifest.json").read_bytes() == (b / "manifest.json").read_bytes(), tag
        with zipfile.ZipFile(a / "state.npz") as za, zipfile.ZipFile(b / "state.npz") as zb:
            assert za.namelist() == zb.namelist(), tag
            for name in za.namelist():
                assert za.read(name) == zb.read(name), (tag, name)


@pytest.mark.parametrize("arch,pm", CASES)
def test_norm_counts_replicated_leaves_m_times(results, arch, pm):
    """Each rank's per-leaf sums of squares (the step's ``global_norm``
    input): summed over all P·M ranks they give the port's grad norm, and
    the reference's within its tolerance, nearer than counting each
    model-replicated leaf (the norms; replicated KV) once.  Where the KV is
    replicated (qwen2.5-3b at M = 4) the once-counted norm lies far outside
    the tolerance."""
    _, ref, ranks = results
    p, m = pm
    every = once = 0.0
    for r, got in enumerate(ranks[pm]):
        sq, rep = got[f"{arch}/A/sq"], got[f"{arch}/A/replicated"]
        every += sq.sum()
        once += sq[~rep].sum() + (sq[rep].sum() if r % m == 0 else 0.0)
    every, once = np.sqrt(every), np.sqrt(once)
    jg = float(ref[f"{arch}/{p}x{m}/A/grad_norm"])
    for got in ranks[pm]:
        assert abs(float(got[f"{arch}/A/grad_norm"]) - every) <= 1e-6 * every
    assert abs(jg - every) <= GNORM_RTOL * jg
    assert abs(jg - every) < abs(jg - once)
    if any(s.grad_sync_model for s in dc.tp_model(arch, 1, m).specs.values()):
        assert abs(jg - once) > 10 * GNORM_RTOL * jg
