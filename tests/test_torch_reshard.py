"""Checkpoint resharding across (model, fsdp) layouts: the port's
``load_checkpoint(..., model=, dequantize=)`` against the JAX package's
``load_checkpoint(path, mesh, pspecs, model=, dequantize=)`` on the CPU.

The reference (``_torch_dist_jax.py reshard``, on 4 host devices) saves
gpt-1.3b's smoke state at the (P, M) layouts (1, 1), (2, 1), (1, 2) and
(2, 2), twice: "f32" (f32 params and moments, step 3) and "q8"
(quantized_state params, 8-bit nearest moments), the values drawn here with
numpy.  It loads every file at each of the other three layouts, "q8" with
``dequantize=True``.  The port loads the same files at the same layouts,
block by block ((d, m) for d < P, m < M), and every block must be
byte-equal to ``rank_block`` of the reference's whole leaf.  Also: the
blocks laid end to end are the reference's whole leaf; the two
ValueErrors the reference raises (no `model`, a quantized leaf in wire
form); a same-layout load keeps every byte, and with ``dequantize=True``
gives the decoded leaves.
"""
import json

import numpy as np
import pytest
import torch

import _torch_dist_common as dc

LAYOUTS = ((1, 1), (2, 1), (1, 2), (2, 2))   # (P, M)
MOMENT_BUCKET = 1024
PAIRS = [(s, t) for s in LAYOUTS for t in LAYOUTS if s != t]


def _spec_model(p, m):
    """A model whose `specs` the load reads: the engine need not span the
    target mesh (the specs hold logical shapes only)."""
    from repro_torch import configs
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    return Model(configs.get_smoke(dc.ARCH), MeshSpec(("data", "model"), (1, m)), QSDPConfig(),
                 model_rank=0)


def _inputs(seed=0) -> dict:
    """Logical params and moments of the smoke config (moments at the
    specs' shapes; params as the port's init draws them)."""
    from repro_torch.core.qsdp import MeshSpec, from_rest, init_param
    rng = np.random.default_rng(seed)
    model = _spec_model(1, 1)
    one = MeshSpec(("data", "model"), (1, 1))
    gen = torch.Generator().manual_seed(seed)
    out = {"meta": np.array(json.dumps(dict(arch=dc.ARCH, moment_bucket=MOMENT_BUCKET)))}
    for n, spec in sorted(model.specs.items()):
        out[f"params/{n}"] = from_rest(init_param(gen, spec, one, "cpu"), spec, one).numpy()
        shape = ((spec.stack,) if spec.stack is not None else ()) + spec.shape
        out[f"mu/{n}"] = (1e-3 * rng.standard_normal(shape)).astype(np.float32)
        out[f"nu/{n}"] = (1e-6 * rng.random(shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    w = tmp_path_factory.mktemp("reshard")
    np.savez(w / "inputs.npz", **_inputs())
    started = dc.start_reference("reshard", w, [f"{p}x{m}" for p, m in LAYOUTS])
    return w, dc.reference(started, w)


def _flat(state) -> dict:
    from repro_torch.train.checkpoint import state_to_flat
    return state_to_flat(state)[0]


def _block(a: np.ndarray, d, p, m, n_m) -> np.ndarray:
    from repro_torch.core.qsdp import rank_block
    return rank_block(a, d, p, m, n_m) if a.ndim >= 3 else a


@pytest.mark.parametrize("kind", ["f32", "q8"])
@pytest.mark.parametrize("src,tgt", PAIRS, ids=[f"{s[0]}x{s[1]}-{t[0]}x{t[1]}"
                                                for s, t in PAIRS])
def test_reshard_blocks_byte_equal_to_reference(work, src, tgt, kind):
    from repro_torch.train.checkpoint import load_checkpoint
    w, ref = work
    (sp, sm), (tp, tm) = src, tgt
    pre = f"{sp}x{sm}/{tp}x{tm}/{kind}/"
    want = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
    assert want
    model = _spec_model(tp, tm)
    blocks = {}
    for d in range(tp):
        for m in range(tm):
            got = _flat(load_checkpoint(str(w / f"ckpt_{sp}x{sm}_{kind}"), "cpu",
                                        mesh_sizes=(tm, tp), rank=d, model_rank=m, model=model,
                                        dequantize=kind == "q8"))
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                b = _block(want[k], d, tp, m, tm)
                assert v.dtype == b.dtype and v.shape == b.shape, k
                assert v.tobytes() == b.tobytes(), (k, d, m)
                blocks.setdefault(k, {})[d, m] = v
    # the P·M blocks laid end to end are the whole leaf
    for k, v in want.items():
        if v.ndim < 3:
            continue
        rows = [np.concatenate([blocks[k][d, m] for d in range(tp)], axis=-2)
                for m in range(tm)]
        assert np.concatenate(rows, axis=-3).tobytes() == v.tobytes(), k


def test_reshard_refusals_and_same_layout(work):
    """The reference's two ValueErrors; a same-layout load byte-equal to the
    file; ``dequantize=True`` at the same layout gives the decoded leaves;
    a reshard to (1, 1), saved by the port and resharded back to (2, 2),
    gives the file's blocks."""
    from repro_torch.train.checkpoint import load_checkpoint
    from repro_torch.train.step import dequantize_train_state
    w, _ = work
    path = str(w / "ckpt_2x2_q8")
    with pytest.raises(ValueError, match="resharding needs the `model` argument"):
        load_checkpoint(path, "cpu", mesh_sizes=(1, 1))
    with pytest.raises(ValueError, match="cannot be resharded in wire form"):
        load_checkpoint(path, "cpu", mesh_sizes=(1, 1), model=_spec_model(1, 1))
    with np.load(w / "ckpt_2x2_q8" / "state.npz") as z:
        disk = {k: z[k] for k in z.files}
    for d in range(2):
        for m in range(2):
            kept = load_checkpoint(path, "cpu", mesh_sizes=(2, 2), rank=d, model_rank=m)
            got = _flat(kept)
            assert sorted(got) == sorted(disk)
            for k, v in got.items():
                assert v.tobytes() == _block(disk[k], d, 2, m, 2).tobytes(), k
            dec = _flat(load_checkpoint(path, "cpu", mesh_sizes=(2, 2), rank=d, model_rank=m,
                                        dequantize=True))
            want = _flat(dequantize_train_state(kept))
            assert sorted(dec) == sorted(want)
            assert all(dec[k].tobytes() == want[k].tobytes() for k in want)
    # the f32 file through the port's own save at (1, 1): reshard there and back
    from repro_torch.train.checkpoint import save_checkpoint
    one = load_checkpoint(str(w / "ckpt_2x2_f32"), "cpu", mesh_sizes=(1, 1),
                          model=_spec_model(1, 1))
    save_checkpoint(str(w / "port_1x1_f32"), one)
    with np.load(w / "ckpt_2x2_f32" / "state.npz") as z:
        orig = {k: z[k] for k in z.files}
    for d in range(2):
        for m in range(2):
            back = _flat(load_checkpoint(str(w / "port_1x1_f32"), "cpu", mesh_sizes=(2, 2),
                                         rank=d, model_rank=m, model=_spec_model(2, 2)))
            for k, v in back.items():
                assert v.tobytes() == _block(orig[k], d, 2, m, 2).tobytes(), k
