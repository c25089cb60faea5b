"""The model axis's blocks over M gloo ranks on the CPU, against the JAX
package's ``shard_map`` over its (1, M) ("data", "model") mesh, at M = 2
and 4 (set-up in ``_torch_dist_common.py``'s (P, M) mode; the reference
runs in ``_torch_dist_jax.py tp_blocks``).  Every input is made with numpy;
model rank m takes row m of a (M, ...) array, or the replicated value:

  (a) ``tp_copy`` and ``tp_reduce``, forward and backward, bit-equal (the
      port sums over the model group in rank order, as XLA's CPU psum does);
  (b) ``embed_vocab_parallel`` and its gradient, and
      ``vocab_parallel_xent``'s loss, dh and dw (pmax, psums of the
      exp-sums and targets, the psum of dh), f32;
  (c) one dense layer of gpt-1.3b's and qwen2.5-3b's smoke configs (at M =
      4 qwen2.5-3b's 2 KV heads are replicated and indexed by global query
      head): its output and the gradients of x and every tp-local weight,
      f32 compute.

(b) and (c) agree within BLOCK_RTOL of each array's largest value: the
frameworks' f32 matmuls and reductions add in different orders.
"""
import numpy as np
import pytest

import _torch_dist_common as dc

MS = (2, 4)
# a few ulps of f32 relative to each array's largest value (measured up to
# 9.2e-7 in (c), 2.2e-7 in (b))
BLOCK_RTOL = 4e-6


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_blocks")
    np.savez(work / "inputs.npz", **dc.tp_block_inputs(MS))
    started = dc.start_reference("tp_blocks", work, [f"1x{m}" for m in MS])
    ranks = {m: dc.run_ranks("tp_blocks_rank", 1, work, m=m) for m in MS}
    return dc.reference(started, work), ranks


def _close(ref, ranks, m, key):
    want = ref[f"1x{m}/{key}"]
    assert want.shape[0] == len(ranks) == m
    for r, got in enumerate(ranks):
        scale = max(float(np.abs(want[r]).max()), 1e-30)
        assert got[key].shape == want[r].shape, key
        assert float(np.abs(got[key] - want[r]).max()) <= BLOCK_RTOL * scale, (key, r)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("op", ("reduce", "copy"))
def test_tp_ops_bit_equal(results, m, op):
    ref, ranks = results
    for key in (f"tp/{op}", f"tp/{op}_dx"):
        for r, got in enumerate(ranks[m]):
            assert got[key].tobytes() == ref[f"1x{m}/{key}"][r].tobytes(), (key, r)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("what", ("embed", "embed_dw", "loss", "dh", "dw"))
def test_vocab_parallel_embedding_and_xent(results, m, what):
    ref, ranks = results
    _close(ref, ranks[m], m, f"xent/{what}")


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("arch", dc.TP_ARCHS)
def test_dense_layer_output_and_gradients(results, m, arch):
    ref, ranks = results
    keys = sorted(k for k in ranks[m][0] if k.startswith(f"layer/{arch}/"))
    assert {k.split("/")[-1] for k in keys if "/dw/" in k} == {
        k.split("/")[-1] for k in ref if k.startswith(f"1x{m}/layer/{arch}/dw/")}
    for key in keys:
        _close(ref, ranks[m], m, key)
    if arch == "qwen2.5-3b":
        from repro_torch.models.attention import AttnConfig
        cfg = dc.tp_model(arch, 1, m).acfg
        assert isinstance(cfg, AttnConfig) and cfg.kv_mode == ("tp" if m == 2 else "replicated")
