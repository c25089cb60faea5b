"""The port's exchanges on a ("pod", "data", "model") mesh over Q·D·M gloo
ranks on the CPU, against the JAX package's under ``shard_map`` on its
(Q, D, M) mesh of 8 host devices, at (2, 2, 1) and (2, 2, 2) (set-up in
``_torch_dist_common.py``'s pod mode; the reference runs in
``_torch_dist_jax.py pod_collectives``).  Every rank's output is compared
with what the reference's device of that rank returned (device and global
rank ``q·D·M + d·M + m``):

  * the flat forms over the joint (data, pod) group byte-equal to the
    reference's over ("data", "pod"): the fp gather, the W8 quantized
    gather, the G8 quantized reduce-scatter, the coalesced layer's gathered
    buffer and reduce-scatter; the bf16 fp reduce-scatter within one bf16
    step.  The flat group's own ranks run pod-major (``new_group`` sorts
    them) and the FSDP order is data-major, so these catch a missing
    permutation;
  * the per-tensor two-level forms (``all_gather_hierarchical``,
    ``reduce_scatter_hierarchical``) byte-equal, and each level's
    delivery: the codes, scale and zero after the pod level and after the
    inner level, the rows received at the inner level, the inner sum, the
    rows received at the pod level;
  * the coalesced two-level forms over a gpt-1.3b smoke layer (quantized
    weights and fp norms): the pod level's buffer, the two-level gathered
    buffer (equal to the flat one), the decoded tensors, and the
    reduce-scatter step by step (inner rows, inner sums, pod rows) and as
    ``reduce_scatter_coalesced_hierarchical`` returns it, byte-equal.  The
    pod rows are encoded from the inner sums, so they need the inner sums
    bit-equal: the port adds received rows in XLA's CPU order;
  * each two-level call's calls into torch.distributed and their bytes
    equal to each level's ``gather_wire_bytes`` /
    ``reduce_scatter_wire_bytes``.
"""
import numpy as np
import pytest

import _torch_dist_common as dc

MESHES = dc.POD_MESHES


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("pod_collectives")
    np.savez(work / "inputs.npz", **dc.pod_collective_inputs(MESHES))
    started = dc.start_reference("pod_collectives", work, [dc.pod_key(s) for s in MESHES],
                                 devices=8)
    ranks = {s: dc.run_ranks("pod_collectives_rank", s[1], work, timeout=300, m=s[2], q=s[0])
             for s in MESHES}
    return dc.reference(started, work), ranks


def _each(results, shape):
    ref, ranks = results
    pre = dc.pod_key(shape) + "/"
    q, d, m = shape
    assert len(ranks[shape]) == q * d * m
    for r, got in enumerate(ranks[shape]):
        qq, rest = divmod(r, d * m)
        dd, _ = divmod(rest, m)
        assert int(got["fsdp_index"]) == dd * q + qq
        yield r, got, (lambda k, r=r: np.ascontiguousarray(ref[pre + k][r]))


def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


FLAT = ("flat/fp_gather", "flat/q_gather_w8", "flat/q_rs_g8", "layer/flat_gbuf")
HIER = ("hier/q_gather_w8", "hier/q_rs_g8", "hier/rs_inner_sum") + tuple(
    f"hier/{op}_{lvl}_{part}" for op, lvls in (("gather", ("pod", "inner")),
                                                ("rs", ("inner", "pod")))
    for lvl in lvls for part in ("codes", "scale", "zero"))


@pytest.mark.parametrize("shape", MESHES, ids=dc.pod_key)
@pytest.mark.parametrize("case", FLAT)
def test_flat_forms_on_pod_mesh_byte_equal(results, shape, case):
    for r, got, want in _each(results, shape):
        _same(got[case], want(case), (case, r))


@pytest.mark.parametrize("shape", MESHES, ids=dc.pod_key)
def test_flat_fp_reduce_scatter_bf16_wire(results, shape):
    """Four addends in bf16 in the backend's order: within one bf16 step
    (2^-7 relative) of the largest sum, as at P = 4 on the (P,) mesh."""
    for r, got, want in _each(results, shape):
        g, w = got["flat/fp_rs_bfloat16"], want("flat/fp_rs_bfloat16")
        assert np.abs(g - w).max() <= 2.0 ** -7 * np.abs(w).max(), r


@pytest.mark.parametrize("shape", MESHES, ids=dc.pod_key)
@pytest.mark.parametrize("case", HIER)
def test_per_tensor_two_level_byte_equal(results, shape, case):
    for r, got, want in _each(results, shape):
        _same(got[case], want(case), (case, r))


@pytest.mark.parametrize("shape", MESHES, ids=dc.pod_key)
def test_coalesced_two_level_byte_equal(results, shape):
    ref, _ = results
    pre = dc.pod_key(shape) + "/"
    n = len(ref[pre + "layer_segments"])
    # a layer of quantized tensors and fp payloads
    assert {bool(s) for s in ref[pre + "layer_segments"][:, 1]} == {True, False}
    for r, got, want in _each(results, shape):
        for k in ("layer_segments", "layer_rs_segments"):
            assert np.array_equal(got[k], ref[pre + k]), k
        _same(got["layer/hier_gbuf"], got["layer/flat_gbuf"], r)
        keys = ["layer/pod_gbuf", "layer/hier_gbuf", "layer/inner_rows", "layer/pod_rows"]
        keys += [f"layer/{k}{i}" for i in range(n)
                 for k in ("hier_gather", "flat_rs", "hier_rs", "inner_sum")]
        for k in keys:
            _same(got[k], want(k), (k, r))


@pytest.mark.parametrize("shape", MESHES, ids=dc.pod_key)
def test_comm_counter_by_level(results, shape):
    """The two-level calls' traffic: the gather's pod level brings in Q - 1
    shards, its inner level D - 1 blocks of Q shards; the reduce-scatter's
    inner level D - 1 chunks of n/D, its pod level Q - 1 chunks of n/(Q·D)
    (the coalesced layer's fp segments in bf16)."""
    from repro_torch.core.collectives import gather_wire_bytes, reduce_scatter_wire_bytes
    from repro_torch.core.quant import QuantConfig
    q, d, _ = shape
    w8, g8 = QuantConfig(bits=8, mode="shift"), QuantConfig(bits=8, mode="stochastic")
    n = q * d * dc.POD_CHUNK
    _, lay, rs, rs_inner = dc.pod_layouts(shape)

    def gather(n_local, cfg, fp=4):
        return gather_wire_bytes(n_local, q, cfg, fp) + q * gather_wire_bytes(n_local, d, cfg, fp)

    def rs_bytes(n_full, cfg, fp=2):
        return (reduce_scatter_wire_bytes(n_full, d, cfg, fp)
                + reduce_scatter_wire_bytes(n_full // d, q, cfg, fp))

    want = {"hier_gather": {"all_gather": [6, gather(dc.POD_X, w8)]},
            "hier_rs": {"all_to_all": [6, rs_bytes(n, g8)]},
            "hier_layer_gather": {"all_gather": [2, sum(gather(s.n, s.cfg) for s in
                                                        lay.segments)]},
            "hier_layer_rs": {"all_to_all": [2, sum(rs_bytes(q * d * s.n, s.cfg) for s in
                                                    rs.segments)]}}
    for _, got, _ in _each(results, shape):
        for what, calls in want.items():
            for op in ("all_gather", "all_to_all", "reduce_scatter", "all_reduce"):
                assert got[f"{what}/comm/{op}"].tolist() == calls.get(op, [0, 0]), (what, op)
