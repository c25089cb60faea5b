"""The port's exchanges over a ``torch.distributed`` group against the JAX
package's under ``shard_map`` on a (P,) mesh, at P = 2 and 4 gloo ranks on
the CPU (set-up in ``_torch_dist_common.py``; the reference runs in
``_torch_dist_jax.py``).  Every rank's output is compared with what the
reference's device of that rank returned:

  * the fp gather, f32 and bf16 wire, byte-equal;
  * the quantized gather, W8 and W4 shift rounding: the gathered codes,
    scale and zero and the decoded values (each shard decoded with its own
    bucket padding) byte-equal;
  * the quantized reduce-scatter, G8 stochastic: byte-equal, the P received
    rows summed in rank order as XLA's ``jnp.sum(axis=0)`` sums them;
  * the fp reduce-scatter through a bf16 wire: byte-equal at P = 2; at P = 4
    within one bf16 rounding of the sum's size (the sum runs in bf16 in the
    backend's own order: gloo's and XLA's orders of four addends differ, so
    one intermediate may round to another bf16 value);
  * a gpt-1.3b smoke layer's coalesced gather (its layout, the gathered
    buffer's bytes, the decoded tensors) and coalesced reduce-scatter.

The wire traffic the port counts (``collectives.COMM``) is the analytic
model's: one call per exchange, (P - 1) shards received a gather.
"""
import numpy as np
import pytest

import _torch_dist_common as dc

PS = (2, 4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("dist_collectives")
    np.savez(work / "inputs.npz", **dc.collective_inputs(PS))
    started = dc.start_reference("collectives", work, PS)
    ranks = {p: dc.run_ranks("collectives_rank", p, work) for p in PS}
    return dc.reference(started, work), ranks


CASES = ("fp_gather_float32", "fp_gather_bfloat16", "q_gather_w8", "q_gather_w4",
         "q_gather_w8_codes", "q_gather_w8_scale", "q_gather_w8_zero",
         "q_gather_w4_codes", "q_gather_w4_scale", "q_gather_w4_zero", "q_rs_g8")


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("case", CASES)
def test_exchange_byte_equal(results, p, case):
    ref, ranks = results
    want = ref[f"P{p}/{case}"]
    for r, got in enumerate(ranks[p]):
        assert got[case].dtype == want[r].dtype, case
        assert got[case].tobytes() == np.ascontiguousarray(want[r]).tobytes(), (case, r)


@pytest.mark.parametrize("p", PS)
def test_fp_reduce_scatter_bf16_wire(results, p):
    ref, ranks = results
    want = ref[f"P{p}/fp_rs_bfloat16"]
    for r, got in enumerate(ranks[p]):
        g = got["fp_rs_bfloat16"]
        if p == 2:  # two addends: one rounding whatever the order
            assert g.tobytes() == np.ascontiguousarray(want[r]).tobytes()
        else:
            # the intermediate sums round to bf16 in the backend's order: at
            # most one bf16 step (2^-7 relative) of the largest sum apart
            assert np.abs(g - want[r]).max() <= 2.0 ** -7 * np.abs(want[r]).max()


@pytest.mark.parametrize("p", PS)
def test_coalesced_layer_byte_equal(results, p):
    ref, ranks = results
    n = len(ref[f"P{p}/layer_segments"])
    for r, got in enumerate(ranks[p]):
        assert np.array_equal(got["layer_segments"], ref[f"P{p}/layer_segments"])
        assert np.array_equal(got["layer_rs_segments"], ref[f"P{p}/layer_rs_segments"])
        assert got["layer_gbuf"].tobytes() == ref[f"P{p}/layer_gbuf"][r].tobytes()
        for i in range(n):
            assert got[f"layer_gather{i}"].tobytes() == \
                ref[f"P{p}/layer_gather{i}"][r].tobytes(), (r, i)
            assert got[f"layer_rs{i}"].tobytes() == ref[f"P{p}/layer_rs{i}"][r].tobytes(), (r, i)


@pytest.mark.parametrize("p", PS)
def test_comm_counter(results, p):
    """Calls into torch.distributed by op, and the bytes each brought in from
    the other ranks: the analytic model's per-device bytes
    (``gather_wire_bytes`` / ``reduce_scatter_wire_bytes``) of the same
    exchanges."""
    from repro_torch.core.collectives import gather_wire_bytes, reduce_scatter_wire_bytes
    from repro_torch.core.quant import QuantConfig
    _, ranks = results
    for got in ranks[p]:
        calls = {op: got[f"comm/{op}"].tolist() for op in ("all_gather", "all_to_all",
                                                          "reduce_scatter", "all_reduce")}
        w8, w4 = QuantConfig(bits=8), QuantConfig(bits=4)
        w8l, g8 = QuantConfig(bits=8, mode="shift"), QuantConfig(bits=8, mode="stochastic")
        lay, rs = got["layer_segments"], got["layer_rs_segments"]
        # fp gathers f32 and bf16; each quantized gather twice (the entry
        # point, then its three parts again); the layer buffer twice
        # (gather_wire, then all_gather_coalesced)
        gather = (gather_wire_bytes(3000, p, None, 4) + gather_wire_bytes(3000, p, None, 2)
                  + 2 * gather_wire_bytes(3000, p, w8) + 2 * gather_wire_bytes(3000, p, w4)
                  + 2 * sum(gather_wire_bytes(int(n), p, w8l if q else None, 4)
                            for n, q, _ in lay))
        a2a = (reduce_scatter_wire_bytes(p * 2500, p, g8)
               + sum(reduce_scatter_wire_bytes(p * int(n), p, g8 if q else None, 2)
                     for n, q in rs))
        assert calls == {"all_gather": [2 + 12 + 2, gather], "all_to_all": [3 + 1, a2a],
                         "reduce_scatter": [1, reduce_scatter_wire_bytes(p * 2500, p, None, 2)],
                         "all_reduce": [0, 0]}
