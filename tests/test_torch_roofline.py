"""The port's roofline (``repro_torch.roofline``) on the CPU: the op
counter on hand-built ops, checkpoints and their backward against the
formulas; the six kernels' meta path (shapes, launches and reported work)
and its boundaries; the per-layer marginal a collective audit reads; the
three-term arithmetic ``==`` the JAX package's ``roofline`` on the same
counts; and the report twin's markdown byte-equal to
``benchmarks/roofline_report.py``'s on the same records, header aside."""
import dataclasses
import functools

import pytest
import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from benchmarks import roofline_report as jreport
from repro.roofline import HW_V5E, roofline as jroofline
from repro.roofline.hlo_analyzer import analyze_hlo
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.qsdp import QSDPConfig
from repro_torch.experiments import roofline_report
from repro_torch.kernels import cost, ops, ref
from repro_torch.launch import dryrun
from repro_torch.models.transformer import _save_dots
from repro_torch.roofline import (Counter, Hardware, compute_floor, marginal, roofline,
                                  scaled)

META = torch.device("meta")
M, K, N = 64, 96, 128


def _bytes(*shapes, itemsize=4):
    total = 0
    for s in shapes:
        n = 1
        for d in s:
            n *= d
        total += n * itemsize
    return total


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_counter_matmul_add_view(device):
    """mm: 2·M·K·N FLOPs, its operands and result in both traffic terms;
    add: its bytes in traffic only (an elementwise op a fusing compiler
    merges); a view: nothing.  The same on a real CPU op as on meta."""
    x = torch.ones((M, K), device=device)
    w = torch.ones((K, N), device=device)
    with Counter(device) as c:
        y = x @ w
    got = c.counts()
    assert got["flops"] == 2 * M * K * N and got["flops_by_dtype"] == {"f32": 2 * M * K * N}
    assert got["traffic_bytes"] == got["traffic_min_bytes"] == _bytes((M, K), (K, N), (M, N))
    with Counter(device) as c:
        z = y + y
        v = z.view(N, M).t()
    got = c.counts()
    assert got["flops"] == 0 and got["traffic_min_bytes"] == 0
    assert got["traffic_bytes"] == 3 * _bytes((M, N))
    assert got["peak_live_bytes"] == _bytes((M, N)) and v.shape == (M, N)
    assert got["collectives"]["total"] == 0 and got["launches"] == {}


def _block(x, w1, w2):
    return torch.tanh(x @ w1) @ w2


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_counter_checkpoint_and_backward(policy):
    """A checkpointed two-matmul block and its backward: the forward's 2
    products, the backward's 4 and, under remat "full", the one recomputed
    (the checkpoint's replay is counted, as the reference's HLO counts it;
    it stops once the saved tensors are rebuilt, before the last product);
    under the "dots" policy (``models.transformer._save_dots``, its own
    dispatch mode nested inside the counter) the first product is kept,
    not recomputed, while the tanh after it replays."""
    x = torch.ones((M, K), device=META, requires_grad=True)
    w1 = torch.ones((K, N), device=META, requires_grad=True)
    w2 = torch.ones((N, K), device=META, requires_grad=True)
    kw = dict(use_reentrant=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    with Counter("meta") as c:
        y = checkpoint(_block, x, w1, w2, **kw)
        y.sum().backward()
    got = c.counts()
    per_product = 2 * M * K * N
    products = 2 + 4 + (1 if policy == "full" else 0)
    assert got["flops"] == products * per_product
    assert got["flops_by_op"] == {"mm": products * per_product}
    assert x.grad.shape == x.shape and w1.grad.shape == w1.shape


def _kernel_cases():
    """(kernel, CPU arguments, call, work) of each wrapper at small
    shapes."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 256), generator=g) * 0.02
    codes, scale, zero = ref.quantize_pack_key_ref(x, prng.PRNGKey(1), 15, 4, "shift")
    wire = torch.cat([codes.reshape(-1), scale.reshape(-1).view(torch.uint8),
                      zero.reshape(-1).view(torch.uint8)])
    seg = ref.WireCodes(0, codes.numel(), codes.numel() + 24, 6, 256, 4)
    rand = torch.rand((6, 256), generator=g)
    c8, s8, z8 = ref.quantize_buckets_ref(x, rand, 255, True)
    xk = torch.randn((4, 256), generator=g)
    keys = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    return [
        ("quantize_pack", (x,),
         lambda t: ops.quantize_pack(t[0], prng.PRNGKey(1), 15, 4, "shift"),
         cost.quantize_pack(6, 256, 4, "shift")),
        ("unpack_dequantize", (codes, scale, zero),
         lambda t: ops.unpack_dequantize(*t, 4, torch.bfloat16),
         cost.unpack_dequantize(6, 256, 4, 2)),
        ("unpack_dequantize", (wire,), lambda t: ops.unpack_dequantize_wire(
            t[0], [seg], [torch.float32]), cost.unpack_dequantize_wire([seg], [4])),
        ("rowquant_matmul", (xk, c8.reshape(256, 6), torch.rand((256, 2), generator=g),
                             torch.rand((256, 2), generator=g)),
         lambda t: ops.rowquant_matmul(*t), cost.rowquant_matmul(4, 256, 6, 2, 4)),
        ("quantize_buckets", (x, rand), lambda t: ops.quantize_buckets(*t, 255, True),
         cost.quantize_buckets(6, 256, True)),
        ("dequantize_buckets", (c8, s8, z8), lambda t: ops.dequantize_buckets(*t),
         cost.dequantize_buckets(6, 256, 4)),
        ("random_bits", (keys,), lambda t: ops.random_bits(t[0], 100), cost.random_bits(2, 100)),
    ]


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("case", range(7))
def test_kernel_meta_path(case):
    """Each wrapper on meta tensors: empty meta outputs of the plain
    version's shapes and dtypes, one launch counted in ``LAUNCHES``, its
    work (``kernels.cost``) reported to the counter: its bytes in both
    traffic terms, K3's operations as product FLOPs.  On CPU tensors the
    same wrapper runs the plain version and reports nothing (the meta path
    is never a CPU tensor's)."""
    name, args, call, work = _kernel_cases()[case]
    before = dict(ops.LAUNCHES)
    with Counter("cpu") as c:
        want = _flat(call(args))
    assert dict(ops.LAUNCHES) == before and c.counts()["launches"] == {}
    on_meta = tuple(a.to(META) for a in args)
    with Counter("meta") as c:
        got = _flat(call(on_meta))
    assert ops.LAUNCHES[name] == before[name] + 1
    assert [(g.device.type, g.shape, g.dtype) for g in got] == \
        [("meta", w.shape, w.dtype) for w in want]
    counts = c.counts()
    assert counts["launches"] == {name: 1}
    assert counts["traffic_bytes"] == counts["traffic_min_bytes"] == work.nbytes
    assert counts["flops"] == (work.flops if name == "rowquant_matmul" else 0)


def test_meta_path_refuses_a_mix():
    """A meta tensor with a CUDA one, or with a CPU one, is refused before
    anything runs (the wrappers' device check reads only ``.device``)."""
    @dataclasses.dataclass
    class OnCard:
        device: torch.device = torch.device("cuda", 0)

    meta = torch.zeros((1, 4), dtype=torch.uint8, device=META)
    with pytest.raises(ValueError, match="meta device"):
        ops.unpack_dequantize(meta, OnCard(), OnCard(), 8)
    with pytest.raises(ValueError, match="meta device"):
        ops.unpack_dequantize(meta, torch.zeros((1, 1)), torch.zeros((1, 1)), 8)


def test_per_layer_marginal():
    """A count at two depths gives one layer's marginal (what a collective
    audit reads): the decode step of the gpt smoke config at 3 layers is
    the count at 1 layer plus twice the marginal of the second, every term
    and the launches alike (the peak within 1e-4); a layer adds its 7 quantized weights' K1
    launches and one K2 launch for its buffer."""
    cfg = configs.get_smoke("gpt-1.3b")

    def at(layers):
        c = dataclasses.replace(cfg, n_layers=layers)
        return dryrun.count(dryrun.build_step("gpt-1.3b", "decode_32k", QSDPConfig(), cfg=c))

    c1, c2, c3 = at(1), at(2), at(3)
    per_layer = marginal(c2, c1)
    assert per_layer["launches"] == {"quantize_pack": 7, "unpack_dequantize": 1}
    extrapolated = scaled(c1, per_layer, 2)
    for k in ("flops", "traffic_bytes", "traffic_min_bytes", "launches", "flops_by_dtype",
              "base_bytes"):
        assert extrapolated[k] == c3[k], k
    # the peak is a maximum, not a sum: the step's transients differ by a few
    # small buffers with the depth (64 KiB here, of 12.3 GiB)
    assert extrapolated["peak_live_bytes"] == pytest.approx(c3["peak_live_bytes"], rel=1e-4)


def test_roofline_equals_reference():
    """The three terms, the bottleneck and the useful ratio of ``roofline``
    == the reference's on the same counts (its analyzer's dict of a
    synthetic HLO module), at the reference's TPU constants."""
    from test_roofline import SYNTH
    counts = analyze_hlo(SYNTH)
    hw = Hardware(name=HW_V5E.name, peak_flops=HW_V5E.peak_flops, hbm_bw=HW_V5E.hbm_bw,
                  ici_bw=HW_V5E.ici_bw)
    for mf in (256 * 5000.0, 1.0):
        want = jroofline("a", "s", "m", {}, SYNTH, 256, mf, HW_V5E, peak_memory=3.0)
        got = roofline("a", "s", "m", counts, 256, mf, hw, peak_memory=3.0)
        assert got.to_dict() == want.to_dict()
        assert got.summary() == want.summary()
    assert compute_floor({"bf16": 989e12, "f32": 67e12}) == pytest.approx(2.0)


def _records(tmp_path):
    """Synthetic dry-run records: two QSDP pairs with a baseline each, one
    without, one failed, on the one mesh."""
    def rec(arch, shape, tc, coll, bn, temp):
        return dict(arch=arch, shape=shape, mesh="1x1", ok=True, t_compute=tc, t_memory=3 * tc,
                    t_memory_min=tc / 2, t_collective=coll / 450e9, collective_bytes=coll,
                    bottleneck=bn, useful_flops_ratio=0.5 + tc, memory=dict(temp=temp))
    import json
    q = [rec("yi_6b", "train_4k", 0.25, 4e9, "memory", 3 * 2**30),
         rec("yi_6b", "decode_32k", 0.002, 1e8, "compute", None),
         rec("olmoe_1b_7b", "long_500k", 1e-4, 0.0, "memory", 2**20),
         dict(arch="x", shape="y", mesh="1x1", ok=False, error="boom")]
    b = [dict(q[0], collective_bytes=1.5e10), dict(q[1], collective_bytes=4e8)]
    paths = []
    for name, rows in (("q.jsonl", q), ("b.jsonl", b)):
        p = tmp_path / name
        p.write_text("".join(json.dumps(r) + "\n" for r in rows))
        paths.append(str(p))
    return paths


def test_report_twin_byte_equal(tmp_path, capsys):
    """The report twin's markdown == the reference's on the same records
    (``benchmarks/roofline_report.py``), but for the header (the card, its
    peaks and where the terms come from) and the pairs line, whose
    expectation is the dry run's 40 pairs on its one mesh (the
    reference's: 40 on each of two meshes)."""
    qp, bp = _records(tmp_path)
    outs = []
    for mod, d in ((jreport, "ref"), (roofline_report, "port")):
        out = tmp_path / d
        rc = mod.main(["--qsdp", qp, "--baseline", bp, "--out", str(out / "r.md")],
                      out_dir=str(out))
        assert rc == 1  # 3 of 40 (of 80) pairs
        outs.append((out / "r.md").read_text().splitlines())
    ref_md, port_md = outs
    n_head = roofline_report.header().__len__()
    assert port_md[0] == ("# Roofline report (H100: 989 TF/s bf16, 3350 GB/s HBM, "
                          "450 GB/s NVLink)")
    pairs = [i for i, line in enumerate(ref_md) if line.startswith("- pairs:")]
    assert pairs and ref_md[pairs[0]] == "- pairs: 3 (expect 40 per mesh x 2 meshes = 80)"
    assert port_md[pairs[0]] == "- pairs: 3 (expect 40 on one mesh)"
    assert len(port_md) == len(ref_md)
    assert [x for i, x in enumerate(port_md) if i >= n_head and i != pairs[0]] == \
        [x for i, x in enumerate(ref_md) if i >= n_head and i != pairs[0]]
    assert "INCOMPLETE (3/40)" in capsys.readouterr().out
