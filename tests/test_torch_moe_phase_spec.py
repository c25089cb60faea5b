"""``chip_smoke.py``'s moe phase, its speculative part rehearsed on the CPU
at olmoe-1b-7b's smoke config: a 4-bit draft of depth 4 over CONT_PLAN on
the card's fixed-shape route commits every request's non-speculative
batch-of-1 solo tokens, drafts are accepted, and the launches equal the
structure's: the draft's expert stacks are 3-D wire codes that K2 decodes
with the layer's attention codes in one launch per layer, so the draft
launches no K3."""
import torch

from test_torch_continuous import _chip_smoke, count_calls

torch.set_num_threads(1)


def test_chip_smoke_moe_speculative_rehearsal(monkeypatch):
    cs = _chip_smoke()
    count_calls(monkeypatch)
    lines = []
    counts = cs.speculative_phase(torch, lines.append, dev="cpu", arch=cs.MOE_ARCH)
    text = "\n".join(lines)
    assert "commit the tokens of their non-speculative batch-of-1 solo runs" in text
    assert "speculative: olmoe-smoke, draft 4-bit x depth 4" in text and "= structure" in text
    assert counts["rowquant_matmul"] == 0 and counts["unpack_dequantize"] > 0
    assert counts["random_bits"] > 0
