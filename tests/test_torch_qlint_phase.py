"""``chip_smoke.py``'s analysis phase rehearsed on the CPU at gpt-1.3b's
smoke config: the programs the speculative and train phases trace on the
card are traced here on the meta device in their place (``card_traces``,
whose launch check holds the trace's launches to the wrappers' count), the
phase traces them again on meta at the same configurations and passes
(findings and launches equal per program, nothing new against the port's
baseline), and fails when the card's findings differ.  The serving
programs also run on the CPU on the speculative phase's engine (paged pool,
sampling, draft), whose inputs they are built for."""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.analysis import trace_audit
from repro_torch.analysis.findings import Finding
from test_torch_continuous import _chip_smoke

torch.set_num_threads(1)


@pytest.fixture()
def cs(monkeypatch):
    cs = _chip_smoke()
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    monkeypatch.setitem(cs.TRAIN, "seq", 64)
    return cs


def test_chip_smoke_analysis_phase_rehearsal(cs):
    built = {}
    cs.card_traces(torch, cs.analysis_meta_programs(), built, dev="meta")
    assert set(built["card"]) == set(cs.ANALYSIS_TAGS)
    lines = []
    cs.analysis_phase(torch, lines.append, built)
    text = "\n".join(lines)
    assert "train-step[qstate]::unpack_dequantize->quantize_pack" in text
    assert "all in the baseline" in text
    for tag in cs.ANALYSIS_TAGS:
        assert f"analysis {tag}: card == meta" in text
        assert built["card"][tag].launches["quantize_pack"] > 0

    # a finding the meta twin does not make fails the phase
    hazard = Finding("QJ103", "decode_fn::index_add:float", "seeded")
    built["card"]["decode_fn"] = dataclasses.replace(built["card"]["decode_fn"],
                                                     findings=[hazard])
    with pytest.raises(cs.PhaseError, match="decode_fn"):
        cs.analysis_phase(torch, lines.append, built)


def test_serve_programs_run_on_the_speculative_engine(cs):
    """The decode, chunked-prefill and verify programs on the CPU on the
    speculative phase's engine at the smoke config: tokens for every lane,
    the verify window of the draft's depth."""
    from repro_torch.core import prng
    from repro_torch.serve import make_scheduler

    setup = cs.continuous_setup(torch, "cpu", cs.CONT_ARCH, **cs.SPEC)
    sched = make_scheduler(setup, gather_key=prng.PRNGKey(0), prefill_chunk=cs.CONT["chunk"],
                           prefill_buckets=cs.CONT["buckets"])
    progs = trace_audit.serve_programs(sched.engine, sched.params, sched.cache,
                                       prng.PRNGKey(0), cs.CONT["chunk"])
    b, k = cs.CONT["slots"], cs.SPEC["draft_depth"]
    with torch.inference_mode():
        outs = {tag: fn()[0] for tag, fn in progs.items()}
    assert outs["decode_fn"].shape == (b,) and outs["prefill_chunk_fn"].shape == (b,)
    assert outs["verify_fn"].shape == (b, k)
