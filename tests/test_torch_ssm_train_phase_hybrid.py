"""``chip_smoke.py``'s ssmtrain phase rehearsed on the CPU at zamba2-7b's
smoke config (3 Mamba2 layers: one group of 2 followed by the shared block,
and a one-layer tail), 8-bit moments: the launch formula with the shared
block gathered, replayed and reduce-scattered once per invocation, against
the wrappers' calls (set-up in ``test_torch_ssm_train_phase.py``)."""
from test_torch_ssm_train_phase import cs, rehearse  # noqa: F401  (fixture)


def test_chip_smoke_ssmtrain_phase_rehearsal_hybrid(cs, monkeypatch):  # noqa: F811
    counts, want, tags, text = rehearse(cs, monkeypatch, "zamba2-7b")
    assert want["per_micro"] == (23, 22, 23)
    assert want["k2_per_micro"] == (5, 4, 5)
    # update chunks: embed, final_norm, 9 shared leaves, 6 layer stacks x 3
    # slices and 6 stacks whose slices share buckets, whole; per chunk two
    # moment encodes and one decode
    assert want["moment_chunks"] == 1 + 1 + 9 + 6 * 3 + 6 == 35
    assert counts["quantize_pack"] == 3 * (2 * 68 + 2 * 35)
    assert counts["unpack_dequantize"] == 3 * (2 * 14 + 35)
    # zamba2's cell profiles no step (its by-part profile cut for the
    # run's time; moetrain and mmtrain still run profile_by_part)
    assert tags == [] and cs.SSM_TRAIN_PROFILE["zamba2-7b"] is None
    assert "8-bit moments bit-equal" in text and "1 shared-block invocations" in text
