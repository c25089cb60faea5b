"""``chip_smoke.py``'s ssm phase, rehearsed on the CPU at the mamba2-370m
smoke config (2 Mamba2 layers; zamba2-7b's smoke config in
``test_torch_ssm_phase_hybrid.py``) on the card's fixed-shape route (4
lanes per launch) in the continuous cell: batch serving run twice with
equal tokens (zamba2 dense and rowquant) and the launch structure
``expected_ssm_launches`` derives; the continuous cell with blocking
admission (CONT_PLAN's 12 requests, every greedy one equal to its
batch-of-1 solo run, launches by the structure); the route's row gate at
the Mamba2 shapes.  Then the formula itself at the full configs against the
hand count.  The wrappers count only kernel launches, so the rehearsal
counts calls (``test_torch_continuous.count_calls``)."""
import torch

from test_torch_continuous import _chip_smoke, count_calls

torch.set_num_threads(1)


def rehearse(arch, monkeypatch):
    """The phase at `arch`'s smoke config, its log checked."""
    cs = _chip_smoke()
    count_calls(monkeypatch)
    lines = []
    counts = cs.ssm_phase(torch, lines.append, dev="cpu", archs=(arch,))
    text = "\n".join(lines)
    name = arch.split("-")[0] + "-smoke"
    # per step: the embedding and 5 weights per layer (K1), the embedding's
    # and one buffer per layer (K2); zamba2 smoke adds one shared invocation
    # of 7 weights in one buffer, whose MLP at bucket 1024 is not rowquant-
    # eligible at smoke widths (512 / 256 columns), so K2 gathers each alone
    runs = ({"dense": (11, 3, 0)} if arch == "mamba2-370m"
            else {"dense": (23, 5, 0), "rowquant": (23, 8, 0)})
    for kind, per_step in runs.items():
        assert f"ssm batch {name} {kind}: 2 layers" in text or \
            f"ssm batch {name} {kind}: 3 layers" in text, kind
        assert f"+ 15 x per decode step {per_step}" in text, kind
    assert (f"ssm continuous {name}: 6 greedy requests bit-equal to their batch-of-1 "
            "solo runs (['c0', 'c2', 'c3', 'c4', 'c6', 'c8'])") in text
    assert f"{name}: fixed-shape route" in text
    assert "Mamba2 decode step (out, conv ring, state) at B = 4" in text
    assert "chunk attention" not in text
    assert ("decode attention (ring 512)" in text) == (arch == "zamba2-7b")
    k1 = sum(r[0] for r in runs.values())
    assert counts["quantize_pack"] > 16 * k1 and counts["random_bits"] > 0
    assert counts.get("rowquant_matmul", 0) == 0


def test_chip_smoke_ssm_phase_rehearsal(monkeypatch):
    rehearse("mamba2-370m", monkeypatch)


def test_expected_ssm_launches_at_the_full_configs():
    """The structure's per-step counts at mamba2-370m and zamba2-7b, full
    width at the depths the phase serves (6 and 15 layers), equal the hand
    count the phase holds them to (K3 on zamba2's w_gate/w_up, its w_down
    through K2); the prefill gathers the shared MLP densely."""
    cs = _chip_smoke()
    from repro_torch.core.qsdp import MeshSpec, QSDPConfig
    from repro_torch.models.transformer import Model
    for arch in cs.SSM_ARCHS:
        cfg = cs.cut_config(arch, cs.SSM_SERVE_LAYERS[arch])
        assert cfg.n_layers == {"mamba2-370m": 6, "zamba2-7b": 15}[arch]
        model = Model(cfg, MeshSpec(("data", "model"), (1, 1)), QSDPConfig())
        for rowquant in (False, True):
            got = cs.expected_ssm_launches(model, rowquant)
            assert got == cs.expected_serve_launches(model, rowquant), (arch, rowquant)
            want = cs.SERVE_PER_STEP.get((arch, rowquant))
            if want is None:  # mamba2 has no rowquant-eligible weight
                assert got == cs.SERVE_PER_STEP[arch, False], arch
                continue
            assert got == want, (arch, rowquant)
            assert got["prefill"] == cs.SERVE_PER_STEP[arch, False]["step"], (arch, rowquant)
