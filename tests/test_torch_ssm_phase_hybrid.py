"""``chip_smoke.py``'s ssm phase, rehearsed on the CPU at zamba2-7b's smoke
config (3 Mamba2 layers, the shared attention+MLP block after the first 2):
batch serving dense and rowquant, the continuous cell with blocking
admission and the route's row gate (see ``test_torch_ssm_phase.py``)."""
import torch

from test_torch_ssm_phase import rehearse

torch.set_num_threads(1)


def test_chip_smoke_ssm_phase_rehearsal_hybrid(monkeypatch):
    rehearse("zamba2-7b", monkeypatch)
