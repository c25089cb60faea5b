"""The examples' one-rank twins that train (``repro_torch.examples``) run
on the CPU: ``quickstart`` (10 steps at n_micro 2 of gpt-125m's smoke
config, then ``generate``) and ``train_gpt_qsdp`` (a few steps of its
reduced-width GPT; its comm log reads 0 bytes at one rank)."""
import numpy as np
import torch

from repro_torch import configs
from repro_torch.examples import quickstart, train_gpt_qsdp

torch.set_num_threads(1)


def test_quickstart_runs(capsys):
    losses, out = quickstart.main(["--device", "cpu"])
    assert len(losses) == 10 and all(np.isfinite(losses))
    vocab = configs.get_smoke("gpt-125m").vocab_size
    assert tuple(out.shape) == (8, 8) and 0 <= int(out.min()) and int(out.max()) < vocab
    assert "generated:" in capsys.readouterr().out


def test_train_gpt_qsdp_runs(capsys):
    log = train_gpt_qsdp.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
                               "16", "--n-micro", "1"])
    assert [e["step"] for e in log] == [0, 1] and all(np.isfinite([e["loss"] for e in log]))
    # one rank: the per-device wire bytes read 0, as on the reference's (1, 1) mesh
    assert "per-device comm/step = 0.0 MiB (weights 0.0 + grads 0.0)" in capsys.readouterr().out
