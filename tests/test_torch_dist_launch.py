"""``launch/train.py`` under torchrun on the CPU (gloo): each rank steps its
rows of every global batch and rank 0 logs.  ``--data-par 2`` gives the
losses of the library's step over two ranks (``build_train_step`` on the
same model, state, batches and keys, in ranks of ``_torch_dist_common``);
``--data-par 1`` under torchrun gives the plain launcher's losses bit for
bit (the one-rank group against ``group=None``)."""
import json
import subprocess
import sys

import pytest

import _torch_dist_common as dc

FLAGS = ["--arch", dc.ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch",
         str(dc.B), "--seq", str(dc.S), "--log-every", "1"]


def _torchrun(p, out, tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(p), "-m", "repro_torch.launch.train", *FLAGS,
           "--data-par", str(p), "--out-json", str(out), "--ckpt", str(tmp_path / f"ck{p}")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=240, env=dc._env())
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout, [e["loss"] for e in json.loads(out.read_text())["log"]]


@pytest.mark.parametrize("p", (1, 2))
def test_torchrun_losses(p, tmp_path):
    stdout, losses = _torchrun(p, tmp_path / "log.json", tmp_path)
    # rank 0 alone prints: the header once, each step once
    assert stdout.count("# gpt-1.3b-smoke") == 1 and stdout.count("step ") == 2, stdout
    assert (tmp_path / f"ck{p}" / "manifest.json").exists()
    manifest = json.loads((tmp_path / f"ck{p}" / "manifest.json").read_text())
    assert manifest["mesh"] == {"model_size": 1, "fsdp_size": p}
    if p == 2:
        want = [r["losses"].tolist() for r in dc.run_ranks("launch_rank", 2, tmp_path)]
        assert want[0] == want[1] == losses
    else:
        out = tmp_path / "plain.json"
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *FLAGS,
                              "--out-json", str(out)], capture_output=True, text=True,
                             timeout=240, env=dc._env())
        assert res.returncode == 0, res.stderr[-4000:]
        assert [e["loss"] for e in json.loads(out.read_text())["log"]] == losses
