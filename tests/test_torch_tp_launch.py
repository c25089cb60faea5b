"""``launch/train.py --model-par M`` under torchrun on the CPU (gloo): the
(P, M) grid of P·M ranks, each data rank stepping its rows of every global
batch, its M model ranks the same rows; global rank 0 logs and writes the
checkpoint, gathered over both axes.  At ``--data-par 1 --model-par 2``
the losses are the library's step's on the same grid (``build_train_step``
in ranks of ``_torch_dist_common``) and the checkpoint's manifest names the
(model 2, fsdp 1) layout it loads on, block by block."""
import json
import subprocess
import sys

import _torch_dist_common as dc

FLAGS = ["--arch", dc.ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch",
         str(dc.B), "--seq", str(dc.S), "--log-every", "1"]


def test_torchrun_model_par_losses_and_checkpoint(tmp_path):
    out, ck = tmp_path / "log.json", tmp_path / "ck"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "repro_torch.launch.train", *FLAGS, "--data-par", "1", "--model-par", "2",
           "--out-json", str(out), "--ckpt", str(ck)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=240, env=dc._env())
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.count("# gpt-1.3b-smoke") == 1 and "mesh=(1,2)" in res.stdout
    assert res.stdout.count("step ") == 2, res.stdout
    losses = [e["loss"] for e in json.loads(out.read_text())["log"]]
    want = [r["losses"].tolist() for r in dc.run_ranks("tp_launch_rank", 1, tmp_path, m=2)]
    assert want[0] == want[1] == losses
    manifest = json.loads((ck / "manifest.json").read_text())
    assert manifest["mesh"] == {"model_size": 2, "fsdp_size": 1}
    from repro_torch.train.checkpoint import load_checkpoint
    halves = [load_checkpoint(str(ck), "cpu", mesh_sizes=(2, 1), model_rank=m) for m in (0, 1)]
    emb = [h.params["embed"] for h in halves]
    assert emb[0].shape == emb[1].shape and emb[0].shape[-3:-1] == (1, 1)
    # the vocab-parallel embedding's two shards differ; a norm's rows agree
    assert not bool((emb[0] == emb[1]).all())
    assert bool((halves[0].params["final_norm"] == halves[1].params["final_norm"]).all())
