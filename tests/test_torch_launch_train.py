"""``launch/train.py``'s ``--coalesce-max-bytes`` against the JAX package's
launcher: the same check (``>= 0``, 0 meaning never coalesce) and the same
``QSDPConfig`` field, which vetoes the coalesced gather of every layer
whose wire buffer exceeds it; a smoke run under the veto trains.  The VLM
and audio families exit with an error that says why: the corpus gives
tokens and labels only, and the JAX launcher, fed the same corpus, fails
in its ``loss_fn`` for want of the modality inputs."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core.qsdp import MeshSpec as JMeshSpec, QSDPConfig as JQSDPConfig
from repro.compat import shard_map
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.launch import train as jlaunch
from repro.models.transformer import Model as JModel
from repro_torch import configs
from repro_torch.core.qsdp import MeshSpec
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import Model

torch.set_num_threads(1)


@pytest.mark.parametrize("value", ["-1", "-4096"])
def test_coalesce_max_bytes_must_not_be_negative(value, capsys):
    for launcher in (launch_train, jlaunch):
        with pytest.raises(SystemExit):
            launcher.parse_args(["--coalesce-max-bytes", value])
        assert "--coalesce-max-bytes must be >= 0 (0 = never coalesce)" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [[], ["--coalesce-max-bytes", "0"],
                                   ["--coalesce-max-bytes", "500000"],
                                   ["--coalesce-max-bytes", "4096", "--no-coalesce"]])
def test_coalesce_max_bytes_builds_the_reference_config(flags):
    q = launch_train.build_qsdp(launch_train.parse_args(flags))
    jq = jlaunch.build_qsdp(jlaunch.parse_args(flags))
    ported = {f.name for f in dataclasses.fields(q)}
    assert {k: v for k, v in dataclasses.asdict(jq).items() if k in ported} \
        == dataclasses.asdict(q)
    assert q.coalesce_max_bytes == (int(flags[1]) if flags else None)
    # zamba2's smoke Mamba2 layer ships 420,640 bytes, its shared block
    # 662,528: 500,000 coalesces the one and vetoes the other
    model = Model(configs.get_smoke("zamba2-7b"), MeshSpec(("data", "model"), (1, 1)), q)
    for prefix in ("layers/", "shared/"):
        names = tuple(sorted(n for n in model.specs if n.startswith(prefix)))
        assert model.engine.layer_coalesced(names) == (
            q.coalesce and (q.coalesce_max_bytes is None
                            or model.engine.layer_wire_bytes(names) <= q.coalesce_max_bytes))
        assert model.engine.layer_wire_bytes(names) == {"layers/": 420_640,
                                                        "shared/": 662_528}[prefix]


def test_train_launcher_under_the_veto(tmp_path, capsys):
    out_json = tmp_path / "log.json"
    rc = launch_train.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu", "--steps", "1",
                            "--batch", "2", "--seq", "16", "--coalesce-max-bytes", "0",
                            "--out-json", str(out_json)])
    out = capsys.readouterr().out
    assert rc == 0 and "coalesce<=0B" in out
    assert np.isfinite(json.loads(out_json.read_text())["log"][0]["loss"])


@pytest.mark.parametrize("arch,inputs", [("qwen2-vl-72b", "vision_embeds, vision_mask and "
                                          "M-RoPE positions"),
                                         ("seamless-m4t-large-v2", "audio_embeds")])
def test_modality_families_refused_with_reason(arch, inputs, capsys, mesh11):
    for argv in (["--arch", arch], ["--arch", arch, "--smoke", "--device", "cpu"]):
        with pytest.raises(SystemExit) as e:
            launch_train.parse_args(argv)
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert f"--arch {arch}: a {configs.get_config(arch).arch_type} model trains on " \
               f"batches that carry {inputs}" in err
    # the JAX launcher's batch: the corpus's tokens and labels, which its
    # loss_fn cannot train on
    cfg = jconfigs.get_smoke(arch)
    tokens, labels = JSyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2,
                                  seed=0).sample(0)
    jm = JModel(cfg, JMeshSpec(("data", "model"), (1, 1)), JQSDPConfig())
    loss = shard_map(lambda p, b: jm.loss_fn(p, b, jax.random.PRNGKey(1)), mesh=mesh11,
                     in_specs=(P(), P()), out_specs=P(), check_vma=False)
    with pytest.raises(KeyError):
        loss(jm.init_params(jax.random.PRNGKey(0)), {"tokens": tokens, "labels": labels})
