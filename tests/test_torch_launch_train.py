"""``launch/train.py``'s ``--coalesce-max-bytes`` against the JAX package's
launcher: the same check (``>= 0``, 0 meaning never coalesce) and the same
``QSDPConfig`` field, which vetoes the coalesced gather of every layer
whose wire buffer exceeds it; a smoke run under the veto trains."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.launch import train as jlaunch
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
