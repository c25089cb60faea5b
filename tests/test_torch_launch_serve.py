"""The port's serve launcher: the continuous-batching mode's argument
checks (the JAX launcher's, the speculative flags' included), CPU runs of
``--continuous`` over the paged pool with its cold tier, plain and with a
4-bit draft of depth 4, and the card as the default device."""
import pytest
import torch

from repro_torch.launch import serve


@pytest.mark.parametrize("flags,msg", [
    (["--kv-quant-bits", "9", "--kv-block-size", "8", "--prefill-chunk", "4"], "--kv-quant-bits"),
    (["--prefill-buckets", "0"], "--prefill-buckets"),
    (["--prefill-chunk", "-1"], "must be >= 0"),
    (["--prefill-interleave", "0"], "--prefill-interleave >= 1"),
    (["--kv-block-size", "8"], "--kv-block-size requires --prefill-chunk"),
    (["--kv-quant-bits", "4"], "--kv-quant-bits requires --kv-block-size"),
    (["--draft-bits", "4", "--draft-depth", "3"], "--draft-depth requires --continuous"),
    (["--draft-depth", "2"], "needs BOTH --draft-bits >= 2 and --draft-depth >= 2"),
    (["--continuous", "--draft-bits", "9", "--draft-depth", "4"], "--draft-bits must be"),
    (["--continuous", "--draft-bits", "4"], "needs BOTH"),
    (["--continuous", "--requests", "0"], "--requests"),
    (["--wbits", "1"], "--wbits")])
def test_continuous_argument_checks(flags, msg, capsys):
    with pytest.raises(SystemExit):
        serve.parse_args(flags)
    assert msg in capsys.readouterr().err


def test_continuous_cpu_run(capsys):
    rc = serve.main(["--arch", "gpt-1.3b", "--smoke", "--device", "cpu", "--continuous",
                     "--batch", "3", "--requests", "5", "--prompt-len", "24", "--gen", "6",
                     "--temperature", "0.8", "--top-k", "40", "--prefill-chunk", "8",
                     "--prefill-buckets", "3", "--kv-block-size", "8",
                     "--kv-quant-bits", "4", "--kv-quant-horizon", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "continuous on cpu: 5 requests" in out
    assert "chunked prefill: chunk=8 buckets=(3, 5, 8)" in out
    assert "paged KV pool:" in out and "sample:" in out


def test_continuous_speculative_cpu_run(capsys):
    rc = serve.main(["--arch", "gpt-1.3b", "--smoke", "--device", "cpu", "--continuous",
                     "--batch", "3", "--requests", "5", "--prompt-len", "24", "--gen", "6",
                     "--temperature", "0.8", "--top-k", "40", "--prefill-chunk", "8",
                     "--prefill-buckets", "3", "--kv-block-size", "8",
                     "--kv-quant-bits", "4", "--kv-quant-horizon", "2",
                     "--draft-bits", "4", "--draft-depth", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "continuous on cpu: 5 requests" in out
    assert "# speculative: draft 4-bit x depth 4 -> accepted/launch" in out


def test_continuous_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "gpt-1.3b", "--smoke", "--continuous", "--requests", "2"])
