"""Quickstart: the QSDP public API of the port in ~60 lines (the JAX
package's ``examples/quickstart.py`` on its (1, 1) mesh).

Builds a small GPT, runs a few quantized-communication training steps,
then generates tokens.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from .. import configs
from ..core import prng
from ..core.qsdp import MeshSpec, QSDPConfig
from ..data import SyntheticLM, make_batch
from ..device import resolve_device
from ..models.decode import DecodeSpec
from ..models.transformer import Model
from ..optim import AdamWConfig, make_adamw
from ..serve import ServeEngine
from ..train.step import build_train_step, init_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default when a card is present) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. mesh ("data", "model"): FSDP over data, tensor-parallel over model;
    #    this example runs one rank (launch/train.py --data-par/--model-par
    #    runs more)
    ms = MeshSpec(axes=("data", "model"), shape=(1, 1))

    # 2. the paper's technique, as config: quantize everything FSDP transmits
    qsdp = QSDPConfig(weight_bits=8, grad_bits=8, bucket_size=1024, min_quant_size=256)

    # 3. any architecture from the registry
    cfg = configs.get_smoke("gpt-125m")
    model = Model(cfg, ms, qsdp)

    # 4. train a few steps on the synthetic corpus
    opt = make_adamw(AdamWConfig(lr=1e-3))
    state = init_train_state(model, opt, 0, device)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8)
    step = build_train_step(model, opt, n_micro=2, device=device)
    losses = []
    for i in range(10):
        state, m = step(state, make_batch(data, i, device),
                        prng.fold_in(prng.PRNGKey(1), i))
        losses.append(float(m["loss"]))
        print(f"step {i}: loss={losses[-1]:.4f}")

    # 5. serve: greedy generation with quantized weight gathers
    spec = DecodeSpec(cache_len=64, batch_global=8, batch_sharded=True)
    eng = ServeEngine(model, spec, device)
    prompt, _ = data.sample(99, batch=8, seq=32)
    out = eng.generate(state.params, {"tokens": prompt.to(device)}, n_tokens=8)
    print("generated:", out[0].tolist())
    return losses, out


if __name__ == "__main__":
    main()
