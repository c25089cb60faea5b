"""End to end: pre-train a GPT with QSDP for a few hundred steps on
the synthetic corpus, logging loss + communication savings (the JAX
package's ``examples/train_gpt_qsdp.py`` on its (1, 1) mesh).

Default is a small run (reduced width, 300 steps); pass --full-width for
the real gpt-125m geometry.  At one rank the per-device wire bytes read 0,
as on the reference's (1, 1) mesh: a gather of one shard receives nothing.

  PYTHONPATH=src python -m repro_torch.examples.train_gpt_qsdp --steps 300 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from .. import configs
from ..core import prng
from ..core.qsdp import MeshSpec, QSDPConfig, step_comm_bytes
from ..data import SyntheticLM, make_batch
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import Model
from ..optim import AdamWConfig, cosine_schedule, make_adamw
from ..train.checkpoint import save_checkpoint
from ..train.step import build_train_step, init_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--n-micro", type=int, default=4)  # paper: 4 accumulations
    ap.add_argument("--baseline", action="store_true")
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default when a card is present) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ms = MeshSpec(axes=("data", "model"), shape=(1, 1))

    if args.full_width:
        cfg = configs.get_config("gpt-125m")
    else:  # ~8M params: same depth-ish shape, CPU-trainable
        cfg = ModelConfig(name="gpt-mini", arch_type="dense", n_layers=4,
                          d_model=384, vocab_size=8192, n_heads=8, n_kv_heads=8,
                          head_dim=48, d_ff=1024, rope_theta=10_000.0)

    qsdp = QSDPConfig.baseline() if args.baseline else QSDPConfig(min_quant_size=1024)
    model = Model(cfg, ms, qsdp)
    comm = step_comm_bytes(model.engine, gathers_per_param=2 * args.n_micro,
                           reduces_per_param=args.n_micro)
    print(f"# {cfg.name}: {cfg.n_params() / 1e6:.1f}M params, "
          f"{'baseline FSDP' if args.baseline else 'QSDP W8G8'} on {device}; "
          f"per-device comm/step = {comm['total'] / 2**20:.1f} MiB "
          f"(weights {comm['weight_gather'] / 2**20:.1f} + grads "
          f"{comm['grad_reduce'] / 2**20:.1f})")

    opt = make_adamw(AdamWConfig(lr=6e-4, schedule=cosine_schedule(6e-4, 20, args.steps)))
    state = init_train_state(model, opt, 0, device)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    step = build_train_step(model, opt, n_micro=args.n_micro, device=device)
    log = []
    t0 = time.time()
    for i in range(args.steps):
        state, m = step(state, make_batch(data, i, device),
                        prng.fold_in(prng.PRNGKey(1), i))
        if i % 20 == 0 or i == args.steps - 1:
            log.append(dict(step=i, loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
                            t=time.time() - t0))
            print(f"step {i:4d} loss {log[-1]['loss']:7.4f} "
                  f"gnorm {log[-1]['gnorm']:7.3f} ({log[-1]['t']:6.1f}s)")
    if args.ckpt:
        save_checkpoint(args.ckpt, state, meta=dict(arch=cfg.name, steps=args.steps))
        print("checkpoint ->", args.ckpt)
    return log


if __name__ == "__main__":
    main()
