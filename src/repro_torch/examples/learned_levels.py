"""Learned quantization levels (paper Section 5.2, Algorithm 2) end to end:
learn a 4-bit codebook for each large tensor of a model, compare the
compression error against the uniform grid, and show the wire format (the
JAX package's ``examples/learned_levels.py``).

  PYTHONPATH=src python -m repro_torch.examples.learned_levels [--device cpu]
"""
from __future__ import annotations

import argparse

from .. import configs
from ..core.levels import (LevelsConfig, compression_error, dequantize_levels,
                           learn_levels_for_tensor, quantize_levels, uniform_levels)
from ..core.qsdp import MeshSpec, QSDPConfig
from ..device import resolve_device
from ..models.transformer import Model

LEVELS = LevelsConfig(bits=4, bucket_size=1024, epochs=2, min_params=10_000)


def level_errors(params: dict, cfg: LevelsConfig = LEVELS) -> list[dict]:
    """For each tensor of at least ``cfg.min_params`` values (paper App. C:
    small layers stay uniform), in `params`' order: its relative L2
    compression error on the uniform grid and with its learned levels, the
    learned levels, and the learned code's wire shapes."""
    rows = []
    for name, w in params.items():
        if w.numel() < cfg.min_params:
            continue
        levels = learn_levels_for_tensor(w, cfg)
        uni = uniform_levels(cfg.bits, w.device)
        qu = quantize_levels(w, uni)
        ql = quantize_levels(w, levels)
        rows.append(dict(
            name=name, n=w.numel(),
            uniform=float(compression_error(w, dequantize_levels(qu, uni))),
            learned=float(compression_error(w, dequantize_levels(ql, levels))),
            levels=levels, codes_shape=tuple(ql.codes.shape),
            n_scales=ql.scale.shape[0], wire_bytes=ql.wire_bytes))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", help="its smoke config is used")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default when a card is present) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ms = MeshSpec(axes=("data", "model"), shape=(1, 1))
    model = Model(configs.get_smoke(args.arch), ms, QSDPConfig())
    params = model.init_params(args.seed, device)

    print(f"# {LEVELS.bits}-bit learned vs uniform quantization ({model.cfg.name}) on {device}")
    rows = level_errors(params)
    for r in rows:
        eu, el = r["uniform"], r["learned"]
        print(f"{r['name']:24s} n={r['n']:9d}  uniform={eu:.4f}  learned={el:.4f}  "
              f"({'better' if el < eu else 'no gain'})")
        if r["name"] == "embed":
            print(f"  learned levels: {[round(float(x), 3) for x in r['levels']]}")
            print(f"  wire: codes {r['codes_shape']} u8 (packed {LEVELS.bits}-bit) "
                  f"+ {r['n_scales']} bucket scales = {r['wire_bytes'] / 2**10:.1f} KiB "
                  f"vs {r['n'] * 4 / 2**10:.1f} KiB fp32")
    return rows


if __name__ == "__main__":
    main()
