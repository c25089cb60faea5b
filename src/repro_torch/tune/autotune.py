"""Offline deployment-plan autotuner CLI (the JAX package's
``tune/autotune.py``), on one card.

    PYTHONPATH=src python -m repro_torch.tune.autotune --arch gpt-125m \\
        --hw h100 --batch 8 --seq 1024 --out PLAN.json

Pipeline:
  1. cost-model every candidate of the composed design space (per-layer
     launch counts + wire bytes + serialization terms -> predicted step
     time), including the coalesce byte-threshold cut point the model's
     crossover suggests;
  2. measure the shortlist with the port's real train step;
  3. derive the per-layer coalesce policy;
  4. emit a versioned DeploymentPlan JSON for ``launch/train.py --plan``
     and ``launch/serve.py --plan``.

Runs on the (1, 1) mesh (``--data-par``/``--model-par`` above 1 exit
naming ROADMAP A12e: the tooling over ranks), on the card unless given
``--device cpu``.  With
``--measure-top 0`` and ``--hw cpu-smoke`` the plan file is the JAX
package's, byte for byte.  ``--assert-choice per-tensor`` fails unless the
planner picks per-tensor gathers for the stacked layer group.
"""
from __future__ import annotations

import argparse
import dataclasses

from .. import configs
from ..core.qsdp import MeshSpec, QSDPConfig
from ..data import SyntheticLM, make_batch
from ..device import resolve_device
from ..models.transformer import Model
from .cost_model import (HW_PRESETS, crossover_bytes, layer_gather_cost,
                         layer_groups, plan_layer_policies, predict_step_time)
from .measure import measure_train_step
from .plan import PLAN_VERSION, DeploymentPlan
from .search import exhaustive_search, simulated_annealing
from .space import Candidate, enumerate_space


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-125m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--hw", default="h100", choices=sorted(HW_PRESETS),
                    help="cost-model hardware preset")
    ap.add_argument("--out", default="PLAN.json")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--min-quant-size", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3,
                    help="timed steps per measured shortlist candidate")
    ap.add_argument("--measure-top", type=int, default=3,
                    help="measure this many cost-model leaders (0 = trust "
                         "the model, skip measurement)")
    ap.add_argument("--full-space", action="store_true",
                    help="also search the quality-affecting axes (bits / "
                         "bucket / meta dtype)")
    ap.add_argument("--search", default="auto",
                    choices=("auto", "exhaustive", "anneal"))
    ap.add_argument("--anneal-iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8,
                    help="serve section: decode slot pool size")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prefill-buckets", type=int, default=4)
    ap.add_argument("--assert-choice", default="any",
                    choices=("any", "per-tensor", "coalesced"),
                    help="fail unless the plan's policy for the stacked "
                         "layer group matches (regression guard)")
    ap.add_argument("--device", default=None,
                    help="cuda (default when a card is present) or cpu")
    args = ap.parse_args(argv)
    if args.data_par < 1 or args.model_par < 1:
        ap.error("--data-par/--model-par must be >= 1")
    if args.data_par * args.model_par > 1:
        ap.error(f"mesh ({args.data_par},{args.model_par}): the port tunes the (1, 1) "
                 "mesh only; tuning over ranks is not ported yet (ROADMAP A12e)")
    return args


def _engine_for(mcfg, ms: MeshSpec, qcfg: QSDPConfig):
    return Model(mcfg, ms, qcfg).engine


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cp = HW_PRESETS[args.hw]
    ms = MeshSpec(axes=("data", "model"), shape=(args.data_par, args.model_par))
    mcfg = (configs.get_smoke(args.arch) if args.smoke
            else configs.get_config(args.arch))
    base_qsdp = QSDPConfig(min_quant_size=args.min_quant_size)
    base_cand = Candidate(slots=args.slots, prefill_chunk=args.prefill_chunk,
                          prefill_buckets=args.prefill_buckets)

    # -- 1. candidate space, seeded with the model's crossover threshold ----
    probe = _engine_for(mcfg, ms, dataclasses.replace(
        base_qsdp, coalesce=True, coalesce_max_bytes=None))
    groups = layer_groups(probe)
    stacked = [(g, ns) for g, ns, stack in groups if stack > 1]
    main_group, main_names = (stacked[0] if stacked
                              else (groups[0][0], groups[0][1]))
    xover = crossover_bytes(probe, main_names, cp)
    # a threshold of 0 runs the same program as per-tensor: no point
    # measuring it twice
    ths = (None, xover) if xover > 0 else (None,)
    cands = list(enumerate_space(thresholds=ths, full_space=args.full_space,
                                 base=base_cand))

    def cost_fn(cand: Candidate) -> float:
        eng = _engine_for(mcfg, ms, cand.to_qsdp(base_qsdp))
        t = predict_step_time(eng, cp, n_micro=args.n_micro)
        if cand.prefetch:
            # the pipeline's wrapped-around epilogue gather is pure overhead
            # (one extra coalesced layer gather per traversal, fwd + bwd)
            for g, ns, stack in layer_groups(eng):
                if stack > 1 and eng.layer_coalesced(tuple(ns)):
                    t += 2 * args.n_micro * layer_gather_cost(
                        eng, ns, True).time_s(cp)
        return t

    n_eval = len(cands)
    use_anneal = (args.search == "anneal"
                  or (args.search == "auto" and n_eval > 512))
    if use_anneal:
        ranked = simulated_annealing(cands, cost_fn, seed=args.seed,
                                     iters=args.anneal_iters)
    else:
        ranked = exhaustive_search(cands, cost_fn)
    print(f"# cost model ({cp.name}): {n_eval} candidates, "
          f"crossover buffer {xover} B "
          f"({'anneal' if use_anneal else 'exhaustive'})")
    for t, c in ranked[:5]:
        print(f"#   {t * 1e3:9.3f} ms  {c.label()}")

    # -- 2. measure the shortlist ------------------------------------------
    measured = {}
    winner_cost, winner = ranked[0]
    if args.measure_top > 0:
        data = SyntheticLM(vocab_size=mcfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed + 1)
        batch = make_batch(data, 0, device)
        # equal predicted cost => same program (the model is a function of
        # the induced policy); measure each program once
        shortlist, seen = [], set()
        for t, c in ranked:
            if t not in seen:
                shortlist.append((t, c))
                seen.add(t)
            if len(shortlist) == args.measure_top:
                break
        best_ms = None
        for t, c in shortlist:
            r = measure_train_step(mcfg, ms, c.to_qsdp(base_qsdp), batch,
                                   n_micro=args.n_micro, steps=args.steps,
                                   seed=args.seed, device=device)
            measured[c.label()] = {**r, "predicted_ms": t * 1e3}
            print(f"# measured {r['step_ms_median']:9.3f} ms "
                  f"(predicted {t * 1e3:9.3f})  {c.label()}")
            if best_ms is None or r["step_ms_median"] < best_ms:
                best_ms, winner, winner_cost = r["step_ms_median"], c, t

    # -- 3. per-layer coalesce policy for the winner ------------------------
    policy_eng = _engine_for(mcfg, ms, dataclasses.replace(
        winner.to_qsdp(base_qsdp), coalesce=True, coalesce_max_bytes=None))
    policies, model_thresh = plan_layer_policies(policy_eng, cp)
    if not winner.coalesce:
        # measurement vetoed coalescing outright: the thresholded policy
        # must not coalesce anything (threshold 0 if the model disagreed)
        if any(p.coalesce for p in policies):
            model_thresh = 0
            policies = [dataclasses.replace(p, coalesce=False)
                        for p in policies]
    final_qsdp = dataclasses.replace(
        winner.to_qsdp(base_qsdp), coalesce=True,
        coalesce_max_bytes=model_thresh,
        prefetch=winner.prefetch and any(
            p.coalesce for p in policies if p.group == main_group))
    final_eng = _engine_for(mcfg, ms, final_qsdp)

    # -- 4. emit ------------------------------------------------------------
    plan = DeploymentPlan(
        version=PLAN_VERSION,
        arch=mcfg.name,
        mesh_axes=ms.axes,
        mesh_shape=ms.shape,
        hw=cp.name,
        qsdp={
            "quantize_weights": final_qsdp.quantize_weights,
            "quantize_grads": final_qsdp.quantize_grads,
            "weight_bits": final_qsdp.weight_bits,
            "grad_bits": final_qsdp.grad_bits,
            "bucket_size": final_qsdp.bucket_size,
            "weight_mode": final_qsdp.weight_mode,
            "grad_mode": final_qsdp.grad_mode,
            "min_quant_size": final_qsdp.min_quant_size,
            "meta_wire_dtype": final_qsdp.meta_wire_dtype,
            "hierarchical": final_qsdp.hierarchical,
            "coalesce": final_qsdp.coalesce,
            "prefetch": final_qsdp.prefetch,
            "coalesce_max_bytes": final_qsdp.coalesce_max_bytes,
        },
        serve={
            "slots": winner.slots,
            "prefill_chunk": winner.prefill_chunk,
            "prefill_buckets": winner.prefill_buckets,
            "draft_bits": winner.draft_bits,
            "draft_depth": winner.draft_depth,
        },
        layers=tuple(policies),
        predicted={
            "step_ms": winner_cost * 1e3,
            "crossover_buffer_bytes": xover,
            "candidates_evaluated": n_eval,
            "search": "anneal" if use_anneal else "exhaustive",
        },
        measured=measured,
    )
    plan.save(args.out)
    main_co = final_eng.layer_coalesced(tuple(main_names))
    choice = "coalesced" if main_co else "per-tensor"
    print(f"# plan: {choice} gathers for group '{main_group}' "
          f"(buffer {final_eng.layer_wire_bytes(tuple(main_names))} B, "
          f"coalesce_max_bytes={final_qsdp.coalesce_max_bytes}), "
          f"prefetch={final_qsdp.prefetch} -> {args.out}")
    if args.assert_choice != "any" and choice != args.assert_choice:
        raise SystemExit(
            f"--assert-choice {args.assert_choice} failed: planner chose "
            f"{choice} gathers for '{main_group}' on mesh "
            f"({args.data_par},{args.model_par})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
