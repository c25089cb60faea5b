"""Offline deployment-plan autotuner (the JAX package's ``tune/``).

The quant-and-schedule design space -- bits x rounding x bucket x meta
dtype x coalesce x the per-layer byte threshold, plus the serve
scheduler's knobs -- is searched offline with per-layer analytic cost
models (launch counts, wire bytes, serialization passes), the shortlist is
measured with the port's real train step on the card, and the winner is
emitted as a versioned :class:`DeploymentPlan` JSON that
``launch/train.py`` and ``launch/serve.py`` consume instead of flags.

    PYTHONPATH=src python -m repro_torch.tune.autotune --hw h100 --out PLAN.json
"""
from .cost_model import (CostParams, GatherCost, HW_PRESETS, crossover_bytes,
                         layer_gather_cost, plan_layer_policies,
                         predict_hlo_gather_counts, predict_step_time)
from .plan import PLAN_VERSION, DeploymentPlan, LayerPolicy
from .space import Candidate, enumerate_space
from .search import exhaustive_search, simulated_annealing

__all__ = [
    "PLAN_VERSION", "DeploymentPlan", "LayerPolicy",
    "CostParams", "GatherCost", "HW_PRESETS", "crossover_bytes",
    "layer_gather_cost", "plan_layer_policies", "predict_hlo_gather_counts",
    "predict_step_time",
    "Candidate", "enumerate_space",
    "exhaustive_search", "simulated_annealing",
]
