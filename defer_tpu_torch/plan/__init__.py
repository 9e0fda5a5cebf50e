"""Comm-aware pipeline planning: bottleneck-minimizing cuts, per-hop
codec selection, telemetry-driven replanning.

The port of ``defer_tpu.plan``.  The quantile heuristic
(``graph.analysis.auto_cut_points``) balances per-stage compute and
ignores transport; the steady-state cost of a deployed chain is
``max_k max(compute_k, comm_k)``, so a cut at a fat-activation boundary
can make the wire the bottleneck no matter how balanced the FLOPs are.
This package solves the real objective:

* :mod:`~defer_tpu_torch.plan.cost` — :class:`StageCostModel`: roofline
  against the card's row in ``utils/hw.py`` (or measured) per-node
  compute seconds + per-cut, per-codec comm seconds, with host codec
  calibration (:func:`calibrate_codecs`).
* :mod:`~defer_tpu_torch.plan.solver` — exact DP (and a binary-search
  variant) minimizing the bottleneck, choosing the cheapest codec per
  hop, plus :func:`sweep_stages` over stage counts and the replicated
  solver.
* :mod:`~defer_tpu_torch.plan.dag` — branch-parallel stage graphs.
* :mod:`~defer_tpu_torch.plan.calibrate` — constants fitted from a
  chain's own ``stats``.
* :mod:`~defer_tpu_torch.plan.replan` — correct the model with live
  telemetry, emit a plan diff, and cut a live chain over
  (:class:`LiveReplan`).

Pure Python over the graph's metadata: the same cost inputs give the
same plans, JSON included, as the JAX package.
"""

from .calibrate import (CalibratedConstants, CalibrationError,
                        fit_constants, fit_from_stats,
                        hop_telemetry_from_stats, measure_memory_bw,
                        predict_stage_service_s)
from .cost import (CodecSpec, DEFAULT_CODECS, TIER_CODECS, StageCostModel,
                   bench_codec_instance, bench_codec_spec,
                   calibrate_codecs, max_batch_within_budget,
                   stage_ms_at_batch)
from .dag import (DagPlan, best_linear_plan, brute_force_dag,
                  dag_plan_from_json, solve_dag)
from .replan import (ReplanResult, corrected_cost_model,
                     cost_model_from_plan, measured_stage_seconds, replan)
from .solver import (Plan, ReplicatedPlan, brute_force,
                     brute_force_replicated, evaluate_cuts,
                     plan_from_json, solve, solve_replicated,
                     sweep_nodes, sweep_stages)

__all__ = [
    "CodecSpec", "DEFAULT_CODECS", "TIER_CODECS", "StageCostModel",
    "bench_codec_instance", "bench_codec_spec", "calibrate_codecs",
    "Plan", "solve", "evaluate_cuts", "sweep_stages", "brute_force",
    "ReplicatedPlan", "solve_replicated", "brute_force_replicated",
    "sweep_nodes", "plan_from_json",
    "DagPlan", "solve_dag", "brute_force_dag", "dag_plan_from_json",
    "best_linear_plan",
    "ReplanResult", "replan", "measured_stage_seconds",
    "corrected_cost_model", "cost_model_from_plan",
    "max_batch_within_budget", "stage_ms_at_batch",
    "CalibratedConstants", "CalibrationError", "fit_constants",
    "fit_from_stats", "hop_telemetry_from_stats", "measure_memory_bw",
    "predict_stage_service_s",
]
