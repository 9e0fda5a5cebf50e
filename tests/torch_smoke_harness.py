"""Runs the port's smoke scripts (``scripts/torch_<name>_smoke.py``) and
their JAX twins (``scripts/<name>_smoke.py``) as subprocesses, and reads
the JSON row each prints as its last line of standard output.

``ROWS`` holds each smoke's row metric and the keys of its JAX script's
row in quick mode (the full mode adds keys); ``CLOCK_FREE`` the dotted
paths of the row's fields that no clock decides (cut lists, tier maps,
counts, verdicts), which the port and the JAX script must print alike on
the same inputs.  Imports neither JAX nor the JAX package, so the tests
on the card use it too.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"

#: the smokes without a ``--quick`` flag: their one mode is the quick one
NO_QUICK = ("metrics",)

#: per smoke: (row metric, the keys of the JAX script's quick row)
ROWS = {
    "plan": ("plan_vs_quantile",
             {"metric", "unit", "value", "link_bw", "models"}),
    "replication": ("stage_replication",
                    {"metric", "unit", "stages", "replicas", "count",
                     "batch", "delay_ms", "cpu_count", "quick", "solver",
                     "value"}),
    "monitor": ("obs_overhead",
                {"metric", "value", "unit", "quick", "count", "batch",
                 "delay_ms", "interval_ms", "wall_off_s", "wall_on_s",
                 "bottleneck", "straggler", "replan_argmax_stage",
                 "monitor_frames", "first_flag_frame", "sampled_waterfalls",
                 "min_waterfall_gap_us", "clock_offset_us", "cpu_count"}),
    "colocate": ("colocated_fastpath",
                 {"metric", "unit", "stages", "hop_tiers", "count", "batch",
                  "delay_ms", "cpu_count", "quick", "fused", "planner",
                  "value"}),
    "shm": ("shm_fastpath",
            {"metric", "unit", "stages", "hop_tiers", "count", "batch",
             "delay_ms", "cpu_count", "quick", "fallback", "planner",
             "value"}),
    "serve": ("serving_frontdoor",
              {"metric", "unit", "tenants", "width", "delay_ms",
               "per_tenant", "mode", "value", "byte_identical",
               "sequential_wall_s", "batched_wall_s", "samples_per_s",
               "slo_ms", "trace", "shed_p99_ms", "shed_rate",
               "noshed_p99_ms", "decode_tokens_per_s", "decode_speedup"}),
    "request_obs": ("request_attribution",
                    {"metric", "unit", "mode", "width", "delay_ms",
                     "sample_every", "value", "overhead_frac", "wall_off_s",
                     "wall_on_s", "burst", "sampled_requests", "p50_attrib",
                     "p99_attrib", "events", "trace_procs", "cpu_count"}),
    "chaos": ("pipeline_failover",
              {"metric", "value", "unit", "elapsed_s", "byte_identical",
               "count", "failovers", "replayed", "recovery_ms", "wall_s",
               "replan_byte_identical", "cutover_ms", "quiesced",
               "old_cuts", "new_cuts"}),
    "dag": ("dag_pipeline",
            {"metric", "unit", "model", "count", "batch", "delay_ms",
             "cpu_count", "planned", "planner", "quick", "value"}),
    "capacity": ("cost_model_truth",
                 {"metric", "value", "unit", "quick", "count", "batch",
                  "delay_ms", "bottleneck", "measured_ms",
                  "pred_calibrated_ms", "pred_default_ms", "err_default",
                  "drift", "monitor_frames", "overhead", "wall_off_s",
                  "wall_on_s", "calibration", "cpu_count"}),
    "profile": ("profile_overhead",
                {"metric", "value", "unit", "quick", "count", "batch",
                 "delay_ms", "wall_off_s", "wall_on_s", "phase_sums",
                 "recompiles_injected", "recompile_events",
                 "registry_compiles", "cpu_count"}),
    "decode_profile": ("decode_profile",
                       {"metric", "value", "unit", "recompiles_steady",
                        "recompile_events_steady", "warmup_compiles",
                        "first_call_s", "wall_s", "dispatches",
                        "chunk_steps", "dispatch_share", "config",
                        "cpu_count"}),
    "postmortem": ("blackbox_overhead",
                   {"metric", "value", "unit", "quick", "elapsed_s",
                    "byte_identical", "count", "journals", "first_fault",
                    "casualties", "respawn_gap_s", "events_dropped",
                    "auto_bundle", "timeline_events", "wall_off_s",
                    "wall_on_s", "spilled_records"}),
    "chain_overlap": ("chain_overlap",
                      {"metric", "unit", "stages", "codec", "batch",
                       "count", "cpu_count", "overlap_wall_vs_phase_sum",
                       "value"}),
    "metrics": ("metrics_smoke",
                {"metric", "value", "unit", "spans", "push_p99_ms", "trace",
                 "metrics"}),
}

#: per smoke: the dotted paths of its row's clock-free fields
CLOCK_FREE = {
    "plan": ("metric", "unit", "value", "link_bw",
             "models.skewed.plan_cuts", "models.skewed.quantile_cuts"),
    "replication": ("stages", "replicas", "count", "batch", "delay_ms",
                    "value", "solver.replicas", "solver.cuts",
                    "solver.replicated_stage",
                    "solver.cuts_only_bottleneck_ms",
                    "solver.hybrid_bottleneck_ms",
                    "solver.predicted_speedup", "quick.replica_split"),
    "monitor": ("quick", "count", "batch", "delay_ms", "interval_ms",
                "bottleneck", "straggler.stage", "straggler.reason",
                "straggler.intervals", "replan_argmax_stage",
                "monitor_frames"),
    "colocate": ("stages", "hop_tiers", "count", "batch", "delay_ms",
                 "value", "quick.tiers", "fused.stages",
                 "fused.local_frames", "planner"),
    "shm": ("stages", "hop_tiers", "count", "batch", "delay_ms", "value",
            "quick.tiers", "fallback", "planner"),
    "serve": ("tenants", "width", "delay_ms", "per_tenant", "mode",
              "byte_identical", "slo_ms", "trace"),
    "request_obs": ("mode", "width", "delay_ms", "sample_every",
                    "burst.offered", "burst.slo_ms", "events.dropped"),
    "chaos": ("byte_identical", "count", "failovers",
              "replan_byte_identical", "quiesced", "old_cuts", "new_cuts"),
    "dag": ("model", "count", "batch", "delay_ms", "planned", "planner"),
    "capacity": ("quick", "count", "batch", "delay_ms", "bottleneck",
                 "drift.stage", "drift.intervals", "monitor_frames"),
    "profile": ("quick", "count", "batch", "delay_ms", "recompile_events"),
    "decode_profile": ("recompiles_steady", "recompile_events_steady",
                       "dispatches", "chunk_steps", "config"),
    "postmortem": ("quick", "byte_identical", "count", "first_fault",
                   "auto_bundle"),
    "chain_overlap": ("stages", "codec", "batch", "count", "value"),
    "metrics": ("metric", "value", "unit"),
}


def script(name: str, *, jax: bool = False) -> Path:
    return SCRIPTS / (f"{name}_smoke.py" if jax else f"torch_{name}_smoke.py")


def run(name: str, *, jax: bool = False, quick: bool = True,
        device: str = "cpu", timeout: float = 300.0,
        extra: tuple = ()) -> tuple[dict, float]:
    """Run one smoke as a subprocess from the repository's root and return
    (its last line's JSON row, its seconds).  The port's script gets
    ``--device``; a non-zero exit raises with the script's stderr tail."""
    argv = [sys.executable, str(script(name, jax=jax))]
    if quick and name not in NO_QUICK:
        argv.append("--quick")
    if not jax:
        argv += ["--device", device]
    argv += list(extra)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    out = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    assert out.returncode == 0, (
        f"{' '.join(argv[1:])} exited {out.returncode} after "
        f"{seconds:.1f} s:\n{out.stderr[-8000:]}")
    lines = out.stdout.strip().splitlines()
    assert lines, f"{script(name, jax=jax).name} printed nothing"
    return json.loads(lines[-1]), seconds


def field(row: dict, path: str):
    """The value at a dotted path of a row (``models.skewed.plan_cuts``)."""
    v = row
    for part in path.split("."):
        v = v[part]
    return v


def check_row(name: str, row: dict, *, quick: bool = True) -> None:
    """The row's metric is its JAX script's; in quick mode its keys are the
    JAX row's keys, in the full mode they include them."""
    metric, keys = ROWS[name]
    assert row.get("metric") == metric, (name, row.get("metric"))
    if quick or name in NO_QUICK:
        assert set(row) == keys, (name, sorted(set(row) ^ keys))
    else:
        assert keys <= set(row), (name, sorted(keys - set(row)))


def clock_free(name: str, row: dict) -> dict:
    return {p: field(row, p) for p in CLOCK_FREE[name]}
