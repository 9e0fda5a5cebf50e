"""Where an in-process chain of the plan smoke spends a frame, phase by phase.

``scripts/torch_plan_smoke.py`` measures each cut set as an in-process
chain of stage nodes (threads in one process) and reads the slowest
phase p50 as the chain's bottleneck-stage time.  This script runs the
same chains through that script's ``run_inproc_chain`` and prints every
stage's p50 of each node span phase: ``rx`` (a frame's receive, its wait
for the frame included), ``dispatch`` (the stage program's call; on the
card the replay of its capture, the inputs' copy in), ``queue`` (the
frame's wait in the node's window), ``device`` (the wait on its CUDA
event), ``host_sync`` (the output's copy to the host), ``infer``
(dispatch to synced) and ``tx``.

The chains: resnet_tiny at batch 4 on raw hops, at two cut sets (the
plan smoke's solver chose the first on an H100, the second is the
quantile cuts), and the smoke's skewed graph at batch 8 on bf8 hops, cut
at ``back`` (the solver's) and at ``fat`` (quantile's).  Each runs under
the node window (``inflight``) 1 and 2 and the interpreter's switch
interval 0.5 ms and 5 ms, the settings the smokes fix and the defaults.
One JSON line per chain and setting on stdout, the lines also in
``--json-out``.  ``--profile FILE`` then streams the first chain once
more (window 1, 0.5 ms) under ``torch.profiler``, writes its table of
operators and runtime calls to FILE and prints, as a last JSON line, the
count and mean host time of each CUDA runtime call of that stream.

Usage:  python scripts/torch_plan_chain_phases.py [--device cuda|cpu]
            [--json-out FILE] [--profile FILE]
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

RESNET_CUTS = {"solver": ["conv2d", "batchnorm", "add_1"],
               "quantile": ["conv2d", "maxpool", "activation_6"]}
SKEW_CUTS = {"solver": ["back"], "quantile": ["fat"]}
#: (inflight, switch interval in seconds)
SETTINGS = ((1, 5e-4), (1, 5e-3), (2, 5e-4), (2, 5e-3))


def _plan_smoke():
    spec = importlib.util.spec_from_file_location(
        "torch_plan_smoke", os.path.join(HERE, "torch_plan_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_p50s(spans) -> dict:
    """``{"stageK.phase": p50 ms}`` over the node spans of one stream."""
    per: dict[str, list] = {}
    for s in spans:
        name = s.get("name", "")
        if name.startswith("stage"):
            per.setdefault(name, []).append(s["dur_us"] / 1e3)
    return {k: round(statistics.median(v), 4) for k, v in sorted(per.items())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:N, cpu, or an index N")
    ap.add_argument("--json-out", default=None, metavar="FILE")
    ap.add_argument("--profile", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    plan = _plan_smoke()
    plan.DEVICE = plan.pick_device(args.device)

    import numpy as np
    import torch

    from defer_tpu_torch import models, partition

    chains = [("resnet_tiny", models.resnet_tiny(), RESNET_CUTS, "raw", 4, 12),
              ("skewed", plan.skewed_graph(), SKEW_CUTS, "bf8", 8, 16)]
    interval = sys.getswitchinterval()
    rows = []
    try:
        for name, g, cut_sets, codec, batch, count in chains:
            params = g.init(torch.Generator().manual_seed(0))
            rng = np.random.default_rng(0)
            shape = (batch,) + tuple(g.input_spec.shape)
            xs = [rng.standard_normal(shape).astype(np.float32)
                  for _ in range(count)]
            for inflight, switch_s in SETTINGS:
                sys.setswitchinterval(switch_s)
                for which, cuts in cut_sets.items():
                    r = plan.run_inproc_chain(
                        partition(g, list(cuts)), params, xs, codec=codec,
                        batch=batch,
                        opts={"device": plan.DEVICE, "inflight": inflight})
                    row = {"chain": name, "cuts": which, "cut_names": cuts,
                           "codec": codec, "batch": batch, "frames": count,
                           "inflight": inflight,
                           "switch_interval_ms": switch_s * 1e3,
                           "wall_ms_per_frame": round(
                               r["wall_s"] / count * 1e3, 4),
                           "bottleneck_stage_ms": round(
                               r["bottleneck_stage_s"] * 1e3, 4),
                           "p50_ms": phase_p50s(r["spans"])}
                    print(json.dumps(row), flush=True)
                    rows.append(row)
    finally:
        sys.setswitchinterval(interval)
    if args.json_out:
        with open(args.json_out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    if args.profile:
        print(json.dumps(profile_chain(plan, chains[0], args.profile)),
              flush=True)


def profile_chain(plan, chain, path: str) -> dict:
    """Stream ``chain`` once (window 1, 0.5 ms) under ``torch.profiler``;
    write the operator table to ``path``; return each CUDA runtime
    call's count and mean host microseconds."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from defer_tpu_torch import partition

    name, g, cut_sets, codec, batch, count = chain
    params = g.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((batch,) + tuple(g.input_spec.shape))
          .astype(np.float32) for _ in range(count)]
    acts = [ProfilerActivity.CPU]
    if plan.DEVICE.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    try:
        # every thread's operators, and the runtime's syncs as events
        config = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True, enable_cuda_sync_events=True)
    except TypeError:
        config = None
    interval = sys.getswitchinterval()
    sys.setswitchinterval(5e-4)
    try:
        with profile(activities=acts, experimental_config=config) as prof:
            r = plan.run_inproc_chain(
                partition(g, list(cut_sets["solver"])), params, xs,
                codec=codec, batch=batch,
                opts={"device": plan.DEVICE, "inflight": 1})
    finally:
        sys.setswitchinterval(interval)
    avgs = prof.key_averages()
    with open(path, "w") as f:
        f.write(avgs.table(sort_by="cpu_time_total", row_limit=60))
    calls = {e.key: {"count": e.count,
                     "mean_us": round(e.cpu_time_total / e.count, 2)}
             for e in avgs if e.key.startswith("cuda") and e.count}
    return {"chain": name, "cuts": "solver", "profiled": True,
            "wall_ms_per_frame": round(r["wall_s"] / count * 1e3, 4),
            "runtime_calls": calls}


if __name__ == "__main__":
    main()
