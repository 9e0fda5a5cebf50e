"""Planner smoke: prove bottleneck cuts beat (or match) quantile cuts.

Three checks, all against the SAME calibrated cost model:

1. PREDICTED (resnet/vgg/gpt tiny graphs): the DP solver's plan must
   score a bottleneck <= the greedy quantile cuts' bottleneck — the
   solver is provably optimal on its own model, so anything else is a
   solver bug.

2. MEASURED (same graphs): each cut set is deployed as an in-process
   stage-node chain (threads, real framed transport + codec) and the
   per-stage rx/infer/tx span durations are folded into the telemetry
   PR's ``LatencyHistogram``s; the measured bottleneck-stage time
   (max over stages of the slowest phase p50) for bottleneck cuts must
   be <= ``--tolerance`` x the quantile cuts' (identical cut sets short-
   circuit to equal).

3. SKEWED CHAIN (strict): a synthetic model whose FLOP midpoint sits
   exactly on a fat activation boundary — the quantile heuristic cuts
   there, shipping a ~256 KB bf8 frame per microbatch, while the comm-
   aware solver cuts one layer later at a 64-element boundary for the
   same compute balance.  The quantile chain must measure STRICTLY
   slower (wall and bottleneck-stage time, ``--min-improvement``
   margin).  This is the failure mode the planner exists to avoid.

Exit 0 on success; one JSON row on stdout (the ``plan_vs_quantile`` row
of ``benchmarks/run.py``).

The PyTorch port's copy of ``scripts/plan_smoke.py``: the same checks,
flags and row, on the port (``--device``, the card by default; the
chains' nodes and the measured node costs run there).

Usage:  python scripts/torch_plan_smoke.py [--quick] [--count N]
            [--json-out F] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import threading
import time


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)



#: the ``--device`` of this run (``main`` sets it): the chains' stage
#: programs and the measured node costs run there
DEVICE = None

#: the interpreter's thread switch interval while this process holds
#: node, codec and door threads.  On the CPU each torch op of a stage
#: program gives up the GIL and takes it back; with several of this
#: process's threads busy, taking it back waits up to the switch interval
#: (5 ms by default), a convoy that multiplies a stage's dispatch several
#: times over.  (A JAX stage is one jitted call and takes the GIL back
#: once.)  The interval is set on the card as well: a replayed stage
#: takes the GIL back once, but a frame's copies in and out, its codec
#: and its transport threads still hand it round, and the dispatch and
#: host copy of a frame take milliseconds there
#: (``scripts/torch_plan_chain_phases.py`` runs the chains at both
#: intervals).
SWITCH_INTERVAL_S = 5e-4


def pick_device(name):
    """``--device`` as the port's command line reads it (``cuda``,
    ``cuda:N``, ``cpu`` or a bare index N); the card when ``None``.
    Asked for the card where there is none, it raises.  On the CPU each
    stage runs on one intra-op thread, in this process and in the node
    processes it spawns: the nodes share the host's cores, and a torch
    thread pool per node oversubscribes them."""
    import torch

    from defer_tpu_torch.utils.config import resolve_device
    if name is not None and name.isdigit():
        name = f"cuda:{name}"
    dev = resolve_device(name)
    if dev.type == "cpu":
        torch.set_num_threads(1)
        os.environ.setdefault("OMP_NUM_THREADS", "1")
    else:
        # TF32 off, as in every node process (the command line's
        # ``_no_tf32``): this process's stages compute as the nodes' do
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def node_opts() -> dict:
    """Keyword arguments of an in-process ``StageNode`` on ``DEVICE``.

    Every node runs a window of one un-synced program (``inflight``).  A
    frame's wait in the window counts in its stage's infer latency, which
    these smokes read as the stage's service time (calibration bases,
    bottleneck stages, stragglers): with the default window of two a
    saturated stage reads about two periods, one an idle one.  On the CPU
    a stage program runs synchronously, so the window has nothing to
    overlap at all; on the card these stages are too small for the
    overlap of one frame's device work with the last one's copy to matter,
    and a window of two adds the frame's queue wait to its infer span
    there as well (``scripts/torch_plan_chain_phases.py``).
    (A JAX stage on the CPU dispatches asynchronously, and its XLA compute
    dwarfs the wait.)"""
    return {"device": DEVICE, "inflight": 1}


def skewed_graph():
    """FLOP midpoint == fat activation boundary: quantile's worst case."""
    from defer_tpu_torch.graph import GraphBuilder
    from defer_tpu_torch.graph import ops
    b = GraphBuilder("skewed")
    x = b.input((64,))
    x = b.add(ops.Dense(16384), x, name="fat")    # 64 -> 16 K elems
    x = b.add(ops.Dense(64), x, name="back")      # same FLOPs as "fat"
    b.add(ops.Dense(64), x, name="head")
    return b.build()


def run_inproc_chain(stages, params, xs, *, codec: str, warm: int = 2,
                     batch: int, opts: dict | None = None) -> dict:
    """Stream ``xs`` through an in-process thread chain; return wall
    seconds + per-stage phase summaries built from the trace spans (and
    the spans).  ``opts`` replaces :func:`node_opts` as the nodes'
    keyword arguments."""
    import numpy as np

    from defer_tpu_torch.obs import LatencyHistogram, enable_tracing, tracer
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode

    tr = enable_tracing(process="dispatcher")
    tr.start_trace()
    nodes = [StageNode(None, "127.0.0.1:0", None, **(opts or node_opts()))
             for _ in stages]
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    threads = [threading.Thread(target=n.serve, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    disp = ChainDispatcher(addrs[0], codec=codec)
    try:
        disp.deploy(stages, params, addrs, batch=batch)
        disp.stream(xs[:warm])     # compile + connect excluded
        tracer().drain()           # drop warmup spans
        t0 = time.perf_counter()
        outs = disp.stream(xs)
        wall = time.perf_counter() - t0
        spans = tracer().drain()
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=60)
    assert len(outs) == len(xs), (len(outs), len(xs))

    # fold span durations into the telemetry PR's histograms: per stage,
    # per phase (rx decode / infer / tx encode+send)
    hists: dict[tuple[int, str], LatencyHistogram] = {}
    for s in spans:
        name = s.get("name", "")
        for phase in ("rx", "infer", "tx"):
            if name.endswith(f".{phase}") and name.startswith("stage"):
                try:
                    k = int(name[len("stage"):-len(phase) - 1])
                except ValueError:
                    break
                hists.setdefault((k, phase), LatencyHistogram()).record(
                    s["dur_us"] / 1e6)
                break
    per_stage = {}
    for (k, phase), h in sorted(hists.items()):
        per_stage.setdefault(k, {})[phase] = h.summary()
    # bottleneck-stage time: the slowest phase p50 across all stages —
    # the steady-state period of the overlapped chain
    bottleneck = 0.0
    for k, phases in per_stage.items():
        for phase, summ in phases.items():
            bottleneck = max(bottleneck, summ.get("p50", 0.0))
    return {"wall_s": wall, "per_input_s": wall / len(xs),
            "bottleneck_stage_s": bottleneck, "stages": per_stage,
            "outs": outs, "spans": spans}


def compare_cuts(graph, params, plan_cuts, q_cuts, *, codec: str,
                 count: int, batch: int,
                 int_input: bool = False) -> dict:
    """Measured steady-state comparison of two cut sets on one graph."""
    import numpy as np

    from defer_tpu_torch import partition
    rng = np.random.default_rng(0)
    shape = (batch,) + tuple(graph.input_spec.shape)
    if int_input:
        xs = [rng.integers(0, 16, shape).astype(np.int32)
              for _ in range(count)]
    else:
        xs = [rng.standard_normal(shape).astype(np.float32)
              for _ in range(count)]
    r_plan = run_inproc_chain(partition(graph, list(plan_cuts)), params,
                              xs, codec=codec, batch=batch)
    if list(q_cuts) == list(plan_cuts):
        r_q = r_plan
    else:
        r_q = run_inproc_chain(partition(graph, list(q_cuts)), params,
                               xs, codec=codec, batch=batch)
    return {
        "plan_cuts": list(plan_cuts), "quantile_cuts": list(q_cuts),
        "identical_cuts": list(q_cuts) == list(plan_cuts),
        "plan_wall_s": round(r_plan["wall_s"], 4),
        "quantile_wall_s": round(r_q["wall_s"], 4),
        "plan_bottleneck_stage_ms":
            round(r_plan["bottleneck_stage_s"] * 1e3, 4),
        "quantile_bottleneck_stage_ms":
            round(r_q["bottleneck_stage_s"] * 1e3, 4),
        "_plan": r_plan, "_q": r_q,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--count", type=int, default=12,
                    help="timed microbatches per measured chain")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--skew-count", type=int, default=16)
    ap.add_argument("--skew-batch", type=int, default=8)
    ap.add_argument("--link-bw", type=float, default=1e8,
                    help="modeled hop bandwidth (1e8 = host-edge "
                         "ethernet-class, where codecs matter)")
    ap.add_argument("--tolerance", type=float, default=1.25,
                    help="measured bottleneck-stage slack for the "
                         "balanced model graphs (noise on tiny stages)")
    ap.add_argument("--min-improvement", type=float, default=1.05,
                    help="required strict measured win on the skewed "
                         "chain (quantile / bottleneck)")
    ap.add_argument("--quick", action="store_true",
                    help="predicted comparisons only (no chains)")
    ap.add_argument("--json-out", default=None, metavar="FILE")
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:N, cpu, or an index N")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = pick_device(args.device)
    sys.setswitchinterval(SWITCH_INTERVAL_S)

    import torch

    from defer_tpu_torch import models
    from defer_tpu_torch.graph.analysis import auto_cut_points
    from defer_tpu_torch.plan import (StageCostModel, calibrate_codecs,
                                evaluate_cuts, solve)

    log("calibrating host codecs (raw/lzb/bf8/bf16)...")
    codecs = calibrate_codecs(("raw", "lzb", "bf8", "bf16"))
    for n, c in codecs.items():
        log(f"  {n:5s} ratio {c.ratio:6.2f}x  "
            f"enc {c.encode_bytes_per_s / 1e6:8.1f} MB/s  "
            f"dec {c.decode_bytes_per_s / 1e6:8.1f} MB/s")

    graphs = [("resnet_tiny", models.resnet_tiny(), 4, False),
              ("vgg_tiny", models.vgg_tiny(), 4, False),
              ("gpt_tiny", models.gpt_tiny(), 4, True)]
    rows = {}
    from defer_tpu_torch.utils.profiling import measured_node_costs
    for name, g, n_stages, int_in in graphs:
        # compute side calibrated on THIS device (the analytic roofline's
        # relative weights are meaningless on a CPU host); comm side
        # calibrated above.  The quantile baseline stays the status-quo
        # default (analytic FLOPs) — that is what the planner replaces.
        params = g.init(torch.Generator().manual_seed(0))
        node_costs = measured_node_costs(g, params, batch=args.batch,
                                         k=8, reps=2, device=DEVICE)
        cm = StageCostModel(g, batch=args.batch, codecs=codecs,
                            link_bw_s=args.link_bw,
                            node_costs=node_costs)
        plan = solve(g, n_stages, cm)
        q_cuts = auto_cut_points(g, n_stages)
        q_plan = evaluate_cuts(g, q_cuts, cm, objective="quantile")
        assert plan.bottleneck_s <= q_plan.bottleneck_s * (1 + 1e-9), (
            f"{name}: solver bottleneck {plan.bottleneck_s} > quantile "
            f"{q_plan.bottleneck_s} — the DP is not optimal")
        row = {
            "predicted_plan_ms": round(plan.bottleneck_s * 1e3, 6),
            "predicted_quantile_ms": round(q_plan.bottleneck_s * 1e3, 6),
            "predicted_speedup": round(
                q_plan.bottleneck_s / plan.bottleneck_s, 4)
            if plan.bottleneck_s > 0 else None,
            "hop_codecs": plan.codecs,
        }
        log(f"{name}: predicted bottleneck {plan.bottleneck_s * 1e3:.4f} "
            f"ms (cuts {plan.cuts}) vs quantile "
            f"{q_plan.bottleneck_s * 1e3:.4f} ms (cuts {q_cuts})")
        if not args.quick:
            m = compare_cuts(g, params, plan.cuts, q_cuts, codec="raw",
                             count=args.count, batch=args.batch,
                             int_input=int_in)
            del m["_plan"], m["_q"]
            row.update(m)
            log(f"{name}: measured bottleneck-stage "
                f"{row['plan_bottleneck_stage_ms']:.3f} ms (plan) vs "
                f"{row['quantile_bottleneck_stage_ms']:.3f} ms (quantile)"
                f"{' [identical cuts]' if row['identical_cuts'] else ''}")
            assert (row["plan_bottleneck_stage_ms"]
                    <= row["quantile_bottleneck_stage_ms"]
                    * args.tolerance), (
                f"{name}: measured bottleneck-stage time for bottleneck "
                f"cuts exceeds quantile's by more than the "
                f"{args.tolerance}x noise tolerance")
        rows[name] = row

    # -- the skewed chain: quantile cuts the fat boundary, and pays ------
    g = skewed_graph()
    cm = StageCostModel(g, batch=args.skew_batch, codecs=codecs,
                        link_bw_s=args.link_bw)
    plan = solve(g, 2, cm)
    q_cuts = auto_cut_points(g, 2)
    assert q_cuts == ["fat"], f"skew setup drifted: quantile cut {q_cuts}"
    assert plan.cuts != q_cuts, (
        f"skew setup drifted: solver also cut at {plan.cuts}")
    q_plan = evaluate_cuts(g, q_cuts, cm, objective="quantile")
    skew_row = {
        "predicted_plan_ms": round(plan.bottleneck_s * 1e3, 6),
        "predicted_quantile_ms": round(q_plan.bottleneck_s * 1e3, 6),
        "plan_cuts": plan.cuts, "quantile_cuts": q_cuts,
    }
    assert plan.bottleneck_s < q_plan.bottleneck_s, \
        "skewed chain: solver did not beat quantile even on its own model"
    if not args.quick:
        params = g.init(torch.Generator().manual_seed(0))
        m = compare_cuts(g, params, plan.cuts, q_cuts, codec="bf8",
                         count=args.skew_count, batch=args.skew_batch)
        del m["_plan"], m["_q"]
        skew_row.update(m)
        wall_gain = m["quantile_wall_s"] / m["plan_wall_s"]
        stage_gain = (m["quantile_bottleneck_stage_ms"]
                      / max(m["plan_bottleneck_stage_ms"], 1e-9))
        skew_row["measured_wall_improvement"] = round(wall_gain, 4)
        skew_row["measured_bottleneck_improvement"] = round(stage_gain, 4)
        log(f"skewed: quantile wall {m['quantile_wall_s']:.3f}s vs plan "
            f"{m['plan_wall_s']:.3f}s ({wall_gain:.2f}x); bottleneck-"
            f"stage {m['quantile_bottleneck_stage_ms']:.2f} ms vs "
            f"{m['plan_bottleneck_stage_ms']:.2f} ms ({stage_gain:.2f}x)")
        assert wall_gain >= args.min_improvement, (
            f"skewed chain: bottleneck cuts only {wall_gain:.3f}x faster "
            f"by wall time (need >= {args.min_improvement}x strict win)")
        assert stage_gain >= args.min_improvement, (
            f"skewed chain: bottleneck-stage time only {stage_gain:.3f}x "
            f"better (need >= {args.min_improvement}x strict win)")
    rows["skewed"] = skew_row

    row = {"metric": "plan_vs_quantile",
           "unit": "x_quantile_over_bottleneck",
           "value": skew_row.get("measured_wall_improvement"),
           "link_bw": args.link_bw,
           "models": rows}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(row, f, indent=2, default=str)
            f.write("\n")
    print(json.dumps(row, default=str))
    log("plan smoke: OK")


if __name__ == "__main__":
    main()
