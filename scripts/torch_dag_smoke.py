"""DAG-pipeline smoke: prove branch-parallel stage graphs pay.

A linear cut cannot split the parallel branches of a fork/join region
(``graph.analysis.branch_regions``), so a branching model's region body
serializes inside one stage.  The DAG planner (``plan/dag.py``) instead
mirrors the graph: a broadcast fork, one concurrent sub-pipeline per
branch, an all-paths ``(path, seq)`` join (``transport/branch.py``).
This smoke makes that win measurable on a 1-core host with the
delay-bound pattern (see torch_replication_smoke.py): the two conv branches of
inception_tiny's ``mixed_3`` reduction region each cost a fixed
simulated device delay (``node --infer-delay-ms``, sleeping — not
spinning — so concurrent branch processes overlap like real
accelerators), and the planner scores the same delays as ``node_costs``
— prediction and deployment share one cost regime.

Checks:

1. PLANNER (predictive): with uniform per-heavy-op device delays,
   ``solve_dag``'s critical-path plan STRICTLY beats the best linear
   plan's predicted bottleneck on inception_tiny and on the branched
   MoE family (``moe_branched_tiny`` — the DAG-visible formulation of
   moe_tiny's fused MoE layer, one expert per branch); on the fused
   ``moe_tiny`` itself (no separable regions) the DAG solver degrades
   to exactly the linear plan — never worse.

2. QUICK (in-process thread nodes): the two-branch delay-bound
   inception_tiny chain deployed branch-parallel
   (``ChainDispatcher.deploy_topology``) vs the best linear-cut chain
   at the SAME node count — byte-identical outputs vs the serial
   composition of the deployment's own stage programs (exact), tight
   allclose vs the fused single program, and min-of-3-streams wall
   >= ``--quick-min-speedup`` better.

3. FULL (multi-process, skipped with ``--quick``): the same comparison
   with every topology vertex as a real ``defer_tpu_torch node`` OS process
   (the deployment shape ``chain --dag`` ships), min-of-3 streams,
   measured speedup >= ``--min-speedup`` (default 1.5).  The delays
   sleep rather than burn CPU, so the win is real on a 1-core host.

Exit 0 on success; one JSON row on stdout (the ``dag_pipeline`` row of
``benchmarks/run.py``), recording planned vs linear critical path.

The PyTorch port's copy of ``scripts/dag_smoke.py``: the same checks,
flags, bounds and row, run on ``--device`` (the card by default; the node
processes it spawns run there too).

Usage:  python scripts/torch_dag_smoke.py [--quick] [--delay-ms D] [--count N]
            [--min-speedup 1.5] [--quick-min-speedup 1.45] [--device cuda|cpu]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


TINY = 1e-6   #: per-node seconds for every non-heavy op


def log(*a):
    print(*a, file=sys.stderr, flush=True)


#: the ``--device`` of this run (``main`` sets it): every stage program,
#: in this process or in a node process it spawns, runs there
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


def node_flags() -> list[str]:
    """:func:`node_opts` as a spawned node's command-line flags."""
    return ["--device", str(DEVICE)] + [
        f"--{k}={v}" for k, v in node_opts().items() if k != "device"]


def node_env() -> dict:
    """A node process's environment: this one's, with the repository on
    ``PYTHONPATH`` so ``python -m defer_tpu_torch`` finds the port."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def delay_costs(graph, heavy: dict) -> dict:
    """Uniform delay-bound cost map: ``heavy`` (node -> seconds) on the
    simulated-device ops, ``TINY`` elsewhere — the regime where both the
    planner's prediction and the deployed chain are bound by the same
    per-frame device time."""
    return {n: heavy.get(n, TINY) for n in graph.topo_order}


def two_branch_delays(graph, delay_s: float, join: str = "mixed_3"):
    """Per-node delays putting ``delay_s`` of simulated device time on
    EACH of the two conv branches of inception_tiny's ``join`` reduction
    region (the pool branch stays free): a linear stage must serialize
    2*delay_s, concurrent branch processes pay delay_s."""
    from defer_tpu_torch.graph.analysis import branch_regions
    region = next(r for r in branch_regions(graph) if r.join == join)
    heavy = {}
    for b in region.branches[:2]:
        for n in b.nodes:
            heavy[n] = delay_s / len(b.nodes)
    return region, heavy


# ---------------------------------------------------------------------------
# part 1: the planner strictly beats the linear plan on branching graphs
# ---------------------------------------------------------------------------

def planner_check(delay_s: float) -> dict:
    from defer_tpu_torch.models import inception_tiny, moe_branched_tiny, moe_tiny
    from defer_tpu_torch.plan import StageCostModel, best_linear_plan, solve_dag

    out = {}
    cases = []
    g = inception_tiny()
    _, heavy = two_branch_delays(g, delay_s)
    cases.append((g, heavy, 5))
    g = moe_branched_tiny()
    heavy = {n: delay_s for n in g.topo_order
             if n.startswith("block_") or "_e" in n}
    # 12 processes: both 4-expert regions fan out (3 trunk segments +
    # 8 expert branches); under that, the serialized experts floor both
    # planners equally
    cases.append((g, heavy, 12))
    for g, heavy, budget in cases:
        cm = StageCostModel(g, gen="v5e", link_bw_s=1e12,
                            node_costs=delay_costs(g, heavy))
        dag = solve_dag(g, cm, num_nodes=budget)
        lin = best_linear_plan(g, cm, budget)
        assert dag.bottleneck_s < lin.bottleneck_s, (
            f"{g.name}: DAG bottleneck {dag.bottleneck_s * 1e3:.3f} ms "
            f"does not strictly beat linear "
            f"{lin.bottleneck_s * 1e3:.3f} ms at {budget} nodes")
        assert dag.parallel_regions, g.name
        log(f"planner: {g.name} @ {budget} nodes: DAG "
            f"{dag.bottleneck_s * 1e3:.3f} ms (cp "
            f"{dag.critical_path_s * 1e3:.3f} ms) vs linear "
            f"{lin.bottleneck_s * 1e3:.3f} ms -> "
            f"{lin.bottleneck_s / dag.bottleneck_s:.3f}x")
        out[g.name] = {
            "budget": budget,
            "dag_bottleneck_ms": round(dag.bottleneck_s * 1e3, 4),
            "dag_critical_path_ms": round(dag.critical_path_s * 1e3, 4),
            "linear_bottleneck_ms": round(lin.bottleneck_s * 1e3, 4),
            "predicted_speedup": round(
                lin.bottleneck_s / dag.bottleneck_s, 4)}

    # the fused MoE has no separable regions: the DAG solver must
    # degrade to exactly the linear plan, never worse
    g = moe_tiny()
    cm = StageCostModel(g, gen="v5e")
    dag = solve_dag(g, cm, num_nodes=4)
    lin = best_linear_plan(g, cm, 4)
    assert not dag.parallel_regions
    assert abs(dag.bottleneck_s - lin.bottleneck_s) <= 1e-12, (
        dag.bottleneck_s, lin.bottleneck_s)
    log(f"planner: {g.name} has no separable regions -> DAG degenerates "
        f"to the linear plan ({dag.num_stages} stages), as it must")
    out[g.name] = {"degenerate_linear": True,
                   "bottleneck_ms": round(dag.bottleneck_s * 1e3, 4)}
    return out


# ---------------------------------------------------------------------------
# shared: build the two deployments (branch-parallel vs best linear)
# ---------------------------------------------------------------------------

def build_deployments(delay_s: float):
    """(graph, params, dag topology+delays, linear topology+delays).

    Both topologies come from the SAME delay-bound cost model and the
    same node budget; per-vertex delays are the summed per-node delays
    of the vertex's slice, so the deployed chains are bound by exactly
    the seconds the planner scored."""
    import torch

    from defer_tpu_torch import partition
    from defer_tpu_torch.models import inception_tiny
    from defer_tpu_torch.plan import StageCostModel, best_linear_plan, solve_dag
    from defer_tpu_torch.runtime.topology import ChainTopology

    graph = inception_tiny()
    _, heavy = two_branch_delays(graph, delay_s)
    costs = delay_costs(graph, heavy)
    cm = StageCostModel(graph, gen="v5e", link_bw_s=1e12,
                        node_costs=costs)
    budget = 5
    dag = solve_dag(graph, cm, num_nodes=budget)
    assert dag.parallel_regions, dag.to_json()
    dag_topo = ChainTopology.from_json(dag.topology_json())
    dag_delays = {v.vid: sum(heavy.get(n, 0.0) for n in v.nodes)
                  for v in dag_topo.vertices}

    lin = best_linear_plan(graph, cm, budget)
    lin_stages = partition(graph, lin.cuts if lin.num_stages > 1 else [])
    lin_topo = ChainTopology.linear(lin_stages)
    lin_delays = {v.vid: sum(heavy.get(n, 0.0) for n in v.nodes)
                  for v in lin_topo.vertices}

    params = graph.init(torch.Generator().manual_seed(0))
    pred = {"dag_bottleneck_ms": round(dag.bottleneck_s * 1e3, 4),
            "dag_critical_path_ms": round(dag.critical_path_s * 1e3, 4),
            "linear_bottleneck_ms": round(lin.bottleneck_s * 1e3, 4),
            "linear_stages": lin.num_stages, "budget": budget,
            "dag_labels": [v.label for v in dag_topo.vertices]}
    return graph, params, (dag_topo, dag_delays), \
        (lin_topo, lin_delays), pred


def min_of_3_streams(disp, xs) -> float:
    """Min wall over 3 identical streams on one live deployment (this
    1-core host jitters >15% on single streams — BASELINE lesson)."""
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        disp.stream(xs)
        walls.append(time.perf_counter() - t0)
    return min(walls)


def serial_reference(topo, stages, params, xs, batch: int):
    """Outputs of the serial composition of the deployment's OWN stage
    programs — the byte-identity reference (per-stage programs vs the
    whole graph's differ ~1e-6 in reduction order, so THIS is the exact
    contract a distributed deployment must honor)."""
    import numpy as np

    from defer_tpu_torch.utils.export import export_stage_bytes, \
        load_stage_program

    progs = [load_stage_program(export_stage_bytes(s, params, batch=batch),
                                device=DEVICE)
             for s in stages]
    graph_input = topo.entry.inputs[0]
    outs = []
    for x in xs:
        vals = {}
        for v, p in zip(topo.vertices, progs):
            ins = [x if name == graph_input else vals[name]
                   for name in v.inputs]
            vals[v.output] = p(*ins)
        outs.append(vals[topo.exit.output].cpu().numpy())
    return outs


# ---------------------------------------------------------------------------
# part 2: in-process thread chains (quick mode)
# ---------------------------------------------------------------------------

def run_inproc(graph, params, topo, delays, xs, batch: int):
    """Thread-per-vertex deployment of ``topo``; returns (outs,
    min-of-3 wall seconds, stats)."""
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode

    stages = topo.stage_specs(graph)
    nodes = [StageNode(None, "127.0.0.1:0", None, **node_opts())
             for _ in topo.vertices]
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    threads = [threading.Thread(target=n.serve, daemon=True)
               for n in nodes]
    for t in threads:
        t.start()
    disp = ChainDispatcher(addrs[0], codec="raw")
    try:
        disp.deploy_topology(topo, stages, params, addrs, batch=batch,
                             stage_delays=delays)
        outs = disp.stream(xs)      # warm: compile + connect (untimed)
        wall = min_of_3_streams(disp, xs)
        stats = disp.stats(addrs)
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=60)
    return outs, wall, stats


def quick_check(graph, params, dag_dep, lin_dep, *, count: int,
                batch: int, min_speedup: float) -> dict:
    import numpy as np

    dag_topo, dag_delays = dag_dep
    lin_topo, lin_delays = lin_dep
    rng = np.random.default_rng(0)
    in_spec = graph.out_spec(dag_topo.entry.inputs[0])
    xs = [rng.standard_normal((batch,) + in_spec.shape).astype(np.float32)
          for _ in range(count)]

    lin_outs, lin_wall, _ = run_inproc(graph, params, lin_topo,
                                       lin_delays, xs, batch)
    dag_outs, dag_wall, stats = run_inproc(graph, params, dag_topo,
                                           dag_delays, xs, batch)
    assert len(dag_outs) == len(lin_outs) == count

    # byte-identity: the branched deployment == serial composition of
    # its own stage programs, exactly
    ref = serial_reference(dag_topo, dag_topo.stage_specs(graph),
                           params, xs, batch)
    for a, b in zip(ref, dag_outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and tight allclose vs the fused single-program forward
    import torch

    from defer_tpu_torch.utils.convert import params_to_device

    # the whole graph as one program on the device (the JAX script's
    # ``jax.jit(graph.apply)``)
    dev_params = params_to_device(params, DEVICE)

    def fwd(x):
        with torch.inference_mode():
            return graph.apply(dev_params,
                               torch.from_numpy(x).to(DEVICE)).cpu().numpy()
    worst = max(float(np.abs(fwd(x) - y).max())
                for x, y in zip(xs, dag_outs))
    assert worst < 1e-4, worst

    # every branch vertex processed every frame (broadcast, not split)
    per_branch = {s.get("branch"): s.get("processed") for s in stats
                  if s.get("branch") is not None}
    warm_total = count * 4  # warm + 3 timed streams on one connection
    assert per_branch and all(v == warm_total for v in per_branch.values()
                              ), per_branch

    speedup = lin_wall / dag_wall
    log(f"quick: linear {count * batch / lin_wall:6.1f} inf/s, "
        f"branch-parallel {count * batch / dag_wall:6.1f} inf/s -> "
        f"{speedup:.3f}x (branch split {per_branch})")
    assert speedup >= min_speedup, (
        f"in-process branch-parallel speedup {speedup:.3f}x under the "
        f"{min_speedup}x bar (linear {lin_wall:.3f}s vs dag "
        f"{dag_wall:.3f}s)")
    return {"linear_s": round(lin_wall, 4), "dag_s": round(dag_wall, 4),
            "speedup": round(speedup, 4),
            "max_abs_err_vs_single_program": worst}


# ---------------------------------------------------------------------------
# part 3: multi-process deployment — the >= 1.5x measured claim
# ---------------------------------------------------------------------------

def _free_ports(n):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def timed_procs(graph, params, topo, delays, xs, *, batch: int,
                log_dir: str):
    """Every topology vertex as a real ``defer_tpu_torch node`` OS process
    (the ``chain --dag`` deployment shape): spawn, warm, min-of-3
    streams, teardown.  Returns (outs, wall_s)."""
    from defer_tpu_torch.runtime.node import (ChainDispatcher, _await_binds,
                                        _kill_procs, dag_vertex_argv)
    from defer_tpu_torch.utils.export import export_stage

    stages = topo.stage_specs(graph)
    vs = topo.vertices
    ports = _free_ports(len(vs) + 1)
    addrs = [f"127.0.0.1:{ports[i]}" for i in range(len(vs))]
    result = f"127.0.0.1:{ports[-1]}"

    argvs = []
    for v, stage in zip(vs, stages):
        path = os.path.join(log_dir, f"vertex_{v.vid}.zip")
        if not os.path.exists(path):
            export_stage(stage, params, path, batch=batch)
        argvs.append(dag_vertex_argv(v, path, addrs=addrs,
                                     result_addr=result, codec="raw",
                                     stage_delays=delays,
                                     device=str(DEVICE))
                     + node_flags()[2:])

    child_env = node_env()
    procs, logs = [], []
    labels = [v.label for v in vs]
    failed = True
    try:
        for v, argv in zip(vs, argvs):
            lf = open(os.path.join(
                log_dir, f"node_{v.label.replace('.', '_')}.log"), "w+")
            logs.append(lf)
            procs.append(subprocess.Popen(argv, env=child_env, stdout=lf,
                                          stderr=subprocess.STDOUT))
        _await_binds(procs, labels, logs, addrs,
                     proc_of=list(range(len(vs))))
        disp = ChainDispatcher(addrs[0], listen=result, codec="raw")
        try:
            outs = disp.stream(xs)   # boot+compile excluded from window
            wall = min_of_3_streams(disp, xs)
            failed = False
        finally:
            if failed:
                _kill_procs(procs)   # dead sockets make close() fast
            disp.close()
            if not failed:
                for pr in procs:
                    try:
                        pr.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        pr.kill()
    except BaseException:
        _kill_procs(procs)
        raise
    finally:
        for lf in logs:
            lf.close()
    return outs, wall


def speedup_check(graph, params, dag_dep, lin_dep, *, count: int,
                  batch: int, min_speedup: float) -> dict:
    import numpy as np

    from defer_tpu_torch.runtime.node import _BindRace

    def with_retry(**kw):
        for attempt in range(3):
            try:
                return timed_procs(**kw)
            except _BindRace as e:
                log(f"bind race on attempt {attempt + 1} ({e}); retrying")
        return timed_procs(**kw)

    dag_topo, dag_delays = dag_dep
    lin_topo, lin_delays = lin_dep
    rng = np.random.default_rng(1)
    in_spec = graph.out_spec(dag_topo.entry.inputs[0])
    xs = [rng.standard_normal((batch,) + in_spec.shape).astype(np.float32)
          for _ in range(count)]
    with tempfile.TemporaryDirectory(prefix="defer_dag_smoke_") as tmp:
        lin_dir = os.path.join(tmp, "lin")
        dag_dir = os.path.join(tmp, "dag")
        os.makedirs(lin_dir)
        os.makedirs(dag_dir)
        lin_outs, lin_wall = with_retry(
            graph=graph, params=params, topo=lin_topo, delays=lin_delays,
            xs=xs, batch=batch, log_dir=lin_dir)
        log(f"linear:          {count * batch / lin_wall:8.1f} inf/s "
            f"({lin_wall:.2f}s min-of-3)")
        dag_outs, dag_wall = with_retry(
            graph=graph, params=params, topo=dag_topo, delays=dag_delays,
            xs=xs, batch=batch, log_dir=dag_dir)
        log(f"branch-parallel: {count * batch / dag_wall:8.1f} inf/s "
            f"({dag_wall:.2f}s min-of-3)")
    assert len(dag_outs) == len(lin_outs) == count
    ref = serial_reference(dag_topo, dag_topo.stage_specs(graph),
                           params, xs, batch)
    for a, b in zip(ref, dag_outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    speedup = lin_wall / dag_wall
    assert speedup >= min_speedup, (
        f"branch-parallel speedup {speedup:.3f}x under the "
        f"{min_speedup}x bar (linear {lin_wall:.2f}s vs dag "
        f"{dag_wall:.2f}s, min-of-3)")
    return {"linear_s": round(lin_wall, 4), "dag_s": round(dag_wall, 4),
            "speedup": round(speedup, 4),
            "linear_inf_s": round(count * batch / lin_wall, 2),
            "dag_inf_s": round(count * batch / dag_wall, 2)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-speedup", type=float, default=1.5,
                    help="required dag/linear wall ratio (multi-process)")
    ap.add_argument("--quick-min-speedup", type=float, default=1.45,
                    help="required ratio for the in-process quick check "
                         "(thread scheduling noise, slightly lower bar)")
    ap.add_argument("--count", type=int, default=12,
                    help="frames per timed stream")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--delay-ms", type=float, default=40.0,
                    help="simulated device seconds per heavy branch")
    ap.add_argument("--quick", action="store_true",
                    help="planner + in-process checks only (no spawns)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:N, cpu, or an index N")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = pick_device(args.device)
    sys.setswitchinterval(SWITCH_INTERVAL_S)

    delay_s = args.delay_ms / 1e3
    r_planner = planner_check(delay_s)
    graph, params, dag_dep, lin_dep, pred = build_deployments(delay_s)
    log(f"deploying {pred['dag_labels']} vs {pred['linear_stages']} "
        f"linear stages @ {pred['budget']} nodes")
    r_quick = quick_check(graph, params, dag_dep, lin_dep,
                          count=min(args.count, 10), batch=args.batch,
                          min_speedup=args.quick_min_speedup)

    row = {"metric": "dag_pipeline", "unit": "x_vs_linear_chain",
           "model": graph.name, "count": args.count, "batch": args.batch,
           "delay_ms": args.delay_ms, "cpu_count": os.cpu_count() or 1,
           "planned": pred, "planner": r_planner, "quick": r_quick}
    if args.quick:
        row["value"] = None
    else:
        r = speedup_check(graph, params, dag_dep, lin_dep,
                          count=args.count, batch=args.batch,
                          min_speedup=args.min_speedup)
        row.update({"value": r["speedup"],
                    **{k: v for k, v in r.items() if k != "speedup"}})
    print(json.dumps(row))
    log("dag pipeline smoke: OK")


if __name__ == "__main__":
    main()
