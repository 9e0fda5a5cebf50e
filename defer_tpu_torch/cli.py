"""Command line of the port: the stage-node process chain and the planner.

    python -m defer_tpu_torch node --listen :5000 [--device cpu]
    python -m defer_tpu_torch chain --model resnet_tiny --stages 3 \\
        [--in-band] [--codec lzb] [--device cpu] [--emit-calibration F]
    python -m defer_tpu_torch plan --model resnet50 --stages 8 \\
        [--measured] [--calibrated F] [--json]
    python -m defer_tpu_torch partition --model resnet_tiny --stages 3 \\
        [--balance flops|measured|bottleneck] [--json]

``node`` boots one stage node (empty, to be deployed in-band, or from an
``--artifact`` file with its ``--next`` hop) and serves until its stream
ends; each ``--co-stage`` boards one more stage node on a thread of the
same process, so the hops between them can take the in-process transport
tiers.  ``chain`` spawns the node processes of a model's stages on this
host, streams seeded random inputs through them with
:func:`~defer_tpu_torch.runtime.node.run_chain`, and prints one JSON row:
inferences/s, each hop's negotiated tier and the largest difference from
the whole-graph forward; ``--emit-calibration`` fits the planner's
constants from the chain's own ``stats`` and saves them.  ``plan`` solves
the comm-aware bottleneck partition (``plan/``) against the quantile
baseline on the same cost model, and ``partition`` prints the stage table
(or its JSON) for explicit or automatic cuts; both print the JAX
package's documents for the same flags.

These are four of the JAX package's subcommands (``defer_tpu/cli.py``);
the others come with ROADMAP item A17.  Nodes, and the per-node timing of
``--measured``/``--balance measured``, run on the CUDA card unless
``--device cpu`` is given; a float32 stage runs without TF32 (cuBLAS and
cuDNN), so its rows match the float32 forward.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _get_model(name: str):
    from . import models
    if not hasattr(models, name):
        raise SystemExit(
            f"unknown model {name!r}; see defer_tpu_torch.models.__all__")
    return getattr(models, name)()


def _no_tf32() -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _parse_co_stage(spec: str) -> dict:
    """``listen=ADDR[;artifact=P][;next=A][;codec=C][;tier=T][;accept=0|1]
    [;device=J]`` -> dict.  The grammar uses ``;`` separators because a
    ``next`` value may itself be a comma list.  ``accept`` says whether
    this housemate grants inbound tier offers (default: its own ``tier``
    is not tcp), apart from its outbound policy: a stage whose next hop
    leaves the process may still be the in-process target of its
    upstream housemate."""
    kv = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        k, sep, v = part.partition("=")
        if not sep:
            raise SystemExit(f"--co-stage: {part!r} is not key=value")
        kv[k.strip()] = v.strip()
    if "listen" not in kv:
        raise SystemExit(f"--co-stage {spec!r} needs listen=host:port")
    bad = set(kv) - {"listen", "artifact", "next", "codec", "tier",
                     "accept", "device"}
    if bad:
        raise SystemExit(f"--co-stage: unknown keys {sorted(bad)}")
    if kv.get("accept") not in (None, "0", "1"):
        raise SystemExit(f"--co-stage: accept must be 0|1, "
                         f"got {kv['accept']!r}")
    if "device" in kv:
        try:
            kv["device"] = int(kv["device"])
        except ValueError:
            raise SystemExit(f"--co-stage: device must be an integer "
                             f"CUDA device index, got {kv['device']!r}")
    return kv


def _device_arg(v: str | None):
    """``--device``: ``cuda``, ``cuda:N``, ``cpu``, or a bare index ``J``
    meaning ``cuda:J``."""
    return int(v) if v is not None and v.isdigit() else v


def cmd_node(args) -> None:
    import threading
    import traceback

    from .runtime.node import StageNode
    from .transport.framed import _codec

    _codec(args.codec)  # loud at boot, not when the first tensor relays
    specs = [_parse_co_stage(c) for c in args.co_stage or []]
    for kv in specs:
        _codec(kv.get("codec", "raw"))
    _no_tf32()

    def boot(artifact, listen, nxt, codec, tier, accept, device,
             primary):
        # --fan-in/--replica (and the branch roles --fan/--branch/--join)
        # describe the primary node's place in a fan; housemates sit on
        # in-process hops, which never touch a fan, so they take none
        node = StageNode(artifact, listen, nxt,
                         codec=codec, overlap=not args.no_overlap,
                         rx_depth=args.rx_depth, tx_depth=args.tx_depth,
                         inflight=args.inflight,
                         fan_in=args.fan_in if primary else 1,
                         replica=args.replica if primary else None,
                         fan_mode=args.fan if primary else "rr",
                         branch=args.branch if primary else None,
                         join_in=args.join if primary else 0,
                         infer_delay_s=args.infer_delay_ms / 1e3
                         if primary else 0.0,
                         tier=tier, tier_accept=accept, device=device,
                         failover=args.failover, persist=args.persist)
        m = node.manifest
        what = (f"stage {m['index']} ({m['name']})" if m
                else "EMPTY (awaiting in-band deploy)")
        if node.replica is not None:
            what += f" replica {node.replica}"
        if node.branch is not None:
            what += f" branch {node.branch}"
        if node.join_in >= 2:
            what += f" join {node.join_in}"
        if node.fan_in > 1:
            what += f" fan-in {node.fan_in}"
        # the bind's wall-clock time rides the line, so a spawner that
        # times a respawn tells the bind from the boot that follows it
        print(f"node: {what} on {node.device} listening on "
              f"{node.address[0]}:{node.address[1]}, next {nxt}"
              f"{' [serial]' if args.no_overlap else ''}, bound at "
              f"{node.bound_at:.6f}", file=sys.stderr, flush=True)
        return node

    accept = (args.tier != "tcp") if args.tier_accept == "auto" \
        else args.tier_accept == "1"
    device = _device_arg(args.device)
    node = boot(args.artifact, args.listen, args.next, args.codec,
                args.tier, accept, device, True)
    # each --co-stage boards this process as its own serve thread: the
    # hops between housemates negotiate the in-process tiers
    co = [boot(kv.get("artifact"), kv["listen"], kv.get("next"),
               kv.get("codec", "raw"), kv.get("tier", args.tier),
               kv["accept"] == "1" if "accept" in kv
               else kv.get("tier", args.tier) != "tcp",
               kv.get("device", device), False)
          for kv in specs]
    counts: dict[int, int] = {}

    def serve_co(i: int):
        try:
            counts[i] = co[i].serve(connect_timeout_s=args.connect_timeout)
        except BaseException:  # noqa: BLE001 — a dead co-stage kills the
            # process, so the parent sees one attributed failure instead
            # of a wedged chain
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)

    threads = [threading.Thread(target=serve_co, args=(i,), daemon=True)
               for i in range(len(co))]
    for t in threads:
        t.start()
    n = node.serve(connect_timeout_s=args.connect_timeout)
    # the process exits once every housemate's stream has drained
    for t in threads:
        t.join()
    n += sum(counts.values())
    print(f"node: served {n} tensors; chain drained", file=sys.stderr)


def cmd_chain(args) -> None:
    import numpy as np
    import torch

    from . import models, partition
    from .runtime.node import run_chain
    from .utils.config import resolve_device
    from .utils.convert import params_to_device

    graph = _get_model(args.model)
    params = graph.init(torch.Generator().manual_seed(0))
    if args.dag or args.topology:
        _cmd_chain_dag(args, graph, params)
        return
    cuts = args.cuts.split(",") if args.cuts else None
    stages = partition(graph, cuts, num_stages=None if cuts else args.stages)
    xs = _chain_inputs(graph, stages[0].in_spec, args.batch, args.count)
    hop_tiers = ([t.strip() for t in args.hop_tiers.split(",") if t.strip()]
                 if args.hop_tiers else None)
    replicas = _parse_replicas(args.replicas)
    device_map = None
    if args.device_map:
        device_map = {}
        for part in args.device_map.split(","):
            k, sep, v = part.strip().partition("=")
            if not sep or not k.startswith("stage"):
                raise SystemExit(f"--device-map: {part!r} is not stageK=J")
            try:
                device_map[int(k[len("stage"):])] = int(v)
            except ValueError:
                raise SystemExit(f"--device-map: {part!r} is not stageK=J")
    stats: list = []
    t0 = time.perf_counter()
    outs = run_chain(stages, params, xs, batch=args.batch, codec=args.codec,
                     in_band=args.in_band, overlap=not args.no_overlap,
                     rx_depth=args.rx_depth, tx_depth=args.tx_depth,
                     inflight=args.inflight, replicas=replicas or None,
                     stats_out=stats, tier=args.tier, hop_tiers=hop_tiers,
                     devices=args.devices, device_map=device_map,
                     failover=args.failover, device=args.device)
    dt = time.perf_counter() - t0

    dev = resolve_device(args.device)
    _no_tf32()
    pdev = params_to_device(params, dev)
    with torch.inference_mode():
        worst = max(float(np.abs(
            graph.apply(pdev, torch.from_numpy(x).to(dev)).cpu().numpy()
            - y).max()) for x, y in zip(xs, outs))
    # the negotiated tier per deployed stage (a replicated stage's fan is
    # one tcp policy): device-tier fusion merges stages before the spawn,
    # so the row describes what ran
    tier_of: dict[int, str] = {}
    for s in stats:
        tier_of.setdefault(int(s["stage"]), s["tier"])
    order = sorted(tier_of)
    row = {
        "metric": f"{args.model}_{len(stages)}proc_chain",
        "value": round(len(xs) * args.batch / dt, 3),
        "unit": "inferences/sec",
        "stages": len(order), "codec": args.codec, "tier": args.tier,
        "overlap": not args.no_overlap, "device": str(dev),
        "hop_tiers": [tier_of[k] for k in order[:-1]],
        "result_tier": tier_of[order[-1]],
        "max_abs_err_vs_single_program": worst,
        "kernel_launches": [s["kernel_launches"] for s in stats],
    }
    if replicas:
        row["replicas"] = {f"stage{k}": r
                           for k, r in sorted(replicas.items())}
        # how the round-robin split the frames, replica by replica
        row["per_node_processed"] = [
            {"stage": s["stage"], "replica": s["replica"],
             "processed": s["processed"]} for s in stats]
        row["failovers"] = sum(s["failovers"] for s in stats)
    if args.emit_calibration:
        from .plan.calibrate import CalibrationError, fit_from_stats
        from .utils import hw
        try:
            cal = fit_from_stats(graph,
                                 [s.output_name for s in stages[:-1]],
                                 stats, batch=args.batch,
                                 gen=hw.identify_chip(dev))
        except CalibrationError as e:
            raise SystemExit(f"--emit-calibration: {e}") from e
        cal.save(args.emit_calibration)
        row["calibration"] = args.emit_calibration
    print(json.dumps(row))


def _chain_inputs(graph, spec, batch: int, count: int) -> list:
    """Deterministic input frames for the entry boundary's spec (seed 0):
    normal floats, or token ids below the graph's vocabulary."""
    import numpy as np
    rng = np.random.default_rng(0)
    if spec.dtype.is_floating_point:
        return [rng.standard_normal((batch,) + spec.shape)
                .astype(np.float32) for _ in range(count)]
    vocab = next(n.op.vocab for n in graph.nodes.values()
                 if hasattr(n.op, "vocab"))
    return [rng.integers(0, vocab, (batch,) + spec.shape).astype(np.int32)
            for _ in range(count)]


def _cmd_chain_dag(args, graph, params) -> None:
    """``chain --dag`` / ``chain --topology FILE``: deploy the
    branch-parallel stage graph — one OS process per topology vertex,
    parallel branches concurrent between a broadcast fork and an
    all-paths join — and check it against the forward."""
    import numpy as np
    import torch

    from .runtime.node import run_dag_chain
    from .runtime.topology import ChainTopology
    from .utils.config import resolve_device
    from .utils.convert import params_to_device

    if args.replicas:
        raise SystemExit(
            "chain --dag: replicas do not compose with a branched "
            "topology (a branch hop touching a replicated stage is "
            "rejected like any fan hop); drop --replicas")
    if args.hop_tiers:
        raise SystemExit(
            "chain --dag: hop tiers do not compose with a branched "
            "topology — every branch fan-out/join hop is wire-framed "
            "by design")
    if args.cuts:
        raise SystemExit(
            "chain --dag: --cuts is the linear planner's input; the "
            "DAG topology comes from the solver (or --topology FILE)")
    dag_doc = None
    if args.topology:
        with open(args.topology) as f:
            topo = ChainTopology.from_json(json.load(f))
    else:
        from .plan import StageCostModel
        from .plan.dag import solve_dag
        dag = solve_dag(graph, StageCostModel(graph, batch=args.batch),
                        num_nodes=args.nodes or args.stages)
        dag_doc = dag.to_json()
        topo = ChainTopology.from_json(dag.topology_json())
    xs = _chain_inputs(graph, graph.out_spec(topo.entry.inputs[0]),
                       args.batch, args.count)
    stats: list = []
    t0 = time.perf_counter()
    outs = run_dag_chain(graph, params, xs, topology=topo,
                         batch=args.batch, codec=args.codec,
                         rx_depth=args.rx_depth, tx_depth=args.tx_depth,
                         inflight=args.inflight, stats_out=stats,
                         device=args.device)
    dt = time.perf_counter() - t0
    dev = resolve_device(args.device)
    _no_tf32()
    pdev = params_to_device(params, dev)
    with torch.inference_mode():
        worst = max(float(np.abs(
            graph.apply(pdev, torch.from_numpy(x).to(dev)).cpu().numpy()
            - y).max()) for x, y in zip(xs, outs))
    row = {
        "metric": f"{args.model}_{len(topo)}proc_dag_chain",
        "value": round(len(xs) * args.batch / dt, 3),
        "unit": "inferences/sec",
        "stages": len(topo),
        "labels": [v.label for v in topo.vertices],
        "forks": sum(1 for v in topo.vertices if v.fan == "broadcast"),
        "joins": sum(1 for v in topo.vertices if v.join >= 2),
        "codec": args.codec, "device": str(dev),
        "overlap": not args.no_overlap,
        "max_abs_err_vs_single_program": worst,
        "per_vertex_processed": [
            {"stage": s["stage"], "branch": s["branch"], "join": s["join"],
             "processed": s["processed"]} for s in stats],
        "kernel_launches": [s["kernel_launches"] for s in stats],
    }
    if dag_doc is not None:
        row["predicted_bottleneck_ms"] = dag_doc["bottleneck_ms"]
        row["predicted_critical_path_ms"] = dag_doc["critical_path_ms"]
        row["parallel_regions"] = dag_doc["parallel_regions"]
    print(json.dumps(row))


def _parse_replicas(spec: str, flag: str = "--replicas") -> dict[int, int]:
    """``stage1=2,stage3=3`` (or bare ``1=2,3=3``) -> {1: 2, 3: 3}; ``flag``
    names the error."""
    out: dict[int, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        if not v:
            raise SystemExit(f"{flag}: {part!r} is not stageK=N")
        k = k.strip().lower()
        if k.startswith("stage"):
            k = k[len("stage"):]
        try:
            out[int(k)] = int(v)
        except ValueError:
            raise SystemExit(f"{flag}: {part!r} is not stageK=N")
    return out


def _add_cost_flags(p):
    """Planner cost-model knobs shared by ``plan`` and ``partition``."""
    p.add_argument("--codecs", default="", metavar="LIST",
                   help="comma list of candidate hop codecs "
                        "(default: raw,lzb,bf8,bf16)")
    p.add_argument("--link-bw", type=float, default=0.0, metavar="BYTES_S",
                   help="hop link bandwidth in bytes/s (default: the "
                        "detected card's one-way interconnect figure; "
                        "set explicitly for network hops)")
    p.add_argument("--calibrate", action="store_true",
                   help="micro-bench the codec table on this host "
                        "instead of using analytic defaults")
    p.add_argument("--ici-bw", type=float, default=0.0, metavar="BYTES_S",
                   help="device-to-device interconnect bandwidth for "
                        "ici-tier hops (default: the card's one-way "
                        "interconnect figure, like --link-bw)")
    p.add_argument("--hop-tier-map", default="", metavar="CUT=TIER,...",
                   help="declare colocated boundaries to the cost model "
                        "(cut node name = ici|local|shm|device): those "
                        "hops are scored on the tier pseudo-codec "
                        "instead of the cheapest wire codec, so cut "
                        "placement exploits colocation")
    p.add_argument("--calibrated", default="", metavar="FILE",
                   help="overlay a CalibratedConstants JSON artifact "
                        "(chain --emit-calibration / "
                        "plan.calibrate.fit_from_stats) on the cost "
                        "model: measured codec throughputs and "
                        "host-sync/ici/local/wire bandwidths replace "
                        "the analytic defaults")


def _parse_hop_tier_map(spec: str) -> dict | None:
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        cut, sep, tier = part.rpartition("=")
        if not sep or tier not in ("ici", "local", "shm", "device",
                                   "tcp"):
            raise SystemExit(f"--hop-tier-map: {part!r} is not "
                             f"CUT=ici|local|shm|device|tcp")
        out[cut] = tier
    return out or None


def _cost_model(args, graph, *, node_costs=None):
    """Build the ``plan.StageCostModel`` the CLI flags describe."""
    from .plan import DEFAULT_CODECS, StageCostModel, calibrate_codecs
    names = [c for c in (args.codecs.split(",") if args.codecs
                         else list(DEFAULT_CODECS)) if c]
    if args.calibrate or any(n not in DEFAULT_CODECS for n in names):
        # unknown names (bf12, ...) have no analytic row: measure them
        codecs = calibrate_codecs(tuple(names))
    else:
        codecs = {n: DEFAULT_CODECS[n] for n in names}
    cost = StageCostModel(graph, batch=getattr(args, "batch", 1),
                          link_bw_s=args.link_bw or None,
                          ici_bw_s=getattr(args, "ici_bw", 0.0) or None,
                          codecs=codecs, node_costs=node_costs,
                          hop_tiers=_parse_hop_tier_map(
                              getattr(args, "hop_tier_map", "")))
    calibrated = getattr(args, "calibrated", "")
    if calibrated:
        from .plan import CalibratedConstants
        cost = CalibratedConstants.load(calibrated).apply(cost)
    return cost


def _measured_costs(args, graph) -> dict:
    """Per-node seconds of ``graph`` at ``--batch`` on ``--device`` (seeded
    random weights: the timing does not depend on their values)."""
    import torch

    from .utils.profiling import measured_node_costs
    params = graph.init(torch.Generator().manual_seed(0))
    _no_tf32()
    return measured_node_costs(graph, params, batch=args.batch,
                               device=_device_arg(args.device))


def _partition_json(graph, stages, plan=None) -> dict:
    """Machine-readable partition description (``--json``)."""
    from .graph.analysis import max_activation_bytes, valid_cut_points
    from .partition.stage import buffer_footprint
    cuts = [s.output_name for s in stages[:-1]]
    doc = {
        "model": graph.name,
        "num_stages": len(stages),
        "cuts": cuts,
        "valid_cut_points": valid_cut_points(graph),
        "max_activation_bytes": max_activation_bytes(graph, cuts),
        "stages": [{
            "index": s.index,
            "nodes": len(s.node_names),
            "input": s.input_name,
            "output": s.output_name,
            "in_shape": list(s.in_spec.shape),
            "out_shape": list(s.out_spec.shape),
            "boundary_bytes": s.out_spec.size * s.out_spec.dtype.itemsize,
        } for s in stages],
        "buffer": buffer_footprint(stages),
    }
    if plan is not None:
        doc["plan"] = plan.to_json()
    return doc


def cmd_partition(args) -> None:
    from . import partition
    from .graph.analysis import valid_cut_points
    from .graph.viz import summary, to_dot

    graph = _get_model(args.model)
    cuts = args.cuts.split(",") if args.cuts else None
    if cuts is not None and args.balance != "flops":
        raise SystemExit(f"--cuts and --balance {args.balance} conflict: "
                         "explicit cuts leave nothing to balance")
    if cuts is None and args.balance != "flops" and args.stages is None:
        raise SystemExit(f"--balance {args.balance} requires --stages")
    if cuts is None and args.stages is not None:
        # branching graphs lock most nodes inside their merge regions:
        # name the offending merge nodes instead of dying in the search
        from .graph.analysis import linear_cut_shortage
        shortage = linear_cut_shortage(graph, args.stages)
        if shortage:
            raise SystemExit(f"partition: {shortage}")
    plan = None
    if cuts is None and args.balance == "measured":
        # latency-balanced auto-cuts: time every op on the card and snap
        # quantiles of measured (not analytic) cost to valid cuts
        from .graph.analysis import auto_cut_points
        costs = _measured_costs(args, graph)
        cuts = auto_cut_points(graph, args.stages, costs=costs)
        if not args.json:
            print(f"measured-balanced cuts: {cuts}")
    elif cuts is None and args.balance == "bottleneck":
        # comm-aware exact solver: minimize max(compute, comm) per stage
        from .plan import solve
        plan = solve(graph, args.stages, _cost_model(args, graph))
        cuts = plan.cuts
        if not args.json:
            print(f"bottleneck cuts: {cuts} "
                  f"(hop codecs {plan.codecs}, predicted bottleneck "
                  f"{plan.bottleneck_s * 1e3:.4f} ms, {plan.bound_by}-"
                  f"bound)")
    stages = partition(graph, cuts, num_stages=args.stages
                       if cuts is None else None)
    stage_of = {name: s.index for s in stages for name in s.node_names}
    if args.json:
        print(json.dumps(_partition_json(graph, stages, plan)))
        if args.dot:
            with open(args.dot, "w") as f:
                f.write(to_dot(graph, stage_of=stage_of))
        return
    print(f"{graph.name}: {len(graph.nodes)} nodes, "
          f"{len(valid_cut_points(graph))} valid cut points")
    for s in stages:
        print(f"  {s}")
    # padded-buffer waste: every hop of the homogeneous ring buffer pays
    # buf_elems regardless of what the boundary carries
    from .partition.stage import buffer_footprint
    fp = buffer_footprint(stages)
    print(f"  transfer buffer: {fp['buf_elems']} elems/hop "
          f"(max stage boundary; every hop pays this)")
    for s, util in zip(stages, fp["hop_utilization"]):
        dst = f"stage {s.index + 1}" if s.index + 1 < len(stages) \
            else "dispatcher (wrap)"
        print(f"    hop {s.index}->{dst}: carries {s.out_spec.size} elems "
              f"({util:.1%} of buffer)")
    if args.summary:
        print(summary(graph))
    if args.dot:
        with open(args.dot, "w") as f:
            f.write(to_dot(graph, stage_of=stage_of))
        print(f"wrote {args.dot}")


def _linear_critical_path_s(plan) -> float:
    """Per-sample latency of a chain plan: the sum of per-stage
    ``max(compute, comm)`` — a chain's stage graph IS one path."""
    comm = plan.hop_comm_s + [0.0]
    return sum(max(c, h) for c, h in zip(plan.stage_compute_s, comm))


def _cmd_plan_dag(args, graph, cm, doc: dict, *,
                  hop_tiers: dict | None) -> None:
    """``plan --dag``: branch-parallel stage graph vs the best linear
    chain at the same process budget."""
    from .plan.dag import best_linear_plan, solve_dag
    num_nodes = args.nodes or args.stages
    if not num_nodes:
        raise SystemExit("plan --dag requires --nodes N (process "
                         "budget; --stages N also works)")
    dag = solve_dag(graph, cm, num_nodes=num_nodes, hop_tiers=hop_tiers)
    linear = best_linear_plan(graph, cm, num_nodes)
    lin_cp = _linear_critical_path_s(linear)
    doc["plan"] = dag.to_json()
    doc["linear"] = linear.to_json()
    doc["linear"]["critical_path_ms"] = round(lin_cp * 1e3, 6)
    doc["predicted_speedup_vs_linear"] = round(
        linear.bottleneck_s / dag.bottleneck_s, 4) \
        if dag.bottleneck_s > 0 else None
    doc["predicted_latency_speedup_vs_linear"] = round(
        lin_cp / dag.critical_path_s, 4) \
        if dag.critical_path_s > 0 else None
    if args.json:
        print(json.dumps(doc))
        return
    print(f"{graph.name}: DAG plan, {dag.num_stages} stage vertices / "
          f"{num_nodes} node budget, cost model "
          f"{cm.describe()['node_costs']}")
    for v in dag.vertices:
        mark = " <- bottleneck" if v.vid == dag.bottleneck_vertex else ""
        role = ""
        if v.fan == "broadcast":
            role = f" fork x{len(v.next)}"
        if v.join >= 2:
            role += f" join x{v.join}"
        print(f"  {v.label:>11}: compute {v.compute_s * 1e3:10.4f} ms | "
              f"hop {v.comm_s * 1e3:10.4f} ms ({v.codec})"
              f"{role}{mark}")
    print(f"  parallel regions: "
          + (", ".join(f"{r['fork']}->{r['join']} x{r['paths']}"
                       for r in dag.parallel_regions) or "none "
             "(linear chain is optimal at this budget)"))
    print(f"  predicted bottleneck {dag.bottleneck_s * 1e3:.4f} ms, "
          f"critical path {dag.critical_path_s * 1e3:.4f} ms")
    print(f"  linear baseline ({linear.num_stages} stages): bottleneck "
          f"{linear.bottleneck_s * 1e3:.4f} ms, critical path "
          f"{lin_cp * 1e3:.4f} ms (speedup "
          f"{doc['predicted_speedup_vs_linear']}x throughput, "
          f"{doc['predicted_latency_speedup_vs_linear']}x latency)")


def cmd_plan(args) -> None:
    """Comm-aware bottleneck plan: solve, score the quantile baseline on
    the same cost model, optionally sweep stage counts / node budgets or
    replan from a telemetry snapshot."""
    from .graph.analysis import auto_cut_points, linear_cut_shortage
    from .plan import evaluate_cuts, solve, sweep_stages

    graph = _get_model(args.model)
    node_costs = _measured_costs(args, graph) if args.measured else None
    dag_tiers = None
    if args.dag:
        # the DAG planner validates hop-tier keys against the stage-
        # GRAPH cut namespace (branch-internal hops included) — keep
        # them away from the cost-model constructor's linear check
        dag_tiers = _parse_hop_tier_map(getattr(args, "hop_tier_map", ""))
        args.hop_tier_map = ""
    cm = _cost_model(args, graph, node_costs=node_costs)
    doc: dict = {"model": graph.name, "cost_model": cm.describe()}
    if args.dag:
        _cmd_plan_dag(args, graph, cm, doc, hop_tiers=dag_tiers)
        return
    if args.stages is not None and not args.nodes and not args.sweep:
        # pre-validate BEFORE the DP: an oversubscribed stage count on a
        # branching graph must name the merge nodes locking the cuts
        shortage = linear_cut_shortage(graph, args.stages)
        if shortage:
            raise SystemExit(f"plan: {shortage}")
    if args.nodes:
        # hybrid pipeline/data-parallel: joint cuts + replica counts for
        # a process budget, vs the best cuts-only plan it must beat
        from .graph.analysis import valid_cut_points
        from .plan import solve_replicated
        plan = solve_replicated(graph, cm, num_nodes=args.nodes)
        doc["plan"] = plan.to_json()
        max_s = min(args.nodes, len(valid_cut_points(graph)) + 1)
        cuts_only = min((solve(graph, s, cm) for s in range(1, max_s + 1)),
                        key=lambda p: p.bottleneck_s)
        doc["cuts_only"] = cuts_only.to_json()
        doc["predicted_speedup_vs_cuts_only"] = round(
            cuts_only.bottleneck_s / plan.bottleneck_s, 4) \
            if plan.bottleneck_s > 0 else None
    elif args.sweep:
        sw = sweep_stages(graph, cm, max_stages=args.sweep,
                          latency_target_s=args.target_ms / 1e3
                          if args.target_ms else None)
        doc["sweep"] = [p.to_json() for p in sw["plans"]]
        doc["target_met"] = sw["target_met"]
        plan = sw["recommended"]
        doc["recommended"] = plan.to_json()
    else:
        if args.stages is None:
            raise SystemExit(
                "plan requires --stages (or --sweep MAX / --nodes N)")
        plan = solve(graph, args.stages, cm)
        doc["plan"] = plan.to_json()
    if plan.num_stages > 1:
        # the measurable baseline: greedy quantile cuts scored on the
        # SAME cost model the solver optimized
        qcuts = auto_cut_points(graph, plan.num_stages, costs=node_costs)
        qplan = evaluate_cuts(graph, qcuts, cm, objective="quantile")
        doc["quantile"] = qplan.to_json()
        doc["predicted_speedup_vs_quantile"] = round(
            qplan.bottleneck_s / plan.bottleneck_s, 4) \
            if plan.bottleneck_s > 0 else None
    if args.replan:
        from .plan import replan as _do_replan
        with open(args.replan) as f:
            snap = json.load(f)
        rp = _do_replan(graph, plan, snap.get("registry", snap), cm)
        doc["replan"] = rp.to_json()
    if args.json:
        print(json.dumps(doc))
        return
    print(f"{graph.name}: {plan.num_stages} stages, objective "
          f"{plan.objective}, cost model {cm.describe()['node_costs']} "
          f"(gen {cm.gen}, link {cm.link_bw_s:.3g} B/s)")
    comm = plan.hop_comm_s + [0.0]
    codecs = plan.codecs + ["-"]
    reps = getattr(plan, "replicas", None)
    for k, comp in enumerate(plan.stage_compute_s):
        mark = " <- bottleneck" if k == plan.bottleneck_stage else ""
        rep = ""
        if reps is not None and reps[k] > 1:
            rep = (f" x{reps[k]} replicas -> "
                   f"{comp / reps[k] * 1e3:.4f} ms")
        print(f"  stage {k}: compute {comp * 1e3:10.4f} ms{rep} | "
              f"hop {comm[k] * 1e3:10.4f} ms ({codecs[k]}){mark}")
    print(f"  predicted bottleneck {plan.bottleneck_s * 1e3:.4f} ms "
          f"({plan.bound_by}-bound) -> "
          f"{plan.predicted_throughput_per_s(cm.batch):.2f} inf/s")
    print(f"  cuts: {','.join(plan.cuts) or '-'}")
    if "cuts_only" in doc:
        co = doc["cuts_only"]
        print(f"  cuts-only baseline ({co['num_stages']} stages): "
              f"bottleneck {co['bottleneck_ms']:.4f} ms (speedup "
              f"{doc['predicted_speedup_vs_cuts_only']}x with "
              f"{doc['plan']['num_nodes']} nodes)")
    if "quantile" in doc:
        q = doc["quantile"]
        print(f"  quantile baseline: bottleneck {q['bottleneck_ms']:.4f} "
              f"ms at cuts {','.join(q['cuts'])} "
              f"(speedup {doc['predicted_speedup_vs_quantile']}x)")
    if "replan" in doc:
        r = doc["replan"]
        print(f"  replan: moved={r['moved']} corrections="
              f"{r['corrections']} predicted improvement "
              f"{r['predicted_improvement']}x")
    if args.sweep:
        met = doc["target_met"]
        print(f"  sweep: recommended {plan.num_stages} stages"
              + (f" (target {'met' if met else 'NOT met'})"
                 if met is not None else ""))


def _add_overlap_flags(p) -> None:
    """Transport-overlap tuning shared by ``node`` and ``chain``."""
    p.add_argument("--no-overlap", action="store_true",
                   help="serial recv->infer->send node loop (the baseline "
                        "the overlapped loop is measured against)")
    p.add_argument("--rx-depth", type=int, default=8, metavar="N",
                   help="decoded frames buffered by each rx channel")
    p.add_argument("--tx-depth", type=int, default=8, metavar="N",
                   help="frames queued to each tx channel before the "
                        "producer blocks")
    p.add_argument("--inflight", type=int, default=2, metavar="N",
                   help="stage programs kept un-synced per node (the "
                        "window of CUDA events waited on in order)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m defer_tpu_torch",
        description="DEFER's stage-node process chain, in PyTorch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    nd = sub.add_parser("node", help="run one standalone stage node")
    nd.add_argument("--artifact", default=None,
                    help="pre-placed stage artifact; omit to boot empty "
                         "and receive it in-band (control handshake)")
    nd.add_argument("--listen", required=True, metavar="[host]:port")
    nd.add_argument("--next", default=None, metavar="host:port",
                    help="successor hop (last node: the dispatcher's "
                         "result port); omit to receive it in-band")
    nd.add_argument("--codec", default="raw",
                    help="hop codec: raw | lzb | bf8/bf12/bf16 | "
                         "sleep<ms>+<codec> (bench-only delay wrapper; "
                         "esleep/dsleep delay one side only)")
    nd.add_argument("--connect-timeout", type=float, default=30.0)
    nd.add_argument("--fan-in", type=int, default=1, metavar="R",
                    help="merge R sequence-stamped upstream connections "
                         "(this node sits below a replicated stage) "
                         "through a bounded reorder buffer")
    nd.add_argument("--replica", type=int, default=None, metavar="N",
                    help="this process is replica N of its stage "
                         "(labels stageK.rN spans and stats)")
    nd.add_argument("--fan", choices=["rr", "broadcast"], default="rr",
                    help="multi-hop --next distribution: rr round-robins "
                         "across stage replicas; broadcast sends every "
                         "frame to every hop (the fork of a branched "
                         "stage graph, one shared seq stamp per frame)")
    nd.add_argument("--branch", type=int, default=None, metavar="J",
                    help="this node rides branch path J of a fork/join "
                         "region (labels stageK.bJ spans and stats; the "
                         "outbound stream announces path J to the join)")
    nd.add_argument("--join", type=int, default=0, metavar="P",
                    help="this node is the region's join: merge P labeled "
                         "branch paths per sequence through a (path, seq) "
                         "reorder buffer and run the multi-input program")
    nd.add_argument("--failover", action="store_true",
                    help="arm the seq-replay plane on this node: a "
                         "fan-out retains sent frames until the fan-in "
                         "below acks them and heals dead replica "
                         "channels; a replica relays acks upstream; a "
                         "fan-in waits a grace period for a dead "
                         "upstream's replacement and drops replayed "
                         "duplicates")
    nd.add_argument("--infer-delay-ms", type=float, default=0.0,
                    help="bench-only: sleep this long per frame in the "
                         "compute loop (simulated device time)")
    nd.add_argument("--device", default=None,
                    help="where the stage program runs: cuda (the "
                         "default; raises without a card), cuda:N, a bare "
                         "card index J (cuda:J), or cpu")
    nd.add_argument("--persist", action="store_true",
                    help="survive stream END: keep serving segments until "
                         "a 'shutdown' control frame arrives")
    nd.add_argument("--tier", choices=["auto", "ici", "local", "shm", "tcp"],
                    default="auto",
                    help="outbound transport-tier policy: auto walks the "
                         "ladder on the downstream dial — ici (same "
                         "process and platform, the output tensor handed "
                         "over on the card) over local (same process, the "
                         "host copy by reference) over shm (same host, a "
                         "shared-memory ring with the socket as doorbell) "
                         "over tcp; ici/local/shm offer that rung alone; "
                         "tcp never probes")
    nd.add_argument("--tier-accept", choices=["auto", "0", "1"],
                    default="auto",
                    help="grant inbound tier offers (auto: exactly when "
                         "--tier is not tcp; a stage whose own outbound is "
                         "tcp may still be the colocated target of its "
                         "upstream)")
    nd.add_argument("--co-stage", action="append", default=[],
                    metavar="SPEC",
                    help="host one more stage node in this process "
                         "(repeatable): 'listen=host:port[;artifact=P]"
                         "[;next=host:port][;codec=C][;tier=T]"
                         "[;accept=0|1][;device=J]' — hops between "
                         "housemates negotiate the in-process tiers (ici "
                         "on one platform, local otherwise); accept gates "
                         "inbound offers (default: tier != tcp); device "
                         "pins the housemate's program to cuda:J")
    _add_overlap_flags(nd)

    c = sub.add_parser("chain", help="spawn a local N-process chain and "
                                     "verify it against the forward")
    c.add_argument("--model", default="resnet_tiny")
    c.add_argument("--stages", type=int, default=3)
    c.add_argument("--cuts", help="comma-separated cut points (in place "
                                  "of --stages)")
    c.add_argument("--batch", type=int, default=1)
    c.add_argument("--count", type=int, default=8)
    c.add_argument("--codec", default="raw",
                   choices=["raw", "lzb", "bf8", "bf12", "bf16"])
    c.add_argument("--in-band", action="store_true",
                   help="boot nodes empty; ship artifacts over the "
                        "control handshake")
    c.add_argument("--replicas", default="", metavar="stageK=R,...",
                   help="run stage K as R data-parallel replica processes "
                        "(ordered fan-out/fan-in; adjacent stages cannot "
                        "both be replicated)")
    c.add_argument("--failover", action="store_true",
                   help="arm the seq-replay plane: fan-outs retain frames "
                        "until acked and heal dead replica channels, a "
                        "supervisor respawns killed replica processes, "
                        "and the stream completes byte-identical; needs an "
                        "interior replicated stage (--replicas) and "
                        "artifacts on the command line (no --in-band)")
    c.add_argument("--device", default="cuda",
                   help="where every node runs: cuda (the default) or cpu")
    c.add_argument("--tier", choices=["auto", "shm", "tcp"], default="auto",
                   help="transport-tier policy of every hop, the "
                        "dispatcher's edges included: auto negotiates the "
                        "cheapest rung per hop (ici > local > shm > tcp), "
                        "shm pins the shared-memory offer, tcp is a pure "
                        "wire chain end to end.  Pin ici/local on stage "
                        "hops with --hop-tiers (the dispatcher is a "
                        "process of its own)")
    c.add_argument("--hop-tiers", default="", metavar="T0,T1,...",
                   help="one tier per inter-stage hop (stages-1 of them, "
                        "each tcp|auto|local|shm|ici|device): device fuses "
                        "the two stages into one program, ici and local run "
                        "them in one process (ici hands the tensor over on "
                        "the card), shm keeps separate processes and hands "
                        "activations through a shared-memory ring")
    c.add_argument("--devices", type=int, default=None, metavar="N",
                   help="require N visible CUDA cards (for --device-map)")
    c.add_argument("--device-map", default="", metavar="stageK=J,...",
                   help="pin stage K's program to cuda:J; an ici hop "
                        "between cards moves each activation device to "
                        "device")
    c.add_argument("--dag", action="store_true",
                   help="deploy the DAG planner's branch-parallel stage "
                        "graph instead of a linear chain: parallel "
                        "branches run as concurrent processes between a "
                        "broadcast fork and an all-paths join (--nodes "
                        "sets the process budget; replicas, hop tiers and "
                        "--cuts do not compose with it)")
    c.add_argument("--nodes", type=int, default=0, metavar="N",
                   help="--dag process budget (default: --stages)")
    c.add_argument("--topology", default=None, metavar="FILE",
                   help="deploy an explicit topology JSON (a `plan --dag "
                        "--json` document of either package) instead of "
                        "solving")
    c.add_argument("--emit-calibration", default="", metavar="FILE",
                   help="after the run, fit CalibratedConstants "
                        "(host_sync/ici/wire bandwidths, per-deployed-"
                        "codec throughputs) from the chain's own "
                        "telemetry and write the versioned JSON "
                        "artifact — feed it back via `plan --calibrated`")
    _add_overlap_flags(c)

    p = sub.add_parser("partition", help="show the stage table")
    p.add_argument("--model", required=True)
    p.add_argument("--stages", type=int)
    p.add_argument("--cuts")
    p.add_argument("--balance",
                   choices=["flops", "measured", "bottleneck"],
                   default="flops",
                   help="auto-cut objective: FLOP quantiles (analytic), "
                        "measured-latency quantiles, or the exact comm-"
                        "aware bottleneck solver")
    p.add_argument("--batch", type=int, default=1,
                   help="batch size for measured timing / comm sizing")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (cuts, stage table, "
                        "plan predictions) instead of the human table")
    p.add_argument("--dot", help="write a DOT graph with stage coloring")
    p.add_argument("--summary", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where --balance measured times the nodes: cuda "
                        "(the default), cuda:N, a card index, or cpu")
    _add_cost_flags(p)

    pl = sub.add_parser("plan", help="comm-aware bottleneck partition "
                                     "plan vs the quantile baseline")
    pl.add_argument("--model", required=True)
    pl.add_argument("--stages", type=int)
    pl.add_argument("--batch", type=int, default=1,
                    help="per-hop frame batch for the comm model")
    pl.add_argument("--measured", action="store_true",
                    help="measure per-node seconds on the card instead "
                         "of the analytic roofline")
    pl.add_argument("--device", default="cuda",
                    help="where --measured times the nodes: cuda (the "
                         "default), cuda:N, a card index, or cpu")
    pl.add_argument("--sweep", type=int, metavar="MAX",
                    help="solve every stage count 1..MAX and recommend")
    pl.add_argument("--nodes", type=int, metavar="N",
                    help="hybrid plan for a budget of N processes: "
                         "jointly choose cuts AND per-stage replica "
                         "counts")
    pl.add_argument("--target-ms", type=float, default=0.0,
                    help="bottleneck latency target for the --sweep "
                         "recommendation (fewest stages that meet it)")
    pl.add_argument("--replan", metavar="METRICS_JSON",
                    help="re-solve with measured per-stage seconds from "
                         "a metrics snapshot (telemetry-corrected cost "
                         "model)")
    pl.add_argument("--dag", action="store_true",
                    help="branch-parallel stage GRAPH plan for --nodes N "
                         "processes: parallel branches become concurrent "
                         "sub-pipelines with a broadcast fork and an "
                         "all-paths join; reports bottleneck AND "
                         "critical path vs the best linear plan at the "
                         "same node count, and the JSON carries the "
                         "topology")
    pl.add_argument("--json", action="store_true")
    _add_cost_flags(pl)

    args = ap.parse_args(argv)
    {"node": cmd_node, "chain": cmd_chain, "partition": cmd_partition,
     "plan": cmd_plan}[args.cmd](args)


if __name__ == "__main__":
    main()
