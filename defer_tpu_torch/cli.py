"""Command line of the port: ``python -m defer_tpu_torch <command>``.

    python -m defer_tpu_torch models
    python -m defer_tpu_torch bench --model resnet50 --cuts C0,C1,... \\
        --microbatch 8 --chunk 4 --wire int8 [--device cpu]
    python -m defer_tpu_torch export --model bert_base --stages 12 \\
        --batch 8 --out DIR
    python -m defer_tpu_torch generate --model gpt2_small --stages 12 \\
        --microbatch 8 --prompt-len 32 --new-tokens 8 [--prefill]
    python -m defer_tpu_torch serve --model resnet_tiny --stages 3 \\
        [--nodes H:P,...] [--workload decode] [--seconds S]
    python -m defer_tpu_torch serve-client --connect H:P --rate 20
    python -m defer_tpu_torch node --listen :5000 [--device cpu]
    python -m defer_tpu_torch chain --model resnet_tiny --stages 3 \\
        [--in-band] [--codec lzb] [--device cpu] [--emit-calibration F]
    python -m defer_tpu_torch plan --model resnet50 --stages 8 \\
        [--measured] [--calibrated F] [--json]
    python -m defer_tpu_torch partition --model resnet_tiny --stages 3 \\
        [--balance flops|measured|bottleneck] [--json]
    python -m defer_tpu_torch monitor --nodes H:P,... [--plan F --model M]
        [--serve H:P] [--events] [--json] [--align]
    python -m defer_tpu_torch profile --nodes H:P,... [--seconds S]
        [--torch-trace-dir D] [--trace-out F]
    python -m defer_tpu_torch postmortem JOURNAL_DIR

``models`` lists the model zoo.  ``bench`` times a ring pipeline
(``SpmdPipeline``) over a window and prints the JAX package's JSON line;
``export`` writes one ``torch.export`` stage artifact per stage;
``generate`` decodes random prompts through ``PipelinedDecoder``.
``serve`` is the multi-tenant front door over one deployed chain
(thread-per-stage nodes in this process, or running ``node`` processes
with ``--nodes``) or over a continuous-batching decode engine, and
``serve-client`` plays a seeded Poisson trace against it.
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
package's documents for the same flags.  ``monitor`` renders a running
chain's push telemetry live (rows, bottleneck, stragglers and drift
against a ``plan --json`` file, a serve front door's tenants),
``profile`` brackets a window on every node and prints its phase
breakdown, and ``postmortem`` assembles a forensics bundle from the
black-box journals a ``--journal-dir`` chain wrote (either package's).

These are the JAX package's subcommands (``defer_tpu/cli.py``) but
``train``, which comes with ROADMAP item A16.  Every command that runs a
model (``bench``, ``generate``, ``serve``, ``node``, ``chain``, and the
per-node timing of ``--measured``/``--balance measured``) runs on the
CUDA card unless ``--device cpu`` is given; a float32 stage runs without
TF32 (cuBLAS and cuDNN), so its rows match the float32 forward.  Weights
are the seeded initialisation of :func:`_init_params`.
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


def _init_params(graph) -> dict:
    """The weights every command runs: the port's seeded initialisation
    (seed 0).  The one place a command's parameters come from."""
    import torch
    return graph.init(torch.Generator().manual_seed(0))


def _no_tf32() -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _add_obs_flags(p) -> None:
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write spans as Chrome trace-event JSON "
                        "(open at https://ui.perfetto.dev)")
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="write a JSON snapshot of the metrics registry "
                        "(counters, byte counts, latency percentiles)")


def _obs_begin(args, *, process: str = "dispatcher"):
    """Enable the process tracer when a trace export was requested."""
    if getattr(args, "trace_out", None):
        from .obs import enable_tracing
        enable_tracing(process=process).start_trace()


def _obs_finish(args, extra: dict | None = None):
    """Write the requested telemetry artifacts (no-op without flags)."""
    if getattr(args, "trace_out", None):
        from .obs import export_chrome_trace
        export_chrome_trace(args.trace_out)
        print(f"trace -> {args.trace_out}", file=sys.stderr)
    if getattr(args, "metrics_out", None):
        from .obs import REGISTRY
        snap = {"registry": REGISTRY.snapshot()}
        if extra:
            snap.update(extra)
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=2, default=str)
            f.write("\n")
        print(f"metrics -> {args.metrics_out}", file=sys.stderr)


def _start_prom(args, who: str):
    """``--prom-port N``: serve the process registry's Prometheus
    exposition over stdlib HTTP (0 = ephemeral port, printed)."""
    if getattr(args, "prom_port", None) is None:
        return
    from .obs.report import start_prom_server
    srv = start_prom_server(args.prom_port)
    print(f"{who}: prometheus exposition on "
          f"http://127.0.0.1:{srv.server_address[1]}/metrics",
          file=sys.stderr, flush=True)


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

    _apply_sock_buf(args)
    _start_prom(args, "node")
    _codec(args.codec)  # loud at boot, not when the first tensor relays
    specs = [_parse_co_stage(c) for c in args.co_stage or []]
    for kv in specs:
        _codec(kv.get("codec", "raw"))
    _no_tf32()
    _obs_begin(args, process="node")

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
    if args.journal_dir:
        # the black box: spill this process's events, obs rows and spans
        # to a crash-safe journal a postmortem reads after a kill -9
        from .obs import recorder, start_journal
        m = node.manifest
        label = (f"stage{m['index']}" if m is not None
                 else f"node{node.address[1]}")
        if args.replica is not None:
            label += f".r{args.replica}"

        def _journal_row(_node=node):
            payload, _, _ = _node.obs_snapshot(
                include_spans=False, subscriber=-101,
                event_cursor=recorder().cursor())
            # events and spans ride their own journal records; the
            # snapshot is the last-known ClusterView-style row
            payload.pop("trace", None)
            payload.pop("events", None)
            return payload

        start_journal(args.journal_dir, label, snapshot_fn=_journal_row)
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
    if args.journal_dir:
        from .obs import stop_journal
        stop_journal()   # final spill: the clean exit's journal is whole
    print(f"node: served {n} tensors; chain drained", file=sys.stderr)
    _obs_finish(args)


def cmd_chain(args) -> None:
    import numpy as np
    import torch

    from . import models, partition
    from .runtime.node import run_chain
    from .utils.config import resolve_device
    from .utils.convert import params_to_device

    graph = _get_model(args.model)
    params = _init_params(graph)
    if args.dag or args.topology:
        _cmd_chain_dag(args, graph, params)
        return
    _obs_begin(args)
    _start_prom(args, "chain")
    cuts = args.cuts.split(",") if args.cuts else None
    stages = partition(graph, cuts, num_stages=None if cuts else args.stages)
    # size every data socket's kernel buffers to the fattest boundary
    # frame this partition ships (overridable with --sock-buf)
    from .graph.analysis import max_activation_bytes
    _apply_sock_buf(args, auto_bytes=max_activation_bytes(
        graph, [s.output_name for s in stages[:-1]], batch=args.batch))
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
                     failover=args.failover, device=args.device,
                     journal_dir=args.journal_dir or None)
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
    # node-side MFU (obs/capacity.py): only where a stage reported a
    # figure against a known peak, never a 0.0 stand-in
    mfu_of = {int(s["stage"]): s["mfu"] for s in stats
              if s.get("stage") is not None and s.get("mfu") is not None}
    if mfu_of:
        row["stage_mfu"] = {f"stage{k}": round(v, 4)
                            for k, v in sorted(mfu_of.items())}
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
    _obs_finish(args)


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
    from .graph.analysis import max_activation_bytes
    _apply_sock_buf(args, auto_bytes=max_activation_bytes(
        graph, [v.output for v in topo.vertices[:-1]
                if v.output in graph.nodes], batch=args.batch))
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
    from .utils.profiling import measured_node_costs
    params = _init_params(graph)
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


def _render_monitor(rows, bottleneck, flags, offsets, *, clear: bool,
                    drift=()):
    """One refresh of the top-style monitor table (human mode)."""
    tty = sys.stdout.isatty()
    if clear and tty:
        print("\x1b[2J\x1b[H", end="")
    print(f"{'STAGE':>5} {'BR':>3} {'REP':>3} {'TIER':>5} {'INF/S':>8} "
          f"{'P50MS':>9} "
          f"{'P95MS':>9} {'P99MS':>9} {'HS50':>7} {'DISP':>7} "
          f"{'DEV':>7} {'MEM':>7} {'MFU%':>6} "
          f"{'PRED':>9} {'MEAS':>9} {'ERR%':>7} "
          f"{'RXQ':>4} {'TXQ':>4} "
          f"{'RX^':>4} {'TX^':>4} {'INF':>4} {'RX B/S':>11} "
          f"{'TX B/S':>11} {'DONE':>8}  ADDR")
    for r in rows:
        stage = "-" if r["stage"] is None else str(r["stage"])
        rep = "-" if r["replica"] is None else str(r["replica"])
        # branched topologies: bJ = this row rides branch path J of a
        # fork/join region, jP = this row is the P-path join — so the
        # bottleneck highlight names a branch, not a flattened index
        if r.get("branch") is not None:
            br = f"b{r['branch']}"
        elif (r.get("join") or 0) >= 2:
            br = f"j{r['join']}"
        else:
            br = "-"
        # a "!" marks a DEGRADED hop (this node offered a colocated
        # tier, fell back, and is STILL riding tcp) — distinguishable
        # from a hop that rides tcp because nothing better was ever
        # offered; a later successful renegotiation clears the mark
        # even though the lifetime fallback count stays nonzero
        tier = r.get("tier") or "-"
        tier = tier[:4] + "!" \
            if r.get("tier_fallbacks") and tier == "tcp" else tier[:5]
        p = r["infer_ms"]
        # host-sync p50: "-" when the row recorded ZERO samples — an
        # ici (device-resident) hop's proof mark
        hs = r.get("host_sync_ms") or {}
        hs50 = "-" if not hs.get("count") else f"{hs.get('p50', 0):.3f}"
        # phase X-ray p50s (obs/profile.py): dispatch (the program call
        # returning) / device (the CUDA event's wait) next to HS50 — "-"
        # at zero samples, same convention
        dp = r.get("dispatch_ms") or {}
        disp = "-" if not dp.get("count") else f"{dp.get('p50', 0):.3f}"
        dv = r.get("device_ms") or {}
        dev = "-" if not dv.get("count") else f"{dv.get('p50', 0):.3f}"
        # the card's live allocator megabytes — "-" from a process that
        # has no card to read (None on the wire; a fake 0 would lie)
        mem = "-" if r.get("mem_bytes") is None \
            else f"{r['mem_bytes'] / 1e6:.1f}M"
        # MFU is "-" unless the node reported an HONEST figure (known
        # chip peak + deployed capacity) — a fabricated 0.0 would be
        # indistinguishable from a real idle chip
        mfu = "-" if r.get("mfu") is None else f"{r['mfu'] * 100:.1f}"
        # predicted-vs-measured service audit (obs/capacity.py): only
        # rendered when monitor has --plan and --model to predict from
        pred = "-" if r.get("pred_ms") is None else f"{r['pred_ms']:.3f}"
        meas = "-" if r.get("meas_ms") is None else f"{r['meas_ms']:.3f}"
        errp = "-" if r.get("err") is None else f"{r['err'] * 100:+.1f}"
        line = (f"{stage:>5} {br:>3} {rep:>3} {tier:>5} "
                f"{r['throughput_per_s']:>8.1f} "
                f"{p['p50']:>9.3f} {p['p95']:>9.3f} {p['p99']:>9.3f} "
                f"{hs50:>7} {disp:>7} {dev:>7} {mem:>7} "
                f"{mfu:>6} {pred:>9} {meas:>9} {errp:>7} "
                f"{r['rx_q']:>4.0f} {r['tx_q']:>4.0f} "
                f"{r['rx_hi']:>4.0f} {r['tx_hi']:>4.0f} "
                f"{r['inflight']:>4.0f} {r['rx_bytes_per_s']:>11.0f} "
                f"{r['tx_bytes_per_s']:>11.0f} {r['processed']:>8}  "
                f"{r['addr'] or ''}")
        mark = (bottleneck is not None and r["stage"] == bottleneck)
        if not r["alive"]:
            line += "  [DEAD]"
        if mark:
            line = f"\x1b[7m{line}\x1b[0m" if tty \
                else line + "  <- bottleneck"
        print(line)
    for f in flags:
        print(f"straggler: stage {f.stage} [{f.reason}] measured "
              f"{f.measured_ms:.3f} ms vs planned {f.expected_ms:.3f} ms "
              f"(x{f.ratio:.2f}, {f.intervals} intervals)")
    for f in drift:
        print(f"model_drift: stage {f.stage} predicted "
              f"{f.predicted_ms:.3f} ms vs measured "
              f"{f.measured_ms:.3f} ms ({f.rel_err * 100:+.1f}%, "
              f"{f.intervals} intervals)")
    if offsets:
        worst = max(abs(v["offset_us"]) for v in offsets.values())
        print(f"clock: {len(offsets)} nodes aligned "
              f"(worst offset {worst / 1e3:.3f} ms)")
    sys.stdout.flush()


def _render_serve_stats(doc: dict) -> None:
    """Per-tenant serving columns of the monitor."""
    print(f"serve: mode={doc.get('mode')} width={doc.get('width')} "
          f"frames={doc.get('frames')} queued={doc.get('queued')} "
          f"inflight={doc.get('inflight')} service~"
          f"{doc.get('service_estimate_ms')}ms")
    print(f"{'TENANT':>12} {'W':>5} {'PRI':>3} {'QUEUED':>6} {'ADM':>7} "
          f"{'SHED':>6} {'DONE':>7} {'QDELAY P50':>11} {'P99 MS':>8} "
          f"{'SLO%':>6}")
    attrib = doc.get("attribution") or {}
    for name, r in (doc.get("tenants") or {}).items():
        qd = r.get("queue_delay_s") or {}
        p50 = (qd.get("p50", 0.0) or 0.0) * 1e3 if qd.get("count") else 0.0
        p99 = (qd.get("p99", 0.0) or 0.0) * 1e3 if qd.get("count") else 0.0
        # SLO attainment: fraction of DELIVERED units inside the
        # tenant's deadline_ms ("-" = no deadline / nothing scored yet)
        att = r.get("slo_attainment")
        att_s = "-" if att is None else f"{att * 100:.1f}"
        print(f"{name:>12} {r.get('weight', 1):>5.1f} "
              f"{r.get('priority', 0):>3} {r.get('queued', 0):>6} "
              f"{r.get('admitted', 0):>7} {r.get('shed', 0):>6} "
              f"{r.get('completed', 0):>7} {p50:>11.3f} {p99:>8.3f} "
              f"{att_s:>6}")
        # where the tenant's latency goes: the door's always-on
        # attribution buckets (p50 ms per bucket)
        buckets = attrib.get(name)
        if buckets and (buckets.get("e2e") or {}).get("count"):
            parts = " ".join(
                f"{k}={((buckets.get(k) or {}).get('p50', 0.0)):.2f}"
                for k in ("admission", "gather", "chain", "result_edge"))
            print(f"{'':>12}   p50ms: {parts} "
                  f"e2e={(buckets['e2e'].get('p50', 0.0)):.2f}")


def cmd_postmortem(args):
    """Assemble a forensics bundle from the on-disk black-box journals
    under a ``--journal-dir`` — no live process required; the journals
    of dead (kill -9'd) processes are the whole point.  Either package's
    journals are read."""
    from .obs import collect_postmortem

    bundle = collect_postmortem(args.dir, out_dir=args.out or None,
                                reason=args.reason, last_s=args.last_s)
    for w in bundle["warnings"]:
        print(f"postmortem: WARNING: {w}", file=sys.stderr, flush=True)
    verdict = bundle["verdict"] or {}
    print(json.dumps({
        "out_dir": bundle["out_dir"],
        "procs": [p["proc"] for p in bundle["procs"]],
        "events": len(bundle["timeline"]),
        "events_dropped": bundle["events_dropped"],
        "warnings": len(bundle["warnings"]),
        "first_fault": verdict.get("first_fault"),
        "evidence": verdict.get("evidence"),
        "casualties": [c["proc"] for c in verdict.get("casualties", [])],
    }, default=str), flush=True)


def cmd_monitor(args):
    """Live chain observability: subscribe to every node's obs_push
    stream (passively estimating each node's clock offset; --align to
    actively re-anchor), render a refreshing per-stage/per-replica
    table with the bottleneck stage highlighted — or --json lines for
    machine consumption.  With --plan
    (a ``plan --json`` file) the straggler detector compares live
    service estimates against the plan and, when --model is also given,
    a flagged stage triggers a replan suggestion."""
    from .obs.cluster import (ClusterView, StragglerDetector,
                              expected_stage_ms)

    addrs = [a for a in (args.nodes or "").split(",") if a]
    if not addrs and not args.serve:
        raise SystemExit("monitor requires --nodes host:port[,...] "
                         "and/or --serve host:port")
    # --follow is a pure event tail (implies --events); --kind narrows
    # both the tail and the table's event footer to the listed kinds
    kind_filter = {k for k in (getattr(args, "kind", "") or ""
                               ).split(",") if k}
    if kind_filter:
        from .obs.events import EVENT_KINDS
        unknown = kind_filter - set(EVENT_KINDS)
        if unknown:
            raise SystemExit(f"--kind: unknown event kind(s) "
                             f"{sorted(unknown)}; known: "
                             f"{sorted(EVENT_KINDS)}")
    follow = bool(getattr(args, "follow", False))
    if follow:
        args.events = True
    detector = plan = graph = auditor = None
    if args.plan:
        from .plan import plan_from_json
        with open(args.plan) as f:
            plan = plan_from_json(json.load(f))
        detector = StragglerDetector(expected_stage_ms(plan),
                                     factor=args.factor,
                                     sustain=args.sustain)
        if args.model:
            graph = _get_model(args.model)
            # drift auditor (obs/capacity.py): per-stage service
            # predictions ALIGNED with what the view measures (max of
            # compute / inbound decode / outbound encode, codec-only —
            # plan.calibrate.predict_stage_service_s), scored against
            # the window-bounded live estimates every interval.  The
            # cost model is the plan's own (calibrated constants
            # round-trip through plan JSON); --calibrated overlays a
            # newer artifact
            from .obs.capacity import DriftAuditor
            from .plan.calibrate import predict_stage_service_s
            from .plan.replan import cost_model_from_plan
            cost = cost_model_from_plan(graph, plan)
            if getattr(args, "calibrated", ""):
                from .plan import CalibratedConstants
                cost = CalibratedConstants.load(
                    args.calibrated).apply(cost)
            pred_ms = [s * 1e3 for s in predict_stage_service_s(
                graph, plan.cuts, plan.codecs, cost)]
            auditor = DriftAuditor(pred_ms,
                                   threshold=args.drift_threshold,
                                   sustain=args.sustain)
    view = ClusterView()
    if addrs:
        # follow mode survives node restarts: the failover supervisor
        # respawns a killed replica on its old port, so the reader
        # redials with connect_retry's jittered backoff instead of
        # exiting on the first dead socket (merge_events below dedups
        # any resumed-stream overlap on the (proc, seq) key)
        view.connect(addrs, interval_ms=args.interval_ms,
                     align_clocks=args.align,
                     timeout_s=args.connect_timeout,
                     reconnect=follow)
    door_ev_cursor = 0
    door_ev_dropped = 0
    last_dropped = 0
    try:
        i = 0
        while True:
            time.sleep(args.interval_ms / 1e3)
            i += 1
            events = None
            if args.events:
                # the merged flight-recorder log, incremental: node
                # events arrive on the obs_push stream (drained from
                # the view), the front door's over an events_since
                # observer round-trip
                from .obs.events import merge_events
                batch = view.take_events()
                if args.serve:
                    from .serve.client import fetch_events
                    h, _, p = args.serve.rpartition(":")
                    try:
                        rep = fetch_events(
                            h or "127.0.0.1", int(p),
                            cursor=door_ev_cursor,
                            timeout_s=args.connect_timeout)
                        batch += rep.get("events") or []
                        door_ev_cursor = rep.get("cursor",
                                                 door_ev_cursor)
                        door_ev_dropped = rep.get("dropped", 0)
                    except (OSError, ConnectionError):
                        pass
                events = merge_events(batch)
                if kind_filter:
                    events = [e for e in events
                              if e["kind"] in kind_filter]
            if follow:
                # tail mode: one line per merged event as it arrives —
                # a fleet-wide recompile/failover storm watched live
                # instead of re-polled; no table, no clearing
                for ev in events or []:
                    if args.json:
                        print(json.dumps(ev), flush=True)
                    else:
                        data = " ".join(
                            f"{k}={v}" for k, v in
                            sorted(ev["data"].items()))
                        print(f"{ev['t_us'] / 1e6:16.6f} "
                              f"[{ev['kind']:>14}] {ev['proc']}"
                              f"#{ev['seq']} {data}", flush=True)
                # evidence-gap footer: a tail with ring evictions is
                # NOT the whole story — say so when the count grows
                dropped = view.events_dropped + door_ev_dropped
                if dropped > last_dropped:
                    print(f"event: WARNING {dropped} events dropped "
                          f"ring-wide — the merged log has gaps "
                          f"(raise DEFER_EVENTS_CAP)", flush=True)
                    last_dropped = dropped
                if args.iterations and i >= args.iterations:
                    return
                continue
            serve_doc = None
            if args.serve:
                from .serve.client import fetch_stats
                host, _, port = args.serve.rpartition(":")
                try:
                    serve_doc = fetch_stats(host or "127.0.0.1",
                                            int(port),
                                            timeout_s=args.connect_timeout)
                except (OSError, ConnectionError) as e:
                    serve_doc = {"error": repr(e)}
            rows = view.rows()
            bott = view.bottleneck()
            flags = detector.observe(view) if detector is not None else []
            drift_flags = []
            if auditor is not None:
                drift_flags = auditor.observe(view)
                for r in rows:
                    audit = auditor.last.get(r.get("stage"))
                    if audit:
                        r.update(audit)
            suggestion = err = None
            if flags and graph is not None:
                try:
                    suggestion = detector.suggest(view, graph, plan)
                except Exception as e:  # noqa: BLE001 — advisory
                    err = repr(e)
            if args.json:
                doc = {"iteration": i, "bottleneck": bott, "rows": rows,
                       "stragglers": [f.to_json() for f in flags],
                       "drift": [f.to_json() for f in drift_flags],
                       "clock_offsets": {
                           a: round(v["offset_us"], 1)
                           for a, v in view.clock_offsets.items()}}
                if events is not None:
                    doc["events"] = events
                    doc["events_dropped"] = (view.events_dropped
                                             + door_ev_dropped)
                if serve_doc is not None:
                    serve_doc.pop("cmd", None)
                    doc["serve"] = serve_doc
                if suggestion is not None:
                    doc["replan"] = suggestion.to_json()
                elif err is not None:
                    doc["replan_error"] = err
                print(json.dumps(doc), flush=True)
            else:
                _render_monitor(rows, bott, flags, view.clock_offsets,
                                clear=i > 1, drift=drift_flags)
                if events:
                    for ev in events[-16:]:
                        data = " ".join(f"{k}={v}" for k, v in
                                        sorted(ev["data"].items()))
                        print(f"event: [{ev['kind']}] {ev['proc']}"
                              f"#{ev['seq']} {data}")
                if args.events:
                    # evidence-gap footer rides EVERY --events refresh
                    # (not only ticks that happened to render events):
                    # a nonzero total means the merged log has holes
                    dropped = view.events_dropped + door_ev_dropped
                    if dropped:
                        print(f"event: ({dropped} dropped ring-wide — "
                              f"merged log has gaps; raise "
                              f"DEFER_EVENTS_CAP)")
                if serve_doc is not None:
                    _render_serve_stats(serve_doc)
                if suggestion is not None:
                    s = suggestion
                    print(f"replan: moved={s.moved} predicted "
                          f"improvement {s.predicted_improvement:.2f}x "
                          f"(new cuts {','.join(s.new_plan.cuts) or '-'}"
                          + (f", replicas "
                             f"{getattr(s.new_plan, 'replicas', None)}"
                             if getattr(s.new_plan, "replicas", None)
                             else "") + ")")
                elif err is not None:
                    print(f"replan failed: {err}")
            if args.iterations and i >= args.iterations:
                return
    except KeyboardInterrupt:
        pass
    finally:
        view.close()


def cmd_profile(args):
    """Attach to a running chain's nodes for N seconds and produce the
    stage-interior X-ray: per node a
    ``profile_start``/``profile_stop`` bracket over the existing ctrl
    connection (the obs_subscribe pattern — no new ports) whose stop
    reply carries the window's DELTA phase breakdown
    (dispatch/device/host_sync counts + summed seconds), recompiles,
    and live device memory; optionally the sampled spans, dumped and
    clock-shifted onto THIS process's timeline (passive: the nodes'
    own anchors are never touched) and exported as one merged Perfetto
    trace.  Machine-readable JSON on stdout (or --out)."""
    import os

    from .obs import tracer
    from .obs.cluster import estimate_clock_offset
    from .runtime.node import _parse_hostport
    from .transport.framed import (K_CTRL, connect_retry, recv_expect,
                                   send_ctrl,
                                   send_end)

    addrs = [a for a in (args.nodes or "").split(",") if a]
    if not addrs:
        raise SystemExit("profile requires --nodes host:port[,...]")
    want_spans = args.spans or bool(args.trace_out)
    tr = tracer()
    conns: dict = {}
    offsets: dict = {}
    reports: dict = {}
    try:
        for addr in addrs:
            s = connect_retry(*_parse_hostport(addr),
                               timeout_s=args.connect_timeout)
            conns[addr] = s
            # passive min-RTT offset estimate per node: dumped spans
            # are shifted HERE — an observer must not re-anchor spans
            # a dispatcher may already have aligned
            offsets[addr] = estimate_clock_offset(s)
        if want_spans:
            tr.enabled = True
            tid = tr.start_trace()
            tr.process = "profiler"
            for addr, s in conns.items():
                send_ctrl(s, {"cmd": "trace", "trace_id": tid,
                              "sample_every": max(0, args.sample_every)})
        for addr, s in conns.items():
            msg: dict = {"cmd": "profile_start"}
            if args.torch_trace_dir:
                # per-node subdir: the node records the window with
                # torch.profiler and writes its Chrome trace there
                msg["trace_dir"] = os.path.join(
                    args.torch_trace_dir, addr.replace(":", "_"))
            send_ctrl(s, msg)
            rep = recv_expect(s, K_CTRL)
            if rep.get("cmd") != "profile_started":
                raise SystemExit(f"profile_start on {addr} refused: "
                                 f"{rep.get('error', rep)}")
        time.sleep(args.seconds)
        for addr, s in conns.items():
            send_ctrl(s, {"cmd": "profile_stop"})
            rep = recv_expect(s, K_CTRL)
            if rep.get("cmd") != "profile_report":
                raise SystemExit(f"profile_stop on {addr} failed: "
                                 f"{rep.get('error', rep)}")
            reports[addr] = rep["report"]
        if want_spans:
            n_spans = 0
            for addr, s in conns.items():
                send_ctrl(s, {"cmd": "trace_dump"})
                doc = recv_expect(s, K_CTRL)
                spans = doc.get("spans") or []
                off = int(round(offsets[addr]["offset_us"]))
                for sp in spans:
                    sp["ts_us"] -= off
                n_spans += len(spans)
                tr.ingest(spans)
            if n_spans == 0 and args.sample_every >= 1:
                # 1-in-N waterfall sampling keys off the wire sequence
                # stamp so every stage samples the SAME frames; a chain
                # whose dispatcher doesn't stamp (trace_sample_every=0)
                # carries no seqs and N>=1 matches nothing.  Say so
                # instead of silently writing an empty trace.
                print(f"profile: WARNING: --sample-every "
                      f"{args.sample_every} returned zero spans — "
                      f"1-in-N sampling needs sequence-stamped frames "
                      f"(a dispatcher started with trace_sample_every "
                      f">= 1).  Re-run with --sample-every 0 to record "
                      f"every frame on any stream.",
                      file=sys.stderr, flush=True)
        for s in conns.values():
            try:
                send_end(s)
            except OSError:
                pass
    finally:
        for s in conns.values():
            s.close()
    for addr, rep in reports.items():
        ph = rep.get("phases") or {}
        inf = ph.get("infer") or {}
        dsp = ph.get("dispatch") or {}
        if inf.get("sum_s"):
            # how much of the frame's wall is host-side dispatch
            rep["dispatch_share"] = round(
                (dsp.get("sum_s") or 0.0) / inf["sum_s"], 4)
        parts = " ".join(
            f"{name}={p['sum_s']:.3f}s/{p['count']}"
            for name, p in ph.items())
        print(f"{rep.get('node', addr)}: {parts} "
              f"recompiles={rep.get('recompiles')} "
              f"mem_bytes={rep.get('mem_bytes')} "
              f"kernel_launches={rep.get('kernel_launches')} "
              f"dispatch_share={rep.get('dispatch_share', '-')}",
              file=sys.stderr, flush=True)
    if args.trace_out:
        from .obs import export_chrome_trace
        export_chrome_trace(args.trace_out)
        print(f"profile: merged trace -> {args.trace_out}",
              file=sys.stderr, flush=True)
    doc = {"seconds": args.seconds, "nodes": reports,
           "clock_offsets": {a: round(v["offset_us"], 1)
                             for a, v in offsets.items()}}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"profile: breakdown -> {args.out}",
              file=sys.stderr, flush=True)
    else:
        print(json.dumps(doc), flush=True)


def cmd_models(_args) -> None:
    from . import models
    for n in models.__all__:
        obj = getattr(models, n)
        if callable(obj):
            print(n)
        else:
            print(f"{n}  (cut list, {len(obj)} cuts)")


def _apply_sock_buf(args, *, auto_bytes: int | None = None) -> None:
    """``--sock-buf N`` sizes SO_SNDBUF/SO_RCVBUF on every data socket of
    this process — and, via the environment, of any chain children.

    ``auto_bytes`` (the partition's fattest boundary frame, from
    ``graph.analysis.max_activation_bytes``) sizes the default when no
    explicit ``--sock-buf`` was given: kernel buffers scale with what
    the chain actually ships instead of a flat constant."""
    buf = getattr(args, "sock_buf", 0)
    if not buf and auto_bytes:
        from .transport.framed import default_sock_buf
        buf = default_sock_buf(auto_bytes)
        print(f"sock-buf: auto {buf} bytes "
              f"(2x max boundary frame {auto_bytes})", file=sys.stderr)
    if buf:
        from .transport import framed
        framed.SOCK_SNDBUF = framed.SOCK_RCVBUF = buf
        os.environ["DEFER_SOCK_SNDBUF"] = str(buf)
        os.environ["DEFER_SOCK_RCVBUF"] = str(buf)


def cmd_bench(args) -> None:
    """Timed-window throughput of a ring pipeline (``SpmdPipeline``): one
    capture push, then pushes of one resident chunk for ``--seconds``,
    each waited for; the JAX package's JSON line."""
    import numpy as np
    import torch

    from . import SpmdPipeline, partition
    from .obs import tracer
    from .utils.config import resolve_device

    device = resolve_device(_device_arg(args.device))
    _obs_begin(args)
    graph = _get_model(args.model)
    params = _init_params(graph)
    cuts = args.cuts.split(",") if args.cuts else None
    if cuts is not None and args.balance != "flops":
        raise SystemExit(f"--cuts and --balance {args.balance} conflict: "
                         "explicit cuts leave nothing to balance")
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if cuts is None and args.stages is None:
        # default deployment: the JAX package runs one stage per device;
        # the port's ring runs on one card, so one stage per card
        args.stages = cards
    stages = partition(graph, cuts, num_stages=args.stages,
                       objective="bottleneck"
                       if cuts is None and args.balance == "bottleneck"
                       else "quantile")
    n = len(stages)
    _no_tf32()
    # a bf16 ring on the card (the JAX package's on the accelerator), f32
    # on the CPU
    pipe = SpmdPipeline(
        stages, params, device=device, microbatch=args.microbatch,
        chunk=args.chunk, wire=args.wire,
        buffer_dtype=torch.bfloat16 if device.type == "cuda"
        else torch.float32)
    xs = pipe.stage_inputs(np.zeros(
        (args.chunk, args.microbatch) + tuple(stages[0].in_spec.shape),
        np.float32))

    def step():
        pipe.push(xs, n_real=args.chunk)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step()  # capture (a CUDA graph of the chunk on the card)
    # the capture push must not pollute the exported steady-state
    # percentiles (it is seconds; the window pushes are milliseconds)
    pipe.metrics.clear_counters()
    with tracer().span("dispatcher.bench_window",
                       {"model": args.model, "chunk": args.chunk,
                        "microbatch": args.microbatch}):
        t0 = time.perf_counter()
        iters = 0
        while time.perf_counter() - t0 < args.seconds:
            step()
            iters += 1
        dt = time.perf_counter() - t0
    ips = iters * args.chunk * args.microbatch / dt
    if args.trace_out or args.metrics_out:
        # per-stage spans + latency histograms for the exports (times the
        # deployed stages; not part of the throughput window above)
        pipe.stage_latencies(iters=3)
    print(json.dumps({
        "metric": f"{args.model}_{n}stage_throughput",
        "value": round(ips, 3), "unit": "inferences/sec",
        "wire": args.wire,
        "devices": cards,
        **pipe.metrics.as_dict()}))
    _obs_finish(args, {"pipeline": pipe.metrics.as_dict()})


def cmd_export(args) -> None:
    """One ``torch.export`` artifact per stage of the partition
    (``utils/export.py``), traced on the CPU; prints each path."""
    from . import partition
    from .utils.export import export_pipeline

    graph = _get_model(args.model)
    params = _init_params(graph)
    cuts = args.cuts.split(",") if args.cuts else None
    stages = partition(graph, cuts, num_stages=args.stages)
    paths = export_pipeline(stages, params, args.out, batch=args.batch)
    for p in paths:
        print(p)


def cmd_generate(args) -> None:
    """Pipelined autoregressive generation of random prompts: a first
    call that captures the decoder's graphs, then a timed call."""
    import numpy as np

    from .obs import REGISTRY, tracer
    from .runtime.decode import PipelinedDecoder

    graph = _get_model(args.model)
    if "lm_head" not in graph.nodes:
        raise SystemExit(f"{args.model} is not a decoder model; use one of "
                         "the gpt* families")
    params = _init_params(graph)
    vocab = graph.nodes["lm_head"].out_spec.shape[-1]
    _no_tf32()
    dec = PipelinedDecoder(graph, params, num_stages=args.stages,
                           microbatch=args.microbatch,
                           kv_cache=args.kv_cache,
                           weight_dtype=args.weight_dtype or None,
                           beam_width=args.beam,
                           device=_device_arg(args.device))
    rng = np.random.default_rng(args.seed)
    b = args.stages * (args.microbatch // args.beam)
    prompt = rng.integers(0, vocab, (b, args.prompt_len)).astype(np.int32)
    # pass everything through: incompatible combinations (e.g. beam +
    # prefill) surface as the decoder's ValueError instead of a silently
    # different configuration than the JSON record claims
    kw = dict(token_chunk=args.token_chunk, temperature=args.temperature,
              top_k=args.top_k, seed=args.seed, prefill=args.prefill)
    dec.generate(prompt, args.new_tokens, **kw)   # captures
    # steady-state exports only: drop the first run's decode samples and
    # enable tracing for the warm run
    REGISTRY.histogram("decode.dispatch_s").clear()
    REGISTRY.counter("decode.dispatches").n = 0
    _obs_begin(args)
    t0 = time.perf_counter()
    with tracer().span("generate", {"model": args.model,
                                    "new_tokens": args.new_tokens}):
        toks = dec.generate(prompt, args.new_tokens, **kw)   # warm
    dt = time.perf_counter() - t0
    print(json.dumps({
        "model": args.model, "stages": args.stages,
        "batch": b, "prompt_len": args.prompt_len,
        "new_tokens": args.new_tokens, "prefill": args.prefill,
        "kv_cache": args.kv_cache, "beam": args.beam,
        "weight_dtype": args.weight_dtype or "compute",
        "tokens_per_s": round(b * args.new_tokens / dt, 2),
        "first_row": toks[0].tolist(),
    }))
    _obs_finish(args)


def _parse_tenant_specs(specs) -> list:
    """``name=weight[:priority[:deadline_ms]]`` (repeatable) ->
    TenantConfig list."""
    from .serve import TenantConfig
    out = []
    for spec in specs or []:
        name, sep, rest = spec.partition("=")
        if not sep or not name:
            raise SystemExit(f"--tenant: {spec!r} is not "
                             f"name=weight[:priority[:deadline_ms]]")
        parts = rest.split(":")
        try:
            out.append(TenantConfig(
                name=name, weight=float(parts[0] or 1.0),
                priority=int(parts[1]) if len(parts) > 1 and parts[1]
                else 0,
                deadline_ms=float(parts[2])
                if len(parts) > 2 and parts[2] else None))
        except ValueError as e:
            raise SystemExit(f"--tenant {spec!r}: {e}")
    return out


def cmd_serve(args) -> None:
    """The serving front door: accept many concurrent client streams,
    admit under per-tenant weighted-fair queuing with SLO-aware shedding,
    coalesce admitted samples across tenants into frames of ``--width``
    (from the planner's latency budget with ``--budget-ms``), and
    multiplex them onto one deployed chain (tensor mode) or a
    continuous-batching decode engine (``--workload decode``)."""
    import threading

    from . import partition
    from .serve import ServeFrontDoor
    from .serve.frontdoor import ChainBackend

    graph = _get_model(args.model)
    params = _init_params(graph)
    tenants = _parse_tenant_specs(args.tenant)
    device = _device_arg(args.device)
    _start_prom(args, "serve")
    # request-scoped tracing composes with serving: --trace-out enables
    # the tracer, --trace-sample N samples whole REQUESTS 1-in-N (every
    # frame of a sampled request traces end to end across the front door
    # AND every stage process)
    _obs_begin(args, process="serve")
    _no_tf32()
    ext_addrs: list[str] = []

    if args.workload == "decode":
        from .serve import ContinuousBatchEngine
        if "lm_head" not in graph.nodes:
            raise SystemExit(f"{args.model} is not a decoder model; "
                             "--workload decode needs a gpt* family")
        width = args.width or 4
        engine = ContinuousBatchEngine(graph, params,
                                       num_stages=args.stages,
                                       width=width, device=device)
        door = ServeFrontDoor(
            engine=engine, listen=args.listen, tenants=tenants,
            decode_defaults={"max_new_tokens": args.max_new})
        cleanup = lambda: None  # noqa: E731
    else:
        cuts = args.cuts.split(",") if args.cuts else None
        stages = partition(graph, cuts, num_stages=args.stages)
        cut_names = [s.output_name for s in stages[:-1]]
        width = args.width
        if args.budget_ms:
            # dynamic-microbatch width from the planner's cost model:
            # the largest frame batch whose slowest stage stays inside
            # the per-stage latency budget
            from .plan import max_batch_within_budget
            cm = _cost_model(args, graph)
            width = max_batch_within_budget(
                graph, cut_names, cm, args.budget_ms,
                cap=args.max_width)
            print(f"serve: width {width} from --budget-ms "
                  f"{args.budget_ms:g}", file=sys.stderr, flush=True)
        width = width or 4
        hop_codecs = [c for c in args.hop_codecs.split(",") if c] or None
        from .runtime.node import ChainDispatcher
        if args.nodes:
            addrs = [a for a in args.nodes.split(",") if a]
            if len(addrs) != len(stages):
                raise SystemExit(f"{len(stages)} stages but "
                                 f"{len(addrs)} --nodes")
            disp = ChainDispatcher(addrs[0], codec=args.codec)
            disp.deploy(stages, params, addrs, batch=width,
                        codecs=hop_codecs)
            ext_addrs = addrs
            from .obs import tracer
            if tracer().enabled:
                # external stage processes: re-anchor their tracers so
                # a sampled request's cross-process waterfall lands on
                # one Perfetto timeline
                disp.align_clocks(addrs)
            cleanup = lambda: None  # noqa: E731 — nodes are external
        else:
            # self-contained deployment: thread-per-stage nodes in this
            # process (run `node` per host + --nodes for a real
            # multi-process chain)
            from .runtime.node import StageNode
            nodes = [StageNode(None, "127.0.0.1:0", None, device=device)
                     for _ in stages]
            addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
            threads = [threading.Thread(target=n.serve, daemon=True)
                       for n in nodes]
            for t in threads:
                t.start()
            disp = ChainDispatcher(addrs[0], codec=args.codec)
            disp.deploy(stages, params, addrs, batch=width,
                        codecs=hop_codecs)

            def cleanup(_threads=threads):
                for t in _threads:
                    t.join(timeout=10)
        backend = ChainBackend(disp, width,
                               tuple(stages[0].in_spec.shape),
                               window=args.window,
                               trace_sample_every=args.trace_sample)
        door = ServeFrontDoor(backend=backend, listen=args.listen,
                              tenants=tenants,
                              gather_s=args.gather_ms / 1e3)
    door.start()
    if args.journal_dir:
        # the front door is a fleet member too: its admission/shed
        # events and pressure snapshots belong in the black box
        from .obs import start_journal

        def _serve_row(_door=door):
            return {"pressure": _door.pressure(),
                    "stats": _door.stats()}

        start_journal(args.journal_dir, "serve", snapshot_fn=_serve_row)
    print(json.dumps({"serving": f"{door.address[0]}:{door.address[1]}",
                      "mode": door.mode, "width": door.width,
                      "model": args.model, "stages": args.stages}),
          flush=True)
    try:
        deadline = time.monotonic() + args.seconds if args.seconds > 0 \
            else None
        while deadline is None or time.monotonic() < deadline:
            time.sleep(0.5 if deadline is None
                       else min(0.5, max(0.0,
                                         deadline - time.monotonic())))
            # a dead backend/engine loop must fail the process, not
            # silently serve nothing until the timer runs out
            door.healthcheck()
    except KeyboardInterrupt:
        pass
    except BaseException as e:
        if args.journal_dir:
            # a dead backend/engine is exactly what the black box is
            # for: final-spill, then bundle synchronously before dying
            from .obs import maybe_autopsy, stop_journal
            stop_journal()
            maybe_autopsy(f"serve: {type(e).__name__}: {e}",
                          journal_dir=args.journal_dir, sync=True,
                          delay_s=0.0)
        raise
    finally:
        from .obs import tracer
        if tracer().enabled and ext_addrs:
            # stitch the external stage processes' spans in while they
            # are still alive (in-process thread nodes already share
            # this tracer, so only --nodes chains need the collection)
            try:
                disp.collect_trace(ext_addrs)
            except Exception as e:  # noqa: BLE001 — advisory
                print(f"serve: trace collection failed: {e!r}",
                      file=sys.stderr, flush=True)
        door.stop()
        cleanup()
        if args.journal_dir:
            from .obs import stop_journal
            stop_journal()
        _obs_finish(args)
        print(json.dumps({"final_stats": door.stats()}), flush=True)


def cmd_serve_client(args) -> None:
    """Load-generating client: play a deterministic open-loop Poisson
    arrival trace (optional burst phases) against a front door and print
    the latency/shed summary."""
    import numpy as np

    from .serve import LoadGenerator, ServeClient, poisson_trace

    host, _, port = args.connect.rpartition(":")
    bursts = []
    for spec in args.burst or []:
        t0, t1, mult = spec.split(":")
        bursts.append((float(t0), float(t1), float(mult)))
    offsets = poisson_trace(args.rate, args.seconds, seed=args.seed,
                            bursts=bursts or None)
    rng = np.random.default_rng(args.seed)
    hello = {}
    if args.max_new:
        hello["max_new_tokens"] = args.max_new
    if args.prompt_len:
        samples = [rng.integers(0, args.vocab, (args.prompt_len,))
                   .astype(np.int32) for _ in range(max(1, len(offsets)))]
    else:
        shape = tuple(int(d) for d in args.sample_shape.split(",") if d)
        samples = [rng.standard_normal(shape).astype(np.float32)
                   for _ in range(max(1, min(64, len(offsets))))]
    client = ServeClient(host or "127.0.0.1", int(port), args.tenant,
                         weight=args.weight, priority=args.priority,
                         deadline_ms=args.deadline_ms or None, **hello)
    print(json.dumps(LoadGenerator(client, samples, offsets).run()),
          flush=True)


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
    p.add_argument("--sock-buf", type=int, default=0, metavar="BYTES",
                   help="SO_SNDBUF/SO_RCVBUF for every data socket "
                        "(0 = kernel default for `node`; `chain` sizes "
                        "it to the partition's fattest boundary frame)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m defer_tpu_torch",
        description="DEFER's pipelined DNN inference, in PyTorch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("models", help="list the model zoo")

    b = sub.add_parser("bench", help="timed pipeline throughput")
    b.add_argument("--model", default="resnet_tiny")
    b.add_argument("--stages", type=int,
                   help="stage count for automatic cuts (default: one "
                        "per card, one on the CPU)")
    b.add_argument("--cuts")
    b.add_argument("--balance", choices=["flops", "bottleneck"],
                   default="flops",
                   help="auto-cut objective for --stages (bottleneck: "
                        "the comm-aware exact solver)")
    b.add_argument("--chunk", type=int, default=16)
    b.add_argument("--microbatch", type=int, default=1)
    b.add_argument("--wire", default="buffer", choices=["buffer", "int8"])
    b.add_argument("--seconds", type=float, default=5.0)
    b.add_argument("--device", default="cuda",
                   help="where the ring runs: cuda (the default; a bf16 "
                        "ring), cuda:N, a card index, or cpu (an f32 "
                        "ring)")
    _add_obs_flags(b)

    e = sub.add_parser("export", help="write per-stage torch.export "
                                      "artifacts")
    e.add_argument("--model", required=True)
    e.add_argument("--stages", type=int)
    e.add_argument("--cuts")
    e.add_argument("--out", required=True)
    e.add_argument("--batch", type=int, default=1)

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
    nd.add_argument("--prom-port", type=int, default=None, metavar="PORT",
                    help="serve this process's metrics registry as a "
                         "Prometheus scrape endpoint on PORT (0 = "
                         "ephemeral, printed to stderr)")
    nd.add_argument("--journal-dir", default="", metavar="DIR",
                    help="black-box flight recorder: spill this "
                         "process's events, obs-row snapshots and sampled "
                         "spans to a crash-safe on-disk journal under DIR "
                         "(segment ring, per-record CRC, clock anchors), "
                         "readable by `postmortem DIR` after any death")
    _add_overlap_flags(nd)
    _add_obs_flags(nd)

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
    c.add_argument("--prom-port", type=int, default=None, metavar="PORT",
                   help="serve the dispatcher process's metrics registry "
                        "as a Prometheus scrape endpoint")
    c.add_argument("--journal-dir", default="", metavar="DIR",
                   help="black-box flight recorder: every stage process "
                        "and the dispatcher journal their telemetry under "
                        "DIR; a failover respawn or a chain failure "
                        "assembles a postmortem bundle with a first-fault "
                        "verdict, and `postmortem DIR` does it on demand")
    _add_overlap_flags(c)
    _add_obs_flags(c)

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

    mo = sub.add_parser("monitor", help="live top-style view of a "
                                        "running chain's obs_push "
                                        "telemetry")
    mo.add_argument("--nodes", default="", metavar="host:port,...",
                    help="the chain nodes' listen addresses (same list "
                         "`stats`/deploy use)")
    mo.add_argument("--interval-ms", type=float, default=500.0,
                    help="push + refresh cadence (each node reports at "
                         "this interval)")
    mo.add_argument("--iterations", type=int, default=0, metavar="N",
                    help="refresh N times then exit (0 = run until ^C)")
    mo.add_argument("--json", action="store_true",
                    help="one JSON line per refresh (rows, bottleneck, "
                         "stragglers) instead of the table")
    mo.add_argument("--plan", metavar="PLAN_JSON",
                    help="a `plan --json` file: enables the straggler "
                         "detector against the plan's per-stage "
                         "expectations")
    mo.add_argument("--model", default=None,
                    help="with --plan: rebuild the layer graph so a "
                         "flagged straggler emits a replan suggestion")
    mo.add_argument("--factor", type=float, default=1.5,
                    help="straggler threshold: live service estimate > "
                         "factor x planned, sustained")
    mo.add_argument("--sustain", type=int, default=2,
                    help="reporting intervals a deviation must hold "
                         "before it is flagged")
    mo.add_argument("--calibrated", default="", metavar="FILE",
                    help="with --plan and --model: overlay a "
                         "CalibratedConstants artifact (`chain "
                         "--emit-calibration`) on the plan's cost "
                         "model before computing the drift auditor's "
                         "per-stage predictions")
    mo.add_argument("--drift-threshold", type=float, default=0.25,
                    help="with --plan and --model: |measured - "
                         "predicted| / predicted past this, sustained "
                         "--sustain intervals, flags the stage and "
                         "emits a model_drift event")
    mo.add_argument("--serve", default="", metavar="host:port",
                    help="also poll a serve front door's stats endpoint "
                         "and render per-tenant columns (admitted / "
                         "shed / queue-delay percentiles / SLO "
                         "attainment / attribution buckets)")
    mo.add_argument("--events", action="store_true",
                    help="render the merged flight-recorder event log "
                         "(sheds, tier negotiations/fallbacks, "
                         "straggler flags, replan suggestions, node "
                         "deaths, stream/client lifecycle) from every "
                         "watched node's obs_push stream and — with "
                         "--serve — the front door's events_since "
                         "endpoint")
    mo.add_argument("--kind", default="", metavar="a,b",
                    help="with --events/--follow: only render events of "
                         "the listed kinds (comma-separated; e.g. "
                         "recompile,mem_pressure,failover)")
    mo.add_argument("--follow", action="store_true",
                    help="event tail mode (implies --events): one line "
                         "per merged flight-recorder event as it "
                         "arrives, no table — watch a fleet-wide "
                         "recompile/failover storm live")
    mo.add_argument("--align", action="store_true",
                    help="actively clock-ALIGN every node's tracer to "
                         "this process (default: passively estimate "
                         "offsets only — an observer must not re-anchor "
                         "spans the dispatcher already aligned)")
    mo.add_argument("--connect-timeout", type=float, default=30.0)

    pm = sub.add_parser("postmortem",
                        help="assemble a forensics bundle (merged "
                             "timeline, Perfetto trace, last-known "
                             "rows, first-fault verdict) from the "
                             "black-box journals under a --journal-dir "
                             "— works on dead processes")
    pm.add_argument("dir", metavar="JOURNAL_DIR",
                    help="the --journal-dir a node/chain/serve wrote")
    pm.add_argument("--out", default="", metavar="DIR",
                    help="bundle output directory (default: a "
                         "bundle-<stamp> dir inside JOURNAL_DIR)")
    pm.add_argument("--last-s", type=float, default=30.0,
                    help="Perfetto window: keep the final N seconds "
                         "of spans/events in trace.json")
    pm.add_argument("--reason", default="manual",
                    help="reason recorded in the bundle")

    pr = sub.add_parser("profile", help="attach to a running chain for "
                                        "N seconds: per-stage phase "
                                        "breakdown (dispatch/device/"
                                        "host_sync), recompile + "
                                        "memory telemetry, optional "
                                        "merged Perfetto trace")
    pr.add_argument("--nodes", required=True, metavar="host:port,...",
                    help="the chain nodes' listen addresses (same list "
                         "`stats`/monitor use)")
    pr.add_argument("--seconds", type=float, default=5.0,
                    help="profiled window length")
    pr.add_argument("--out", default="", metavar="FILE",
                    help="write the per-stage phase-breakdown JSON "
                         "here (default: one JSON line on stdout)")
    pr.add_argument("--spans", action="store_true",
                    help="also collect each node's spans (trace + "
                         "trace_dump) onto one clock-aligned timeline")
    pr.add_argument("--trace-out", default="", metavar="FILE",
                    help="export the merged timeline as Chrome/"
                         "Perfetto trace JSON (implies --spans)")
    pr.add_argument("--sample-every", type=int, default=0,
                    help="span sampling: record every Nth wire "
                         "sequence (0 = every frame — the window is "
                         "short)")
    pr.add_argument("--torch-trace-dir", default="", metavar="DIR",
                    help="ask each node to record the window with "
                         "torch.profiler and write its Chrome trace under "
                         "DIR/<addr> (kernels on the card included)")
    pr.add_argument("--connect-timeout", type=float, default=30.0)

    sv = sub.add_parser("serve", help="multi-tenant serving front door: "
                                      "admission + continuous batching "
                                      "+ SLO shedding over one chain")
    sv.add_argument("--model", default="resnet_tiny")
    sv.add_argument("--stages", type=int, default=3)
    sv.add_argument("--cuts")
    sv.add_argument("--workload", choices=["tensor", "decode"],
                    default="tensor",
                    help="tensor: samples through the deployed chain; "
                         "decode: continuous-batching autoregressive "
                         "generation (gpt* models, prompts in / token "
                         "ids out)")
    sv.add_argument("--listen", default="127.0.0.1:0",
                    metavar="[host]:port")
    sv.add_argument("--nodes", default="", metavar="host:port,...",
                    help="deploy onto these already-running stage nodes "
                         "(one per stage); default: thread-per-stage "
                         "nodes inside this process")
    sv.add_argument("--width", type=int, default=0, metavar="W",
                    help="microbatch width (slots per frame); 0 = from "
                         "--budget-ms, else 4")
    sv.add_argument("--budget-ms", type=float, default=0.0,
                    help="per-stage latency budget: width becomes the "
                         "largest batch whose slowest stage stays "
                         "inside it (plan.max_batch_within_budget)")
    sv.add_argument("--max-width", type=int, default=64)
    sv.add_argument("--batch", type=int, default=1,
                    help="cost-model batch for --budget-ms sizing")
    sv.add_argument("--window", type=int, default=8,
                    help="formed frames in flight inside the chain")
    sv.add_argument("--gather-ms", type=float, default=0.0,
                    help="how long a partial frame waits for company "
                         "(0 = never: the pipeline is the batching "
                         "window)")
    sv.add_argument("--codec", default="raw")
    sv.add_argument("--hop-codecs", default="", metavar="C0,C1,...",
                    help="per-stage outbound hop codecs for the "
                         "deployed chain")
    sv.add_argument("--tenant", action="append", default=[],
                    metavar="NAME=W[:PRI[:DEADLINE_MS]]",
                    help="pre-configure a tenant (repeatable): WFQ "
                         "weight, strict priority, per-sample SLO")
    sv.add_argument("--max-new", type=int, default=16,
                    help="decode mode: default tokens per request")
    sv.add_argument("--seconds", type=float, default=0.0,
                    help="serve for N seconds then exit (0 = forever)")
    sv.add_argument("--device", default="cuda",
                    help="where the in-process stage nodes or the decode "
                         "engine run: cuda (the default), cuda:N, a card "
                         "index, or cpu (--nodes run where they run)")
    sv.add_argument("--prom-port", type=int, default=None, metavar="PORT",
                    help="serve this process's metrics registry — front-"
                         "door admission/shed/completion counters and "
                         "per-tenant histograms included — as a "
                         "Prometheus scrape endpoint on PORT")
    sv.add_argument("--trace-sample", type=int, default=0, metavar="N",
                    help="with --trace-out: request-scoped waterfall "
                         "sampling — 1-in-N formed frames (and every "
                         "request riding them) record spans end to end "
                         "across the front door and every stage "
                         "process, on one clock-aligned timeline")
    sv.add_argument("--journal-dir", default="", metavar="DIR",
                    help="black-box flight recorder: journal the front "
                         "door's events and pressure snapshots under "
                         "DIR; a failed healthcheck auto-emits a "
                         "postmortem bundle")
    _add_obs_flags(sv)
    _add_cost_flags(sv)

    sc = sub.add_parser("serve-client", help="open-loop load generator "
                                             "against a serve front "
                                             "door (Poisson + bursts)")
    sc.add_argument("--connect", required=True, metavar="host:port")
    sc.add_argument("--tenant", default="default")
    sc.add_argument("--weight", type=float, default=1.0)
    sc.add_argument("--priority", type=int, default=0)
    sc.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-sample SLO carried in the hello (0 = "
                         "no deadline)")
    sc.add_argument("--rate", type=float, default=20.0,
                    help="mean arrival rate (Hz)")
    sc.add_argument("--seconds", type=float, default=5.0)
    sc.add_argument("--seed", type=int, default=0)
    sc.add_argument("--burst", action="append", default=[],
                    metavar="T0:T1:MULT",
                    help="burst phase: MULTx the base rate over "
                         "[T0, T1) seconds (repeatable)")
    sc.add_argument("--sample-shape", default="32,32,3",
                    help="tensor mode: one sample's shape")
    sc.add_argument("--prompt-len", type=int, default=0,
                    help="decode mode: send random prompts of this "
                         "length instead of tensors")
    sc.add_argument("--vocab", type=int, default=97)
    sc.add_argument("--max-new", type=int, default=0,
                    help="decode mode: tokens per request (rides the "
                         "hello)")

    g = sub.add_parser("generate", help="pipelined autoregressive "
                                        "generation demo (gpt models)")
    g.add_argument("--model", default="gpt_tiny")
    g.add_argument("--stages", type=int, default=4)
    g.add_argument("--microbatch", type=int, default=2)
    g.add_argument("--prompt-len", type=int, default=4)
    g.add_argument("--new-tokens", type=int, default=8)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=None)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--prefill", action="store_true",
                   help="fused full-sequence prompt prefill")
    g.add_argument("--token-chunk", type=int, default=None)
    g.add_argument("--kv-cache", default="buffer",
                   choices=["buffer", "int8"],
                   help="int8: quantized KV cache (~1 byte/value reads)")
    g.add_argument("--weight-dtype", default="",
                   choices=["", "int8"],
                   help="int8: W8A16 weight-only quantization "
                        "(channel-wise scales, dequant fused per stage)")
    g.add_argument("--beam", type=int, default=1,
                   help="beam width (must divide --microbatch)")
    g.add_argument("--device", default="cuda",
                   help="where the decoder runs: cuda (the default), "
                        "cuda:N, a card index, or cpu")
    _add_obs_flags(g)

    args = ap.parse_args(argv)
    {"models": cmd_models, "bench": cmd_bench, "export": cmd_export,
     "node": cmd_node, "chain": cmd_chain, "partition": cmd_partition,
     "plan": cmd_plan, "monitor": cmd_monitor, "profile": cmd_profile,
     "postmortem": cmd_postmortem, "serve": cmd_serve,
     "serve-client": cmd_serve_client,
     "generate": cmd_generate}[args.cmd](args)


if __name__ == "__main__":
    main()
