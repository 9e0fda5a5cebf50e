"""Live observability smoke: the push plane closes the loop while the
stream is in flight.

A 3-stage resnet_tiny chain gets a delay-bound middle stage (decode-side
sleep on its inbound hop, encode-side sleep on its outbound hop — the
resource profile of an accelerator-bound stage this 1-core host cannot
express with real compute, as in ``torch_replication_smoke.py``).  While the
stream runs, the ``defer_tpu_torch monitor`` plane (obs_subscribe ->
per-node obs_push frames -> ClusterView) must see it:

1. LIVE ROWS: ``defer_tpu_torch monitor --json`` against the running chain
   reports per-stage rows (>= 2 pushes each) whose counts and
   percentiles CONVERGE to the nodes' own ``stats`` replies.
2. BOTTLENECK: the monitor's bottleneck id names the delay-bound stage.
3. STRAGGLER -> REPLAN: against a baseline-corrected plan (analytic
   plan corrected by a no-delay calibration run's live telemetry), the
   detector flags the delay stage after exactly ``--sustain`` (2)
   reporting intervals, and the replan suggestion's largest correction
   names that stage.
4. WATERFALL + CLOCKS: with ``trace_sample_every`` the sampled frames'
   per-stage infer spans — recorded in different OS processes in full
   mode, clock-aligned via the min-RTT ``clock_adjust`` handshake —
   form a waterfall with NO negative inter-stage gaps on one Perfetto
   timeline (exported to prove it).
5. OVERHEAD: streaming wall with full telemetry (tracing + sampling +
   reporter pushes + a live monitor subscriber) vs the same chain with
   everything off differs by < ``--max-overhead`` (default 5%); outputs
   stay byte-identical.

``--quick`` runs the chain in-process (thread nodes, real TCP sockets —
the CI mode); the default spawns real OS processes per stage.  Exit 0 on
success; one JSON row on stdout (the ``obs_overhead`` row of
``benchmarks/run.py``).

The PyTorch port's copy of ``scripts/monitor_smoke.py``: the same checks,
flags, bounds and row, run on ``--device`` (the card by default; the node
processes it spawns run there too).
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)



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


def chain_opts() -> dict:
    """:func:`node_opts` as ``run_chain``'s keyword arguments."""
    return {**node_opts(), "device": str(DEVICE)}


def node_env() -> dict:
    """A node process's environment: this one's, with the repository on
    ``PYTHONPATH`` so ``python -m defer_tpu_torch`` finds the port."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def hop_codecs(delay_ms: float) -> list[str]:
    """Park the whole delay budget inside stage 1's process: decode-side
    sleep on its inbound hop, encode-side sleep on its outbound hop."""
    if delay_ms <= 0:
        return ["raw", "raw", "raw"]
    return [f"dsleep{delay_ms:g}+raw", f"esleep{delay_ms:g}+raw", "raw"]


class Chain:
    """One booted 3-stage chain (thread nodes or OS processes)."""

    def __init__(self, disp, addrs, *, procs=None, logs=None,
                 threads=None):
        self.disp = disp
        self.addrs = addrs
        self._procs = procs or []
        self._logs = logs or []
        self._threads = threads or []
        self.failed = False

    def close(self):
        from defer_tpu_torch.runtime.node import _kill_procs
        try:
            if self.failed:
                _kill_procs(self._procs)
            self.disp.close()
            if not self.failed:
                for pr in self._procs:
                    try:
                        pr.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        pr.kill()
            for t in self._threads:
                t.join(timeout=30)
        finally:
            for lf in self._logs:
                lf.close()


def boot_inproc(stages, params, codecs, *, batch, sample=0) -> Chain:
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode
    nodes = [StageNode(None, "127.0.0.1:0", None, **node_opts()) for _ in range(3)]
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    threads = [threading.Thread(target=n.serve, daemon=True)
               for n in nodes]
    for t in threads:
        t.start()
    disp = ChainDispatcher(addrs[0], codec="raw",
                           trace_sample_every=sample)
    disp.deploy(stages, params, addrs, batch=batch, codecs=codecs)
    return Chain(disp, addrs, threads=threads)


def boot_procs(paths, codecs, *, log_dir, tag, sample=0) -> Chain:
    from defer_tpu_torch.runtime.node import ChainDispatcher, _await_binds
    from defer_tpu_torch.runtime.node import _free_ports
    ports = _free_ports(4)
    addrs = [f"127.0.0.1:{p}" for p in ports[:3]]
    result = f"127.0.0.1:{ports[3]}"
    child_env = node_env()
    procs, logs = [], []
    for k in range(3):
        nxt = addrs[k + 1] if k < 2 else result
        # --tier tcp: this row measures the OBSERVABILITY plane over a
        # delay-bound wire chain; an auto-negotiated shm hop would
        # bypass the dsleep/esleep codecs the straggler story rests on
        argv = [sys.executable, "-m", "defer_tpu_torch", "node", *node_flags(),
                "--artifact", paths[k], "--listen", addrs[k],
                "--next", nxt, "--codec", codecs[k], "--tier", "tcp"]
        lf = open(os.path.join(log_dir, f"{tag}_node_{k}.log"), "w+")
        logs.append(lf)
        procs.append(subprocess.Popen(argv, env=child_env, stdout=lf,
                                      stderr=subprocess.STDOUT))
    _await_binds(procs, [f"stage{k}" for k in range(3)], logs, addrs)
    disp = ChainDispatcher(addrs[0], listen=result, codec="raw",
                           trace_sample_every=sample)
    return Chain(disp, addrs, procs=procs, logs=logs)


def run_monitor_json(addrs, *, interval_ms, iterations, plan_file=None,
                     model=None, out: dict | None = None):
    """Invoke the REAL CLI (`defer_tpu_torch monitor --json`) and return its
    parsed output lines."""
    from defer_tpu_torch import cli
    argv = ["monitor", "--nodes", ",".join(addrs),
            "--interval-ms", str(interval_ms),
            "--iterations", str(iterations), "--json"]
    if plan_file:
        argv += ["--plan", plan_file, "--model", model or "resnet_tiny"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    docs = [json.loads(line) for line in buf.getvalue().strip()
            .splitlines() if line]
    if out is not None:
        out["docs"] = docs
    return docs


def service_from_stats(stats) -> dict[int, float]:
    """Per-stage live service ms from stats replies: the slowest of the
    decode / infer / encode phase p50s (each phase owns a thread)."""
    def p50(s):
        return (s or {}).get("p50", 0.0) * 1e3 if (s or {}).get("count") \
            else 0.0
    out = {}
    for row in stats:
        if row.get("stage") is None:
            continue
        out[row["stage"]] = max(p50(row.get("infer_latency_s")),
                                p50(row.get("decode_latency_s")),
                                p50(row.get("encode_latency_s")))
    return out


def baseline_plan(graph, stages, measured_ms: dict[int, float]):
    """The 'active plan' the straggler detector compares against: the
    deployment's cuts, corrected so each stage's predicted cost matches
    the no-delay calibration run — the honest expectation a live
    deviation is measured from."""
    from defer_tpu_torch.plan import (StageCostModel, cost_model_from_plan,
                                evaluate_cuts, replan)
    cuts = [s.output_name for s in stages[:-1]]
    n = len(graph.topo_order)
    cm = StageCostModel(graph, gen="v4", link_bw_s=1e9,
                        node_costs={m: 1e-4 for m in graph.topo_order})
    rough = evaluate_cuts(graph, cuts, cm)
    rp = replan(graph, rough,
                {k: max(v, 1e-3) / 1e3 for k, v in measured_ms.items()},
                cost_model_from_plan(graph, rough))
    log(f"baseline plan: measured {measured_ms} -> corrected "
        f"stage_cost_ms {rp.old_plan_corrected.to_json()['stage_cost_ms']}"
        f" ({n} nodes)")
    return rp.old_plan_corrected


def waterfall_gaps(spans, sample_every: int) -> tuple[int, list[float]]:
    """Min inter-stage gap (us) across every sampled frame's infer
    waterfall: stage k+1's infer must start at or after stage k's infer
    END on the shared clock-aligned timeline."""
    by_seq: dict[int, dict[int, dict]] = {}
    for s in spans:
        name = s["name"]
        if not name.endswith(".infer") or not name.startswith("stage"):
            continue
        k = int(name.split(".")[0][len("stage"):])
        seq = s["args"].get("seq")
        if seq is None:
            continue
        by_seq.setdefault(seq, {})[k] = s
    gaps = []
    complete = 0
    for seq, stages_of in sorted(by_seq.items()):
        if len(stages_of) < 3:
            continue
        complete += 1
        for k in range(2):
            a, b = stages_of[k], stages_of[k + 1]
            gaps.append(b["ts_us"] - (a["ts_us"] + a["dur_us"]))
    return complete, gaps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="in-process thread chain (CI mode, no spawns)")
    ap.add_argument("--count", type=int, default=48,
                    help="timed microbatches per measured stream")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--delay-ms", type=float, default=10.0,
                    help="per-side delay on the bottleneck stage's hops")
    ap.add_argument("--interval-ms", type=float, default=150.0,
                    help="obs_push reporting interval")
    ap.add_argument("--sustain", type=int, default=2,
                    help="intervals a deviation must hold to be flagged")
    ap.add_argument("--max-overhead", type=float, default=0.05,
                    help="telemetry wall overhead bound vs all-off")
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:N, cpu, or an index N")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = pick_device(args.device)
    sys.setswitchinterval(SWITCH_INTERVAL_S)

    import numpy as np

    import torch

    from defer_tpu_torch import partition
    from defer_tpu_torch.models import resnet_tiny
    from defer_tpu_torch.obs import tracer
    from defer_tpu_torch.obs.cluster import expected_stage_ms
    from defer_tpu_torch.utils.export import export_pipeline

    graph = resnet_tiny()
    params = graph.init(torch.Generator().manual_seed(0))
    stages = partition(graph, num_stages=3)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((args.batch, 32, 32, 3)).astype(np.float32)
          for _ in range(args.count)]
    delays = hop_codecs(args.delay_ms)
    tr = tracer()

    with tempfile.TemporaryDirectory(prefix="defer_mon_") as tmp:
        paths = None
        if not args.quick:
            paths = export_pipeline(stages, params, tmp, batch=args.batch)

        def boot(codecs, tag, sample=0):
            if args.quick:
                return boot_inproc(stages, params, codecs,
                                   batch=args.batch, sample=sample)
            return boot_procs(paths, codecs, log_dir=tmp, tag=tag,
                              sample=sample)

        # -- calibration: a no-delay run's live telemetry IS the plan's
        # expectation (always in-process: it measures this host's
        # per-stage compute, which is what the plan should predict)
        tr.enabled = False
        chain = boot_inproc(stages, params, hop_codecs(0),
                            batch=args.batch)
        try:
            chain.disp.stream(xs[:4])          # compile + connect
            chain.disp.stream(xs)
            base_ms = service_from_stats(chain.disp.stats(chain.addrs))
        finally:
            chain.close()
        plan = baseline_plan(graph, stages, base_ms)
        plan_file = os.path.join(tmp, "plan.json")
        with open(plan_file, "w") as f:
            json.dump(plan.to_json(), f)

        # -- overhead experiment: TWO identical delay chains, streamed
        # ALTERNATELY — "off" never sees telemetry, "on" runs tracing +
        # 1-in-4 waterfall sampling + clock alignment + per-node
        # reporters + a live monitor subscriber.  Interleaving makes
        # each off/on pair see the same background load, so host drift
        # (which on this 1-core box dwarfs the telemetry tax between
        # two separated measurement phases) cancels; min-of-3 absorbs
        # per-stream scheduler spikes on top.
        sample_every = 4
        tr.enabled = False
        chain_off = boot(delays, "off")
        chain_on = boot(delays, "on", sample=sample_every)
        mon: dict = {}
        final_docs = live_docs = None
        try:
            chain_off.disp.stream(xs[:4])
            tr.clear()
            tr.enabled = True
            tr.process = "dispatcher"
            tr.start_trace()
            offsets = chain_on.disp.align_clocks(chain_on.addrs)
            chain_on.disp.stream(xs[:4])
            mt = threading.Thread(
                target=run_monitor_json, args=(chain_on.addrs,),
                kwargs=dict(interval_ms=args.interval_ms,
                            iterations=40, plan_file=plan_file,
                            model="resnet_tiny", out=mon), daemon=True)
            mt.start()
            w_off, w_on = [], []
            for _ in range(3):
                tr.enabled = False
                t0 = time.perf_counter()
                outs_off = chain_off.disp.stream(xs)
                w_off.append(time.perf_counter() - t0)
                tr.enabled = True
                t0 = time.perf_counter()
                outs_on = chain_on.disp.stream(xs)
                w_on.append(time.perf_counter() - t0)
            wall_off, wall_on = min(w_off), min(w_on)
            mt.join(timeout=120)
            assert not mt.is_alive(), "monitor CLI did not finish"
            live_docs = mon["docs"]
            stats_on = chain_on.disp.stats(chain_on.addrs)
            # a fresh one-shot monitor AFTER the stream: the converged
            # snapshot compared against the nodes' own stats replies
            final_docs = run_monitor_json(
                chain_on.addrs, interval_ms=args.interval_ms,
                iterations=2, plan_file=plan_file, model="resnet_tiny")
            chain_on.disp.collect_trace(chain_on.addrs)
        except BaseException:
            chain_off.failed = chain_on.failed = True
            raise
        finally:
            tr.enabled = True  # chain_on teardown spans are harmless
            chain_off.close()
            chain_on.close()
        log(f"telemetry off: {args.count * args.batch / wall_off:7.1f} "
            f"inf/s ({wall_off:.3f}s)")
        log(f"telemetry on:  {args.count * args.batch / wall_on:7.1f} "
            f"inf/s ({wall_on:.3f}s, {len(live_docs)} live monitor "
            f"frames)")

        # 5a. telemetry must not corrupt the stream
        assert len(outs_on) == len(outs_off) == args.count
        for a, b in zip(outs_off, outs_on):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        # 1. live rows appeared while streaming and converge to stats
        assert live_docs, "no monitor output"
        rows_live = [d for d in live_docs
                     if len(d["rows"]) == 3
                     and all(r["pushes"] >= 2 for r in d["rows"])]
        assert rows_live, (
            f"monitor never showed 3 live rows: {live_docs[-1]}")
        by_stage = {s["stage"]: s for s in stats_on
                    if s.get("stage") is not None}
        final = final_docs[-1]
        for r in final["rows"]:
            s = by_stage[r["stage"]]
            assert r["processed"] == s["processed"], (r, s)
            got, want = r["infer_ms"]["p50"], \
                s["infer_latency_s"]["p50"] * 1e3
            assert abs(got - want) <= 0.1 * max(want, 0.01), (got, want)

        # 2. the delay-bound stage is the live bottleneck
        assert final["bottleneck"] == 1, final
        last_live = rows_live[-1]
        assert last_live["bottleneck"] == 1, last_live

        # 3. straggler flagged within --sustain intervals; replan names it
        flagged = [d for d in live_docs if d["stragglers"]]
        assert flagged, "straggler detector never fired"
        first = flagged[0]
        f1 = {f["stage"]: f for f in first["stragglers"]}
        assert 1 in f1, first["stragglers"]
        assert f1[1]["intervals"] == args.sustain, f1[1]
        assert f1[1]["ratio"] > 1.5, f1[1]
        # only the delay-bound stage stays flagged once sustained
        assert {f["stage"] for f in flagged[-1]["stragglers"]} == {1}, \
            flagged[-1]["stragglers"]
        with_replan = [d for d in flagged if "replan" in d]
        assert with_replan, "no replan suggestion surfaced"
        corr = with_replan[-1]["replan"]["corrections"]
        assert max(corr, key=lambda k: corr[k]) == "1", corr
        first_flag_frame = live_docs.index(first) + 1

        # 4. clock-aligned waterfall: sampled frames' per-stage infer
        # spans sit in order on one timeline, no negative gaps
        spans = tr.spans
        names = {s["name"] for s in spans}
        assert any(n.endswith(".rx_wait") for n in names), sorted(names)
        assert any(n.endswith(".tx_wait") for n in names), sorted(names)
        complete, gaps = waterfall_gaps(spans, sample_every)
        assert complete >= args.count // sample_every, (
            f"only {complete} complete sampled waterfalls")
        min_gap = min(gaps)
        assert min_gap >= -200, (
            f"negative inter-stage gap {min_gap}us — clock alignment "
            f"failed (offsets {offsets})")
        trace_file = os.path.join(tmp, "waterfall.json")
        from defer_tpu_torch.obs import export_chrome_trace
        export_chrome_trace(trace_file)
        doc = json.load(open(trace_file))
        procs_seen = {e["args"]["name"] for e in doc["traceEvents"]
                      if e["ph"] == "M"}
        want_procs = 1 if args.quick else 4  # shared tracer in-process
        assert len(procs_seen) >= want_procs, procs_seen
        tr.enabled = False
        tr.clear()

        # 5b. the telemetry tax
        overhead = wall_on / wall_off - 1.0
        log(f"overhead: {overhead * 100:+.2f}% "
            f"(bound {args.max_overhead * 100:.0f}%), min waterfall gap "
            f"{min_gap}us over {complete} sampled frames, straggler "
            f"flagged at monitor frame {first_flag_frame}")
        assert overhead < args.max_overhead, (
            f"telemetry overhead {overhead * 100:.2f}% exceeds "
            f"{args.max_overhead * 100:.0f}% (on {wall_on:.3f}s vs off "
            f"{wall_off:.3f}s)")

        row = {"metric": "obs_overhead", "value": round(overhead, 4),
               "unit": "frac_wall_overhead_vs_no_trace",
               "quick": args.quick, "count": args.count,
               "batch": args.batch, "delay_ms": args.delay_ms,
               "interval_ms": args.interval_ms,
               "wall_off_s": round(wall_off, 4),
               "wall_on_s": round(wall_on, 4),
               "bottleneck": final["bottleneck"],
               "straggler": f1[1],
               "replan_argmax_stage": 1,
               "monitor_frames": len(live_docs),
               "first_flag_frame": first_flag_frame,
               "sampled_waterfalls": complete,
               "min_waterfall_gap_us": round(min_gap, 1),
               "clock_offset_us": {a: round(v["offset_us"], 1)
                                   for a, v in offsets.items()},
               "cpu_count": os.cpu_count() or 1}

        # -- full mode only: the run_chain wiring (plan= + stats_out=
        # appends the live obs row with stragglers + replan suggestion)
        if not args.quick:
            from defer_tpu_torch.runtime.node import run_chain
            stats2: list = []
            run_chain(stages, params, xs[:16], batch=args.batch,
                      **chain_opts(),
                      hop_codecs=delays, artifact_dir=tmp,
                      stats_out=stats2, plan=plan, graph=graph,
                      report_interval_ms=args.interval_ms)
            obs_rows = [r["obs"] for r in stats2 if "obs" in r]
            assert obs_rows, f"run_chain appended no obs row: {stats2}"
            ob = obs_rows[0]
            assert ob["bottleneck"] == 1, ob
            assert any(f["stage"] == 1 for f in ob["stragglers"]), ob
            rcorr = ob["replan"]["corrections"]
            # keys are ints in-process (str once JSON-serialized)
            assert str(max(rcorr, key=lambda k: rcorr[k])) == "1", rcorr
            row["run_chain_obs"] = {
                "bottleneck": ob["bottleneck"],
                "stragglers": ob["stragglers"]}

    print(json.dumps(row))
    log("monitor smoke: OK")


if __name__ == "__main__":
    main()
