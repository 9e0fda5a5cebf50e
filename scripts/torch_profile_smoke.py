"""Stage-interior profiling smoke: the X-ray accounts for the frame.

A 3-stage resnet_tiny chain with a delay-bound middle stage (the
``torch_monitor_smoke.py`` rig: decode/encode-side sleeps on stage 1's hops)
streams while the ``defer_tpu_torch profile`` plane attaches to it:

1. PHASES SUM: a live ``defer_tpu_torch profile`` window (the REAL CLI, in a
   thread, over the nodes' ctrl sockets) returns per-node DELTA phase
   breakdowns whose dispatch + queue + device + host_sync seconds tile
   the measured ``infer`` wall within ``--phase-tol`` (10%) on EVERY
   stage — the decomposition is exhaustive, not decorative.  With
   ``--spans`` the merged Perfetto export must carry all three phases'
   spans for all three stages.
2. RECOMPILE TELEMETRY: after warmup, an injected input-shape change
   must bump the ``compiles`` counter for every stage program and
   fire EXACTLY ONE ``recompile`` flight-recorder event in this
   process (episode discipline: one event per burst, not one per
   compile); a subsequent stream at the original shape must compile
   NOTHING (the steady-state-zero claim the decode bench relies on).
   (The JAX script reads ``jax.compiles``; the port's
   ``RecompileWatcher`` counts a stage program's export trace and load,
   and CUDA-graph captures.)
3. SESSION OVERHEAD: two identical delay chains streamed alternately
   (min-of-3, the ``monitor_smoke`` interleave that cancels host
   drift); one carries an active profile session for the whole
   measurement, the other is left alone.  The session must cost
   < ``--max-overhead`` (5%) wall — attaching the profiler to a
   production stream is free, because a session only SNAPSHOTS the
   always-on phase histograms (two ``perf_counter`` calls + two O(1)
   histogram records per frame, priced inside ``monitor_smoke``'s
   telemetry bound).

The chain runs in-process (thread nodes over real TCP sockets — the
ctrl protocol, clock probes, and span dumps all ride the real wire);
``--quick`` only shrinks the frame counts for CI.  Exit 0 on success;
one JSON row on stdout (the ``profile_overhead`` row of
``benchmarks/run.py``).

The PyTorch port's copy of ``scripts/profile_smoke.py``: the same checks,
flags, bounds and row, run on ``--device`` (the card by default; the node
processes it spawns run there too).
"""

import argparse
import json
import os
import sys
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


def hop_codecs(delay_ms: float) -> list[str]:
    if delay_ms <= 0:
        return ["raw", "raw", "raw"]
    return [f"dsleep{delay_ms:g}+raw", f"esleep{delay_ms:g}+raw", "raw"]


def boot_inproc(stages, params, codecs, *, batch, sample=0):
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
    return disp, addrs, threads


def run_profile_cli(addrs, *, seconds, out_path, trace_out=None,
                    done: dict | None = None):
    """Invoke the REAL ``defer_tpu_torch profile`` CLI against the chain."""
    from defer_tpu_torch import cli
    argv = ["profile", "--nodes", ",".join(addrs),
            "--seconds", str(seconds), "--out", out_path]
    if trace_out:
        # default --sample-every 0: record every frame's phase spans —
        # works on any stream, stamped or not (1-in-N sampling needs a
        # dispatcher started with trace_sample_every >= 1)
        argv += ["--spans", "--trace-out", trace_out]
    cli.main(argv)
    if done is not None:
        done["ok"] = True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller frame counts (CI mode)")
    ap.add_argument("--count", type=int, default=0,
                    help="microbatches per measured stream "
                         "(0 = 24 quick / 48 full)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--delay-ms", type=float, default=5.0,
                    help="per-side delay on the bottleneck stage's hops")
    ap.add_argument("--phase-tol", type=float, default=0.10,
                    help="|dispatch+device+host_sync - infer| bound, "
                         "relative to the infer wall")
    ap.add_argument("--max-overhead", type=float, default=0.05,
                    help="active-session wall overhead bound")
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:N, cpu, or an index N")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = pick_device(args.device)
    sys.setswitchinterval(SWITCH_INTERVAL_S)
    count = args.count or (24 if args.quick else 48)

    import tempfile

    import numpy as np

    import torch

    from defer_tpu_torch import partition
    from defer_tpu_torch.models import resnet_tiny
    from defer_tpu_torch.obs import recorder, recompile_watcher, tracer
    from defer_tpu_torch.obs.registry import REGISTRY

    graph = resnet_tiny()
    params = graph.init(torch.Generator().manual_seed(0))
    stages = partition(graph, num_stages=3)
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((args.batch, 32, 32, 3)).astype(np.float32)
          for _ in range(count)]
    delays = hop_codecs(args.delay_ms)
    tr = tracer()
    tr.enabled = False

    with tempfile.TemporaryDirectory(prefix="defer_prof_") as tmp:
        # ---- 1. phase sums under a live CLI window ------------------
        disp, addrs, _ = boot_inproc(stages, params, delays,
                                     batch=args.batch)
        prof_json = os.path.join(tmp, "profile.json")
        trace_json = os.path.join(tmp, "trace.json")
        try:
            t0 = time.perf_counter()
            disp.stream(xs[:4])                 # compile + connect
            w1 = time.perf_counter() - t0
            # window long enough that streaming is what fills it
            window_s = max(2.0, 3.0 * w1)
            done: dict = {}
            th = threading.Thread(
                target=run_profile_cli, args=(addrs,),
                kwargs=dict(seconds=window_s, out_path=prof_json,
                            trace_out=trace_json, done=done),
                daemon=True)
            th.start()
            while th.is_alive():
                disp.stream(xs)
            th.join(timeout=120)
            assert done.get("ok"), "profile CLI did not finish"
        finally:
            disp.close()
        doc = json.load(open(prof_json))
        assert len(doc["nodes"]) == 3, doc
        # on the CPU a stage program runs synchronously, so a node has no
        # device wait to time (runtime/node.py ``_device_wait``): its work
        # is inside dispatch, and the phases that tile infer are the other
        # three.  The card has all four.
        timed = (("dispatch", "queue", "device", "host_sync")
                 if DEVICE.type == "cuda"
                 else ("dispatch", "queue", "host_sync"))
        sums = {}
        for addr, rep in doc["nodes"].items():
            ph = rep["phases"]
            inf = ph["infer"]
            assert inf["count"] > 0, (addr, rep)
            got = sum(ph[k]["sum_s"]
                      for k in ("dispatch", "queue", "device",
                                "host_sync"))
            rel = abs(got - inf["sum_s"]) / inf["sum_s"]
            sums[rep["node"]] = {
                "infer_s": round(inf["sum_s"], 4),
                "phase_sum_s": round(got, 4),
                "rel_err": round(rel, 4),
                "frames": inf["count"],
                "dispatch_share": rep.get("dispatch_share")}
            log(f"{rep['node']}: infer {inf['sum_s']:.3f}s over "
                f"{inf['count']} frames, phases sum {got:.3f}s "
                f"(rel err {rel * 100:.2f}%, dispatch share "
                f"{rep.get('dispatch_share')})")
            assert rel <= args.phase_tol, (
                f"{rep['node']}: dispatch+device+host_sync = {got:.4f}s "
                f"does not account for infer = {inf['sum_s']:.4f}s "
                f"(rel err {rel * 100:.1f}% > "
                f"{args.phase_tol * 100:.0f}%)")
            # the window may split a frame: counts agree to +-2
            for k in timed:
                assert abs(ph[k]["count"] - inf["count"]) <= 2, (k, ph)
        trace = json.load(open(trace_json))
        names = {e["name"] for e in trace["traceEvents"]
                 if e.get("ph") == "X"}
        for k in range(3):
            for phase in timed + ("infer",):
                assert f"stage{k}.{phase}" in names, (
                    f"stage{k}.{phase} span missing from the merged "
                    f"trace: {sorted(names)}")
        tr.enabled = False
        tr.clear()

        # ---- 2. recompile telemetry on an injected shape change -----
        # (the wire protocol pins the batch per deployment, so the
        # injected "shape change" is a fresh deploy at batch+1 — the
        # same process compiles three NEW stage programs while armed)
        watcher = recompile_watcher()
        watcher.disarm()        # part 1's profile session armed it
        # the port's watcher counts from process start (the JAX script
        # installs a jax.monitoring listener here): count from this point
        c0 = watcher.count
        rec = recorder()
        ev0 = sum(1 for e in rec.snapshot()
                  if e["kind"] == "recompile")
        disp, addrs, _ = boot_inproc(stages, params, delays,
                                     batch=args.batch)
        disp2 = None
        try:
            disp.stream(xs[:4])                 # warm at the base shape
            c_warm = watcher.count
            assert c_warm > c0, "warmup compiles were not counted"
            assert sum(1 for e in rec.snapshot()
                       if e["kind"] == "recompile") == ev0, (
                "warmup compiles fired events before arm()")
            watcher.arm()
            disp.stream(xs[:8])                 # steady state
            assert watcher.count == c_warm, (
                f"steady-state stream compiled "
                f"{watcher.count - c_warm} programs")
            odd = [rng.standard_normal(
                (args.batch + 1, 32, 32, 3)).astype(np.float32)
                for _ in range(2)]
            disp2, _, _ = boot_inproc(stages, params, delays,
                                      batch=args.batch + 1)
            disp2.stream(odd)                   # every stage compiles
            c1 = watcher.count
            ev1 = sum(1 for e in rec.snapshot()
                      if e["kind"] == "recompile")
            assert c1 - c_warm >= 3, (
                f"shape change compiled only {c1 - c_warm} programs "
                f"(expected >= 3, one per stage)")
            assert ev1 - ev0 == 1, (
                f"expected exactly one recompile event per process per "
                f"episode, saw {ev1 - ev0}")
            # steady state again: both deployments now cached
            disp.stream(xs[:8])
            disp2.stream(odd)
            assert watcher.count == c1, (
                f"steady-state stream still compiled "
                f"{watcher.count - c1} programs")
            log(f"recompile telemetry: warmup {c_warm} compiles / 0 "
                f"events, injected {c1 - c_warm} -> 1 event, steady "
                f"state 0")
        finally:
            disp.close()
            if disp2 is not None:
                disp2.close()

        # ---- 3. an active session costs nothing ---------------------
        disp_off, addrs_off, _ = boot_inproc(stages, params, delays,
                                             batch=args.batch)
        disp_on, addrs_on, _ = boot_inproc(stages, params, delays,
                                           batch=args.batch)
        try:
            disp_off.stream(xs[:4])
            disp_on.stream(xs[:4])
            sess_out = os.path.join(tmp, "session.json")
            done2: dict = {}
            # generous window: the CLI sleeps it out while we measure
            th = threading.Thread(
                target=run_profile_cli, args=(addrs_on,),
                kwargs=dict(seconds=3600.0, out_path=sess_out,
                            done=done2), daemon=True)
            # the CLI sleeps --seconds; interrupt it by closing from
            # this side is not part of the protocol, so bound the
            # window instead: measure first, with the session open
            w_off, w_on = [], []
            th2 = None
            try:
                # profile_start lands before the first on-round: poll
                # the node's stats 'profiling' flag
                from defer_tpu_torch.runtime.node import _parse_hostport
                from defer_tpu_torch.transport.framed import \
                    connect_retry as _connect_retry
                from defer_tpu_torch.transport.framed import (K_CTRL,
                                                        recv_expect,
                                                        send_ctrl,
                                                        send_end)
                th2 = th
                th.start()
                deadline = time.time() + 60
                while time.time() < deadline:
                    s = _connect_retry(*_parse_hostport(addrs_on[0]),
                                       timeout_s=10)
                    send_ctrl(s, {"cmd": "stats"})
                    st = recv_expect(s, K_CTRL)
                    send_end(s)
                    s.close()
                    if st.get("profiling"):
                        break
                    time.sleep(0.05)
                else:
                    raise AssertionError("profile session never opened")
                for _ in range(3):
                    t0 = time.perf_counter()
                    outs_off = disp_off.stream(xs)
                    w_off.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    outs_on = disp_on.stream(xs)
                    w_on.append(time.perf_counter() - t0)
            finally:
                # release the sleeping CLI thread: stop the sessions
                # out from under it is harmless — it exits on
                # profile_stop's profile_err reply
                if th2 is not None and th2.is_alive():
                    for a in addrs_on:
                        s = _connect_retry(*_parse_hostport(a),
                                           timeout_s=10)
                        send_ctrl(s, {"cmd": "profile_stop"})
                        recv_expect(s, K_CTRL)
                        send_end(s)
                        s.close()
            wall_off, wall_on = min(w_off), min(w_on)
            assert len(outs_on) == len(outs_off) == count
            for a, b in zip(outs_off, outs_on):
                np.testing.assert_array_equal(np.asarray(a),
                                              np.asarray(b))
        finally:
            disp_off.close()
            disp_on.close()
        overhead = wall_on / wall_off - 1.0
        log(f"session off: {count * args.batch / wall_off:7.1f} inf/s "
            f"({wall_off:.3f}s)")
        log(f"session on:  {count * args.batch / wall_on:7.1f} inf/s "
            f"({wall_on:.3f}s, {overhead * 100:+.2f}% — bound "
            f"{args.max_overhead * 100:.0f}%)")
        assert overhead < args.max_overhead, (
            f"active profile session costs {overhead * 100:.2f}% "
            f"(> {args.max_overhead * 100:.0f}%) wall")

    row = {"metric": "profile_overhead", "value": round(overhead, 4),
           "unit": "frac_wall_overhead_vs_no_session",
           "quick": args.quick, "count": count, "batch": args.batch,
           "delay_ms": args.delay_ms,
           "wall_off_s": round(wall_off, 4),
           "wall_on_s": round(wall_on, 4),
           "phase_sums": sums,
           "recompiles_injected": c1 - c_warm,
           "recompile_events": ev1 - ev0,
           "registry_compiles": REGISTRY.counter("compiles").value,
           "cpu_count": os.cpu_count() or 1}
    print(json.dumps(row))
    log("profile smoke: OK")


if __name__ == "__main__":
    main()
