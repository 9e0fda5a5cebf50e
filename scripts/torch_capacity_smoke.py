"""Cost-model truth smoke: calibration closes the predict/measure loop.

A 3-stage resnet_tiny chain gets a delay-bound middle stage (decode-side
sleep on its inbound hop, encode-side sleep on its outbound hop — the
same vehicle as ``torch_monitor_smoke.py``).  The deployed ``dsleep``/
``esleep`` codec names have NO row in the analytic codec table, so the
default cost model prices them via the ``raw`` fallback and predicts
the delay stage as compute-bound — the documented failure mode the
calibration loop exists to fix:

1. COMPUTE BASIS: a no-delay calibration run measures this host's real
   per-stage compute (the analytic roofline is meaningless on CPU).
2. CALIBRATE: ``fit_from_stats`` over the DELAY chain's own live
   telemetry (window-bounded against the post-warmup baseline snapshot)
   fits per-deployed-codec throughputs + host-sync / wire bandwidths
   into a versioned ``CalibratedConstants`` artifact.  The calibrated
   model must predict the bottleneck stage's measured service within
   ``--tolerance`` (15%); the default model must be measurably worse.
3. ROUNDTRIP: the calibrated constants survive plan JSON
   (``evaluate_cuts(..., hop_codecs=deployed)`` -> ``to_json`` ->
   ``plan_from_json`` -> ``cost_model_from_plan``) — the monitor's
   drift auditor rebuilds its predictions from exactly that artifact.
4. MONITOR: ``defer_tpu_torch monitor --json`` against the running chain
   carries per-row ``pred_ms``/``meas_ms``/``err`` and the ``mfu``
   field; the human table renders the MFU / PRED / MEAS / ERR%
   columns.
5. DRIFT: a second chain with every sleep DOUBLED (the injected
   slowdown) audited against the SAME plan must fire a ``model_drift``
   flight-recorder event on the delay stage within ``--sustain`` (2)
   monitor intervals, exactly once per episode.
6. OVERHEAD: streaming wall with the live monitor + drift audit
   subscribed vs telemetry-off differs by < ``--max-overhead`` (5%) on
   the interleaved min-of-3 protocol; outputs stay byte-identical.

``--quick`` runs the chain in-process (thread nodes, real TCP sockets —
the CI mode); the default spawns real OS processes per stage.  Exit 0
on success; one JSON row on stdout (the ``cost_model_truth`` row of
``benchmarks/run.py``, CalibratedConstants embedded so the bench ledger
carries the calibration trajectory).

The PyTorch port's copy of ``scripts/capacity_smoke.py``: the same checks,
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


def boot_inproc(stages, params, codecs, *, batch) -> Chain:
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode
    nodes = [StageNode(None, "127.0.0.1:0", None, **node_opts()) for _ in range(3)]
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    threads = [threading.Thread(target=n.serve, daemon=True)
               for n in nodes]
    for t in threads:
        t.start()
    disp = ChainDispatcher(addrs[0], codec="raw")
    disp.deploy(stages, params, addrs, batch=batch, codecs=codecs)
    return Chain(disp, addrs, threads=threads)


def boot_procs(paths, codecs, *, log_dir, tag) -> Chain:
    from defer_tpu_torch.runtime.node import ChainDispatcher, _await_binds
    from defer_tpu_torch.runtime.node import _free_ports
    ports = _free_ports(4)
    addrs = [f"127.0.0.1:{p}" for p in ports[:3]]
    result = f"127.0.0.1:{ports[3]}"
    child_env = node_env()
    procs, logs = [], []
    for k in range(3):
        nxt = addrs[k + 1] if k < 2 else result
        # --tier tcp: the fit prices the dsleep/esleep wire codecs; an
        # auto-negotiated shm hop would bypass them
        argv = [sys.executable, "-m", "defer_tpu_torch", "node", *node_flags(),
                "--artifact", paths[k], "--listen", addrs[k],
                "--next", nxt, "--codec", codecs[k], "--tier", "tcp"]
        lf = open(os.path.join(log_dir, f"{tag}_node_{k}.log"), "w+")
        logs.append(lf)
        procs.append(subprocess.Popen(argv, env=child_env, stdout=lf,
                                      stderr=subprocess.STDOUT))
    _await_binds(procs, [f"stage{k}" for k in range(3)], logs, addrs)
    disp = ChainDispatcher(addrs[0], listen=result, codec="raw")
    return Chain(disp, addrs, procs=procs, logs=logs)


def run_monitor(addrs, *, interval_ms, iterations, plan_file,
                as_json=True, out: dict | None = None):
    """Invoke the REAL CLI (`defer_tpu_torch monitor`) and return its parsed
    JSON lines (or, with as_json=False, the raw rendered text)."""
    from defer_tpu_torch import cli
    argv = ["monitor", "--nodes", ",".join(addrs),
            "--interval-ms", str(interval_ms),
            "--iterations", str(iterations),
            "--plan", plan_file, "--model", "resnet_tiny"]
    if as_json:
        argv.append("--json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    if not as_json:
        return buf.getvalue()
    docs = [json.loads(line) for line in buf.getvalue().strip()
            .splitlines() if line]
    if out is not None:
        out["docs"] = docs
    return docs


def _p50(s) -> float:
    return (s or {}).get("p50", 0.0) * 1e3 if (s or {}).get("count") \
        else 0.0


def service_from_stats(stats) -> dict[int, float]:
    """Per-stage live service ms from stats replies: the slowest of the
    decode / infer / encode phase p50s (each phase owns a thread)."""
    out = {}
    for row in stats:
        if row.get("stage") is None:
            continue
        out[row["stage"]] = max(_p50(row.get("infer_latency_s")),
                                _p50(row.get("decode_latency_s")),
                                _p50(row.get("encode_latency_s")))
    return out


def infer_from_stats(stats) -> dict[int, float]:
    """Per-stage COMPUTE ms (infer p50 only): the cost-model basis.
    Codec work is deliberately excluded — pricing the hops is the
    calibration artifact's job, not the compute term's."""
    out = {}
    for row in stats:
        if row.get("stage") is None:
            continue
        out[row["stage"]] = _p50(row.get("infer_latency_s"))
    return out


def compute_cost_model(graph, stages, measured_ms: dict[int, float], *,
                       batch: int):
    """A cost model whose COMPUTE is this host's measured no-delay
    per-stage service, spread uniformly over each stage's nodes (the
    analytic roofline cannot price a 1-core CPU host), with the
    DEFAULT analytic codec table — the uncalibrated strawman the
    artifact is fitted against.  Built at the chain's frame ``batch``
    so comm terms price the bytes that actually cross each hop."""
    from defer_tpu_torch.plan import StageCostModel
    node_costs = {}
    order = graph.topo_order
    pos = {n: i for i, n in enumerate(order)}
    cuts = [s.output_name for s in stages[:-1]]
    bounds = [0] + [pos[c] + 1 for c in cuts] + [len(order)]
    for k in range(len(bounds) - 1):
        names = order[bounds[k]:bounds[k + 1]]
        per = max(measured_ms.get(k, 0.0), 1e-3) / 1e3 / len(names)
        for n in names:
            node_costs[n] = per
    return StageCostModel(graph, gen="v4", link_bw_s=1e9,
                          batch=batch, node_costs=node_costs)


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
                    help="intervals drift must hold to fire the event")
    ap.add_argument("--tolerance", type=float, default=0.15,
                    help="calibrated bottleneck prediction error bound")
    ap.add_argument("--max-overhead", type=float, default=0.05,
                    help="monitor+audit wall overhead bound vs all-off")
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
    from defer_tpu_torch.obs import recorder
    from defer_tpu_torch.plan import (CalibratedConstants, evaluate_cuts,
                                fit_from_stats, plan_from_json,
                                predict_stage_service_s)
    from defer_tpu_torch.plan.replan import cost_model_from_plan
    from defer_tpu_torch.utils.export import export_pipeline

    graph = resnet_tiny()
    params = graph.init(torch.Generator().manual_seed(0))
    stages = partition(graph, num_stages=3)
    cuts = [s.output_name for s in stages[:-1]]
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((args.batch, 32, 32, 3)).astype(np.float32)
          for _ in range(args.count)]
    deploys = hop_codecs(args.delay_ms)

    with tempfile.TemporaryDirectory(prefix="defer_cap_") as tmp:
        paths = None
        if not args.quick:
            paths = export_pipeline(stages, params, tmp, batch=args.batch)

        def boot(codecs, tag):
            if args.quick:
                return boot_inproc(stages, params, codecs,
                                   batch=args.batch)
            return boot_procs(paths, codecs, log_dir=tmp, tag=tag)

        # -- 1. compute basis: the no-delay run measures this host's
        # per-stage compute (always in-process: that IS the thing the
        # plan's node costs must predict)
        chain = boot_inproc(stages, params, hop_codecs(0),
                            batch=args.batch)
        try:
            chain.disp.stream(xs[:4])          # compile + connect
            chain.disp.stream(xs)
            base_ms = infer_from_stats(chain.disp.stats(chain.addrs))
        finally:
            chain.close()
        cost_default = compute_cost_model(graph, stages, base_ms,
                                          batch=args.batch)
        log(f"compute basis (no-delay run): "
            f"{ {k: round(v, 3) for k, v in base_ms.items()} } ms")

        # -- 2. calibrate from the delay chain's own telemetry ---------
        chain_off = boot(deploys, "off")
        chain_on = boot(deploys, "on")
        mon: dict = {}
        human = None
        try:
            chain_off.disp.stream(xs[:4])
            chain_on.disp.stream(xs[:4])       # compile + connect
            # window-bound the fit against the post-warmup snapshot so
            # compile-cold outliers never anchor a bandwidth
            stats_warm = chain_on.disp.stats(chain_on.addrs)
            chain_on.disp.stream(xs)
            stats_cal = chain_on.disp.stats(chain_on.addrs)
            meas_ms = service_from_stats(stats_cal)
            cal = fit_from_stats(graph, cuts, stats_cal,
                                 batch=args.batch, gen="unknown",
                                 prior=cost_default,
                                 baseline=stats_warm)
            cal_file = os.path.join(tmp, "calibration.json")
            cal.save(cal_file)
            cal = CalibratedConstants.load(cal_file)   # artifact roundtrip
            cost_cal = cal.apply(cost_default)

            # deploys[-1] is the dispatcher result hop; the cut hops
            # are the first len(cuts) entries
            stage_hops = deploys[:len(cuts)]
            pred_def = [s * 1e3 for s in predict_stage_service_s(
                graph, cuts, stage_hops, cost_default)]
            pred_cal = [s * 1e3 for s in predict_stage_service_s(
                graph, cuts, stage_hops, cost_cal)]
            bott = max(meas_ms, key=lambda k: meas_ms[k])
            assert bott == 1, f"delay stage not the bottleneck: {meas_ms}"
            err_cal = abs(pred_cal[bott] - meas_ms[bott]) / meas_ms[bott]
            err_def = abs(pred_def[bott] - meas_ms[bott]) / meas_ms[bott]
            log(f"bottleneck stage {bott}: measured "
                f"{meas_ms[bott]:.3f} ms, calibrated pred "
                f"{pred_cal[bott]:.3f} ms ({err_cal * 100:+.1f}%), "
                f"default pred {pred_def[bott]:.3f} ms "
                f"({err_def * 100:+.1f}%)")
            assert err_cal < args.tolerance, (
                f"calibrated prediction off by {err_cal * 100:.1f}% "
                f"(bound {args.tolerance * 100:.0f}%): "
                f"pred {pred_cal[bott]:.3f} vs meas {meas_ms[bott]:.3f}")
            # the default model prices the unknown dsleep/esleep names
            # as raw: it must be MEASURABLY worse, not coin-flip worse
            assert err_def > max(2 * err_cal, 0.5), (
                f"default model unexpectedly good: {err_def * 100:.1f}% "
                f"vs calibrated {err_cal * 100:.1f}%")

            # -- 3. plan JSON roundtrip: the deployed-codec plan carries
            # the calibrated constants to the monitor's auditor
            plan = evaluate_cuts(graph, cuts, cost_cal,
                                 hop_codecs=stage_hops)
            plan_file = os.path.join(tmp, "plan.json")
            with open(plan_file, "w") as f:
                json.dump(plan.to_json(), f)
            with open(plan_file) as f:
                plan_rt = plan_from_json(json.load(f))
            cost_rt = cost_model_from_plan(graph, plan_rt)
            pred_rt = [s * 1e3 for s in predict_stage_service_s(
                graph, plan_rt.cuts, plan_rt.codecs, cost_rt)]
            for a, b in zip(pred_rt, pred_cal):
                assert abs(a - b) <= 1e-6 + 1e-3 * b, (pred_rt, pred_cal)

            # -- 6. overhead: TWO identical delay chains, streamed
            # ALTERNATELY — "off" never sees telemetry, "on" streams
            # under a live monitor + drift-audit subscriber.
            # Interleaving cancels host drift; min-of-3 absorbs
            # scheduler spikes.
            mt = threading.Thread(
                target=run_monitor, args=(chain_on.addrs,),
                kwargs=dict(interval_ms=args.interval_ms,
                            iterations=40, plan_file=plan_file,
                            out=mon), daemon=True)
            mt.start()
            w_off, w_on = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                outs_off = chain_off.disp.stream(xs)
                w_off.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                outs_on = chain_on.disp.stream(xs)
                w_on.append(time.perf_counter() - t0)
            wall_off, wall_on = min(w_off), min(w_on)
            mt.join(timeout=120)
            assert not mt.is_alive(), "monitor CLI did not finish"
            live_docs = mon["docs"]
            # -- 4. the human table renders the new columns
            human = run_monitor(chain_on.addrs,
                                interval_ms=args.interval_ms,
                                iterations=2, plan_file=plan_file,
                                as_json=False)
        except BaseException:
            chain_off.failed = chain_on.failed = True
            raise
        finally:
            chain_off.close()
            chain_on.close()

        # 6a. the audit must not corrupt the stream
        assert len(outs_on) == len(outs_off) == args.count
        for a, b in zip(outs_off, outs_on):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        # 4. monitor rows carry the audit + capacity fields
        assert live_docs, "no monitor output"
        audited = [d for d in live_docs
                   if any(r.get("pred_ms") and (r.get("err") is not None)
                          for r in d["rows"])]
        assert audited, f"no audited rows: {live_docs[-1]['rows']}"
        last = audited[-1]
        row1 = next(r for r in last["rows"] if r["stage"] == 1)
        # the CPU has no peak rate, and a node booted from an artifact
        # has no FLOP count (an in-band deploy carries one): no MFU then;
        # else the card's row in utils/hw.py gives one (the JAX script
        # runs on the CPU only)
        assert "mfu" in row1, row1
        if DEVICE.type == "cpu" or row1.get("flops") is None:
            assert row1["mfu"] is None, row1
        else:
            assert 0 < row1["mfu"] <= 1, row1
        assert abs(row1["err"]) < 0.25, (
            f"calibrated audit err {row1['err'] * 100:+.1f}% on the "
            f"nominal chain: {row1}")
        # the nominal chain matches its calibrated predictions on the
        # delay-bound stage: no sustained drift episode there (the
        # sub-ms fast stages ride 1-core contention and may wobble
        # past any honest threshold — they are not this row's claim)
        drifted = [d for d in live_docs
                   if any(f["stage"] == 1 for f in d["drift"])]
        assert not drifted, f"false drift on nominal chain: {drifted[0]}"
        for col in ("MFU%", "PRED", "MEAS", "ERR%"):
            assert col in human, f"monitor table lacks {col}:\n{human}"

        # -- 5. injected slowdown: every sleep doubled, audited against
        # the SAME plan -> model_drift on the delay stage within
        # --sustain intervals
        recorder().clear()
        slow = boot(hop_codecs(args.delay_ms * 2), "slow")
        mon2: dict = {}
        try:
            slow.disp.stream(xs[:4])
            mt2 = threading.Thread(
                target=run_monitor, args=(slow.addrs,),
                kwargs=dict(interval_ms=args.interval_ms,
                            iterations=30, plan_file=plan_file,
                            out=mon2), daemon=True)
            mt2.start()
            for _ in range(3):
                slow.disp.stream(xs)
            mt2.join(timeout=120)
            assert not mt2.is_alive(), "drift monitor did not finish"
        except BaseException:
            slow.failed = True
            raise
        finally:
            slow.close()
        drift_docs = [d for d in mon2["docs"] if d["drift"]]
        assert drift_docs, "model_drift never fired on the slowed chain"
        first = drift_docs[0]["drift"]
        by_stage = {f["stage"]: f for f in first}
        assert 1 in by_stage, first
        f1 = by_stage[1]
        assert f1["intervals"] == args.sustain, f1
        assert f1["rel_err"] > 0.5, f1     # 2x sleep: ~+100% drift
        # fires as soon as the audit has measurements: within --sustain
        # intervals of the first audited frame
        first_audit = next(i for i, d in enumerate(mon2["docs"])
                           if any(r.get("err") is not None
                                  for r in d["rows"]))
        first_drift = mon2["docs"].index(drift_docs[0])
        assert first_drift - first_audit < args.sustain + 2, (
            f"drift took {first_drift - first_audit} frames past the "
            f"first audited frame (sustain {args.sustain})")
        # ONE event per episode (StragglerDetector re-arm discipline)
        drift_events = [e for e in recorder().snapshot()
                        if e["kind"] == "model_drift"
                        and e["data"].get("stage") == 1]
        assert len(drift_events) == 1, drift_events

        # 6b. the telemetry tax
        overhead = wall_on / wall_off - 1.0
        log(f"overhead: {overhead * 100:+.2f}% "
            f"(bound {args.max_overhead * 100:.0f}%); drift fired "
            f"{f1['rel_err'] * 100:+.1f}% after {f1['intervals']} "
            f"intervals")
        assert overhead < args.max_overhead, (
            f"monitor+audit overhead {overhead * 100:.2f}% exceeds "
            f"{args.max_overhead * 100:.0f}% (on {wall_on:.3f}s vs off "
            f"{wall_off:.3f}s)")

        row = {"metric": "cost_model_truth",
               "value": round(err_cal, 4),
               "unit": "frac_abs_err_calibrated_bottleneck",
               "quick": args.quick, "count": args.count,
               "batch": args.batch, "delay_ms": args.delay_ms,
               "bottleneck": bott,
               "measured_ms": {str(k): round(v, 4)
                               for k, v in meas_ms.items()},
               "pred_calibrated_ms": [round(v, 4) for v in pred_cal],
               "pred_default_ms": [round(v, 4) for v in pred_def],
               "err_default": round(err_def, 4),
               "drift": f1,
               "monitor_frames": len(live_docs),
               "overhead": round(overhead, 4),
               "wall_off_s": round(wall_off, 4),
               "wall_on_s": round(wall_on, 4),
               "calibration": cal.to_json(),
               "cpu_count": os.cpu_count() or 1}

    print(json.dumps(row))
    log("capacity smoke: OK")


if __name__ == "__main__":
    main()
