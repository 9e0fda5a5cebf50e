"""Request-observability smoke: tracing, the flight recorder, and
latency attribution composed with the serving front door.

The deployment is the serving smoke's delay-bound 3-stage chain
(``dsleep``: each frame charges the chain a fixed non-CPU cost inside
stage 1, so per-request time is governed by physics, not CPU luck)
behind a front door — and this script proves the observability plane
over it:

1. OVERHEAD < ``--max-overhead`` (5%): two identical deployments
   streamed ALTERNATELY (the ``obs_overhead`` interleaving — host
   drift cancels, min-of-3 absorbs scheduler spikes): "off" never sees
   telemetry; "on" runs request-scoped tracing (1-in-``--sample``
   frames), the flight recorder, and a live ClusterView subscriber.

2. BURST EVENTS: the serving smoke's open-loop Poisson trace with a 2x
   burst is played against the traced door by a deadline tenant.  The burst
   must provoke sheds (admission) and straggler flags (a detector
   polling the live view against a deliberately tight expectation),
   and the MERGED flight-recorder log — door ring + node events off
   the obs_push stream — must contain both, in per-process seq order,
   with ZERO ring drops at default capacity.

3. ATTRIBUTION: for the sampled requests of the burst, the folded
   budget buckets (admission + gather + per-stage compute + per-hop
   transport + result edge — ``obs/attrib.py``) of the p50 AND p99
   requests sum to within ``--tolerance`` (10%) of each request's
   measured end-to-end latency, and the exported Perfetto trace
   carries front-door, dispatcher, and stage spans on one timeline
   (distinct OS processes in full mode, clock-aligned).

``--quick`` keeps the chain in-process (thread nodes — the CI mode);
the default spawns real OS ``defer_tpu_torch node`` processes.  Exit 0 on
success; one JSON row on stdout (the ``request_attribution`` row of
``benchmarks/run.py``).

The PyTorch port's copy of ``scripts/request_obs_smoke.py``: the same checks,
flags, bounds and row, run on ``--device`` (the card by default; the node
processes it spawns run there too).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import torch  # noqa: E402

from defer_tpu_torch import partition  # noqa: E402
from defer_tpu_torch.models import resnet_tiny  # noqa: E402
from defer_tpu_torch.obs import tracer  # noqa: E402
from defer_tpu_torch.obs.attrib import attribute_sampled  # noqa: E402
from defer_tpu_torch.obs.cluster import (ClusterView,  # noqa: E402
                                   StragglerDetector)
from defer_tpu_torch.obs.events import merge_events, recorder  # noqa: E402
from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode  # noqa: E402
from defer_tpu_torch.serve import (LoadGenerator, ServeClient,  # noqa: E402
                             poisson_trace)
from defer_tpu_torch.serve.frontdoor import (ChainBackend,  # noqa: E402
                                       ServeFrontDoor)

IN_SHAPE = (32, 32, 3)


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


class Deployment:
    def __init__(self, door, disp, addrs, *, threads=None, procs=None,
                 logs=None, view=None):
        self.door = door
        self.disp = disp
        self.addrs = addrs
        self.view = view
        self._threads = threads or []
        self._procs = procs or []
        self._logs = logs or []

    @property
    def addr(self):
        return self.door.address

    def close(self):
        from defer_tpu_torch.runtime.node import _kill_procs
        if self.view is not None:
            self.view.close()
        self.door.stop()
        if self._procs:
            _kill_procs(self._procs)
        for t in self._threads:
            t.join(timeout=30)
        for lf in self._logs:
            lf.close()


def boot_door(stages, params, width, codecs, *, quick, log_dir, tag,
              sample=0, align=False) -> Deployment:
    if quick:
        nodes = [StageNode(None, "127.0.0.1:0", None, **node_opts()) for _ in stages]
        addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
        threads = [threading.Thread(target=n.serve, daemon=True)
                   for n in nodes]
        for t in threads:
            t.start()
        disp = ChainDispatcher(addrs[0], codec="raw")
        disp.deploy(stages, params, addrs, batch=width, codecs=codecs)
        dep = dict(threads=threads)
    else:
        from defer_tpu_torch.runtime.node import _await_binds, _free_ports
        from defer_tpu_torch.utils.export import export_pipeline
        paths = export_pipeline(stages, params,
                                os.path.join(log_dir, f"art_{tag}"),
                                batch=width)
        ports = _free_ports(len(stages) + 1)
        addrs = [f"127.0.0.1:{p}" for p in ports[:-1]]
        result = f"127.0.0.1:{ports[-1]}"
        env = node_env()
        procs, logs = [], []
        for k in range(len(stages)):
            nxt = addrs[k + 1] if k + 1 < len(stages) else result
            # --tier tcp: the delay-bound story rides the dsleep codec,
            # which an auto-negotiated shm hop would bypass
            argv = [sys.executable, "-m", "defer_tpu_torch", "node", *node_flags(),
                    "--artifact", paths[k], "--listen", addrs[k],
                    "--next", nxt, "--codec", codecs[k],
                    "--tier", "tcp"]
            lf = open(os.path.join(log_dir, f"{tag}_node{k}.log"), "w+")
            logs.append(lf)
            procs.append(subprocess.Popen(argv, env=env, stdout=lf,
                                          stderr=subprocess.STDOUT))
        _await_binds(procs, [f"stage{k}" for k in range(len(stages))],
                     logs, addrs)
        disp = ChainDispatcher(addrs[0], listen=result, codec="raw")
        dep = dict(procs=procs, logs=logs)
    if align and not quick:
        # re-anchor the stage processes' tracers so the sampled
        # requests' cross-process waterfalls share one timeline
        disp.align_clocks(addrs)
    door = ServeFrontDoor(backend=ChainBackend(
        disp, width, IN_SHAPE, trace_sample_every=sample)).start()
    return Deployment(door, disp, addrs, **dep)


def run_streams(addr, data, *, suffix, deadline_ms=None):
    """All tenants' samples through concurrent clients; returns wall."""
    host, port = addr

    def one(t):
        ServeClient(host, port, t + suffix,
                    deadline_ms=deadline_ms).stream(data[t])

    t0 = time.perf_counter()
    ths = [threading.Thread(target=one, args=(t,)) for t in data]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=300)
    return time.perf_counter() - t0


def check_seq_order(merged):
    """Per-process seqs must be non-decreasing along the merged log."""
    last: dict = {}
    for ev in merged:
        prev = last.get(ev["proc"])
        assert prev is None or ev["seq"] >= prev, (
            f"merged log reordered {ev['proc']} events: "
            f"{ev['seq']} after {prev}")
        last[ev["proc"]] = ev["seq"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="in-process thread chain (CI mode)")
    ap.add_argument("--delay-ms", type=float, default=25.0)
    ap.add_argument("--per-tenant", type=int, default=8)
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--sample", type=int, default=4,
                    help="request-scoped waterfall sampling period")
    ap.add_argument("--tolerance", type=float, default=0.10,
                    help="attribution sum-vs-wall bound (fraction)")
    ap.add_argument("--max-overhead", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:N, cpu, or an index N")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = pick_device(args.device)
    sys.setswitchinterval(SWITCH_INTERVAL_S)

    g = resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=3)
    codecs = [f"dsleep{args.delay_ms:g}+raw", "raw", "raw"]
    rng = np.random.default_rng(args.seed)
    tenants = ("alpha", "beta", "gamma")
    data = {t: [rng.standard_normal(IN_SHAPE).astype(np.float32)
                for _ in range(args.per_tenant)] for t in tenants}
    tr = tracer()
    rec = recorder()
    rec.clear()
    row = {"metric": "request_attribution", "unit": "frac_residual_p99",
           "mode": "quick" if args.quick else "full",
           "width": args.width, "delay_ms": args.delay_ms,
           "sample_every": args.sample}

    with tempfile.TemporaryDirectory(prefix="req_obs_") as tmp:
        # telemetry-off twin FIRST (its backend must not begin a trace)
        tr.enabled = False
        off = boot_door(stages, params, args.width, codecs,
                        quick=args.quick, log_dir=tmp, tag="off")
        tr.enabled = True
        tr.process = "serve"
        tr.start_trace()
        on = boot_door(stages, params, args.width, codecs,
                       quick=args.quick, log_dir=tmp, tag="on",
                       sample=args.sample, align=True)
        # the live plane: a ClusterView subscribed to the traced
        # chain's nodes (events ride its obs_push stream)
        on.view = ClusterView().connect(on.addrs, interval_ms=150.0,
                                        probe_clocks=False)
        try:
            # warm both chains outside the timed windows
            tr.enabled = False
            run_streams(off.addr, data, suffix="_w")
            tr.enabled = True
            run_streams(on.addr, data, suffix="_w")

            # -- 1. overhead: interleaved min-of-3 ---------------------
            w_off, w_on = [], []
            for rep in range(3):
                tr.enabled = False
                w_off.append(run_streams(off.addr, data,
                                         suffix=f"_o{rep}"))
                tr.enabled = True
                w_on.append(run_streams(on.addr, data,
                                        suffix=f"_t{rep}"))
            off.door.healthcheck()
            on.door.healthcheck()
            wall_off, wall_on = min(w_off), min(w_on)
            overhead = wall_on / wall_off - 1.0
            log(f"request_obs: telemetry off {wall_off:.3f}s vs on "
                f"{wall_on:.3f}s -> {overhead * 100:+.2f}% "
                f"(bound {args.max_overhead * 100:.0f}%)")
            assert overhead < args.max_overhead, (
                f"recorder+tracing overhead {overhead * 100:.2f}% "
                f"exceeds {args.max_overhead * 100:.0f}%")

            # -- 2. the serving smoke's burst: sheds + stragglers on one log
            cap_hz = args.width / (args.delay_ms / 1e3)
            offsets = poisson_trace(0.6 * cap_hz, 6.0,
                                    seed=args.seed + 1,
                                    bursts=[(1.5, 3.5, 2.0)])
            slo_ms = 10 * args.delay_ms
            host, port = on.addr
            client = ServeClient(host, port, "burst",
                                 deadline_ms=0.8 * slo_ms,
                                 timeout_s=300.0)
            # a deliberately tight expectation: the delay-bound stage 1
            # must flag as a sustained straggler while the burst runs
            detector = StragglerDetector([1.0, 1.0, 1.0], sustain=2)
            flags = []
            halt = threading.Event()

            def poll():
                while not halt.is_set():
                    flags.extend(detector.observe(on.view))
                    halt.wait(0.2)

            pt = threading.Thread(target=poll, daemon=True)
            pt.start()
            gen = LoadGenerator(client, data["alpha"], offsets).run()
            time.sleep(0.5)  # one more push interval for late events
            halt.set()
            pt.join(timeout=10)
            log(f"request_obs: burst offered {gen['offered']} "
                f"shed {gen['shed']} p99 {gen['latency_p99_ms']:.1f}ms; "
                f"straggler flags {sorted({f.stage for f in flags})}")
            assert gen["shed"] > 0, "the 2x burst should shed"
            assert any(f.stage == 1 for f in flags), \
                "the delay-bound stage was never flagged"
            merged = on.view.events()
            kinds = {e["kind"] for e in merged}
            assert "shed" in kinds and "straggler" in kinds, kinds
            sheds = [e for e in merged if e["kind"] == "shed"]
            assert len(sheds) == gen["shed"], (len(sheds), gen["shed"])
            check_seq_order(merged)
            assert rec.dropped == 0 and on.view.events_dropped == 0, \
                "the default-capacity ring must not drop under the burst"

            # -- 3. attribution of the sampled burst requests ----------
            if not args.quick:
                on.disp.collect_trace(on.addrs)
            spans = tr.spans
            reps = [r for r in attribute_sampled(
                spans, hop_tiers=["tcp"] * 4) if r.tenant == "burst"]
            assert len(reps) >= max(4, gen["completed"]
                                    // (2 * max(args.sample, 1))), \
                f"too few sampled requests attributed: {len(reps)}"
            picks = {"p50": reps[len(reps) // 2], "p99": reps[
                min(len(reps) - 1, int(0.99 * (len(reps) - 1)))]}
            for which, rep in picks.items():
                log(f"request_obs: {which} rid={rep.rid} wall "
                    f"{rep.wall_ms:.1f}ms sum {rep.sum_ms:.1f}ms "
                    f"residual {rep.residual_ms:+.1f}ms")
                assert rep.ok(args.tolerance), (which, rep.to_json())
                assert rep.buckets["transport.hop1"] >= \
                    0.5 * args.delay_ms, rep.to_json()
            # the trace spans front door + dispatcher + every stage on
            # one timeline (distinct OS processes in full mode)
            names = {s["name"] for s in spans}
            for want in ("serve.request", "serve.gather", "chain.tx",
                         "stage0.infer", "stage1.infer", "stage2.infer",
                         "serve.deliver"):
                assert want in names, (want, sorted(names)[:40])
            procs_seen = {s["proc"] for s in spans}
            if not args.quick:
                assert len(procs_seen) >= 4, procs_seen
            trace_file = os.path.join(tmp, "request_trace.json")
            from defer_tpu_torch.obs import export_chrome_trace
            export_chrome_trace(trace_file)
            assert os.path.getsize(trace_file) > 0

            row.update(
                value=round(abs(picks["p99"].residual_ms)
                            / max(picks["p99"].wall_ms, 1e-9), 4),
                overhead_frac=round(overhead, 4),
                wall_off_s=round(wall_off, 4),
                wall_on_s=round(wall_on, 4),
                burst={"offered": gen["offered"], "shed": gen["shed"],
                       "p99_ms": gen["latency_p99_ms"],
                       "slo_ms": slo_ms},
                sampled_requests=len(reps),
                p50_attrib=picks["p50"].to_json(),
                p99_attrib=picks["p99"].to_json(),
                events={"merged": len(merged),
                        "sheds": len(sheds),
                        "stragglers": len([e for e in merged
                                           if e["kind"] == "straggler"]),
                        "dropped": 0},
                trace_procs=len(procs_seen),
                cpu_count=os.cpu_count() or 1)
        finally:
            tr.enabled = True  # teardown spans are harmless
            off.close()
            on.close()
            tr.enabled = False
            tr.clear()

    print(json.dumps(row), flush=True)
    log("request_obs smoke: OK")


if __name__ == "__main__":
    main()
