"""Black-box smoke: kill -9 forensics + journaling overhead.

Two legs over the flight-recorder journal (docs/OBSERVABILITY.md,
"Black box & postmortem"):

1. FIRST FAULT (multi-process): a 3-stage resnet_tiny chain with
   stage 1 replicated R=2, ``failover=True`` and ``--journal-dir`` on
   every process, stage-1 frames slowed so the stream is mid-flight
   when a killer thread SIGKILLs replica 0.  The supervisor respawns
   it AND auto-emits a postmortem bundle; after the stream completes
   (byte-identical to an undisturbed reference) the smoke re-runs
   :func:`~defer_tpu_torch.obs.collect_postmortem` OFFLINE — every process
   is gone, only the on-disk journals remain — and asserts the
   verdict: ``first_fault`` names the killed replica (``stage1.r0``),
   the journal-stop evidence backs it, the nearest DOWNSTREAM stage is
   the first-ranked casualty, and the aligned timeline has no negative
   inter-process gap (the dispatcher's ``replica_respawn`` event lands
   at/after the victim journal's last write — clocks from different
   dead processes, aligned purely by their anchor records).

2. OVERHEAD: one in-process 3-stage delay chain (dsleep/esleep hop
   codecs park the budget in stage 1), streamed with the journal
   STOPPED then STARTED, alternately, three rounds — interleaving
   cancels host drift, min-of-3 absorbs scheduler spikes — and the
   journaling wall tax must stay under ``--max-overhead`` (default
   5%).

Exit 0 on success; one JSON row on stdout (the ``blackbox_overhead``
row of ``benchmarks/run.py``).

The PyTorch port's copy of ``scripts/postmortem_smoke.py``: the same checks,
flags, bounds and row, run on ``--device`` (the card by default; the node
processes it spawns run there too).

Usage:  python scripts/torch_postmortem_smoke.py [--quick] [--count N]
            [--stage-delay-s 0.4] [--max-overhead 0.05] [--device cuda|cpu]
"""

import argparse
import glob
import json
import os
import signal
import sys
import tempfile
import threading
import time


import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from defer_tpu_torch import partition  # noqa: E402
from defer_tpu_torch.models import resnet_tiny  # noqa: E402
from defer_tpu_torch.runtime.node import run_chain  # noqa: E402


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


# ---------------------------------------------------------------------------
# leg 1: kill -9 a replica, then explain it from the journals alone
# ---------------------------------------------------------------------------

def run_first_fault(count: int, stage_delay_s: float, kill_at: int,
                    jdir: str, out_dir: str) -> dict:
    g = resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=3)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((1,) + stages[0].in_spec.shape)
          .astype(np.float32) for _ in range(count)]
    started = threading.Event()

    def feeder():
        for i, x in enumerate(xs):
            if i == kill_at:
                started.set()
            yield x

    def on_spawn(procs):
        # procs are one per stage REPLICA in stage-major order:
        # [s0, s1.r0, s1.r1, s2] — kill stage 1, replica 0
        def killer():
            started.wait(180)
            time.sleep(0.3)
            log(f"postmortem: SIGKILL pid {procs[1].pid} "
                f"(stage 1, replica 0)")
            procs[1].send_signal(signal.SIGKILL)
        threading.Thread(target=killer, daemon=True).start()

    with tempfile.TemporaryDirectory() as tmp:
        outs = run_chain(stages, params, feeder(), batch=1,
                         **chain_opts(),
                         replicas={1: 2}, failover=True,
                         on_spawn=on_spawn, artifact_dir=tmp,
                         stage_delays=[0.0, stage_delay_s, 0.0],
                         journal_dir=jdir)
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_chain(stages, params, list(xs), batch=1,
                        **chain_opts(),
                        artifact_dir=tmp)
    if len(outs) != count or len(ref) != count:
        raise SystemExit(f"FAIL: {len(outs)} outputs, {len(ref)} "
                         f"reference, wanted {count}")
    for i, (a, b) in enumerate(zip(outs, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"sample {i}")

    # the supervisor's autopsy fired fire-and-forget ~0.75s after the
    # respawn, mid-stream — its bundle must be on disk by now
    deadline = time.time() + 10
    auto = []
    while time.time() < deadline:
        auto = sorted(glob.glob(os.path.join(jdir, "bundle-*",
                                             "bundle.json")))
        if auto:
            break
        time.sleep(0.2)
    assert auto, (f"no auto-emitted bundle under {jdir} — the failover "
                  f"supervisor's autopsy never landed")
    with open(auto[0]) as fh:
        auto_bundle = json.load(fh)
    assert auto_bundle.get("reason", "").startswith("failover:"), \
        auto_bundle.get("reason")
    assert len(auto_bundle["procs"]) >= 4, auto_bundle["procs"]

    # OFFLINE collect: every chain process has exited; the bundle is
    # assembled from nothing but the on-disk journals
    from defer_tpu_torch.obs import collect_postmortem
    bundle = collect_postmortem(jdir, out_dir=out_dir,
                                reason="postmortem_smoke offline")
    for w in bundle["warnings"]:
        log(f"postmortem: bundle warning: {w}")

    procs = bundle["procs"]
    names = {p["proc"] for p in procs}
    want = {"dispatcher", "stage0", "stage1.r0", "stage1.r1", "stage2"}
    assert want <= names, f"journals missing: {want - names}"
    # the killed pid AND its respawn both journaled under stage1.r0
    r0 = [p for p in procs if p["proc"] == "stage1.r0"]
    assert len(r0) >= 2, (f"expected dead + respawned stage1.r0 "
                          f"journals, got {r0}")

    v = bundle["verdict"]
    assert v["first_fault"] == "stage1.r0", v
    assert any("stops at" in e for e in v["evidence"]), v["evidence"]
    assert v["casualties"], "no casualties ranked"
    first_cas = v["casualties"][0]
    assert first_cas["proc"] == "stage2", v["casualties"]
    assert first_cas["role"] == "downstream", v["casualties"]
    assert isinstance(bundle["events_dropped"], int)

    # clock alignment across DEAD processes: the supervisor's
    # replica_respawn (dispatcher clock) must land at/after the
    # victim's last journal write (victim clock) — a negative gap
    # means the anchor alignment is wrong
    respawn = next(e for e in bundle["timeline"]
                   if e["kind"] == "replica_respawn")
    victim_last = min(p["last_us"] for p in r0)
    gap_s = (respawn["t_us"] - victim_last) / 1e6
    assert gap_s >= 0, (f"respawn at {respawn['t_us']}us precedes the "
                        f"victim's last write {victim_last}us "
                        f"({gap_s:.3f}s) — clock alignment failed")
    ts = [e["t_us"] for e in bundle["timeline"]]
    assert ts == sorted(ts), "merged timeline is not time-ordered"

    trace = os.path.join(out_dir, "trace.json")
    with open(trace) as fh:
        doc = json.load(fh)
    tprocs = {e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M"}
    assert len(tprocs) >= 5, tprocs

    log(f"postmortem: byte-identical x{count}, {len(procs)} journals, "
        f"first_fault={v['first_fault']}, casualty[0]={first_cas['proc']}"
        f" ({first_cas['role']}), respawn gap +{gap_s:.2f}s, "
        f"auto bundle at {os.path.dirname(auto[0])}")
    return {"byte_identical": True, "count": count,
            "journals": len(procs),
            "first_fault": v["first_fault"],
            "casualties": [c["proc"] for c in v["casualties"]],
            "respawn_gap_s": round(gap_s, 3),
            "events_dropped": bundle["events_dropped"],
            "auto_bundle": True,
            "timeline_events": len(bundle["timeline"])}


# ---------------------------------------------------------------------------
# leg 2: the journaling tax
# ---------------------------------------------------------------------------

def run_overhead(count: int, delay_ms: float, rounds: int,
                 root: str) -> dict:
    from defer_tpu_torch.obs import (read_process_journals, start_journal,
                               stop_journal)
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode

    g = resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=3)
    codecs = [f"dsleep{delay_ms:g}+raw", f"esleep{delay_ms:g}+raw",
              "raw"]
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((1,) + stages[0].in_spec.shape)
          .astype(np.float32) for _ in range(count)]

    nodes = [StageNode(None, "127.0.0.1:0", None, **node_opts()) for _ in range(3)]
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    ths = [threading.Thread(target=n.serve, daemon=True) for n in nodes]
    for t in ths:
        t.start()
    disp = ChainDispatcher(addrs[0], codec="raw")
    disp.deploy(stages, params, addrs, batch=1, codecs=codecs)
    try:
        disp.stream(xs[:4])       # compile + connect outside the clock
        # ONE chain, alternating journal-off / journal-on streams:
        # each pair sees the same background load, so host drift
        # cancels; min-of-3 absorbs per-stream scheduler spikes
        w_off, w_on = [], []
        for r in range(rounds):
            stop_journal()
            t0 = time.perf_counter()
            disp.stream(xs)
            w_off.append(time.perf_counter() - t0)
            start_journal(os.path.join(root, f"round{r}"), "bench")
            t0 = time.perf_counter()
            disp.stream(xs)
            w_on.append(time.perf_counter() - t0)
        stop_journal()
    finally:
        disp.close()
        for t in ths:
            t.join(timeout=30)
    wall_off, wall_on = min(w_off), min(w_on)
    overhead = wall_on / wall_off - 1.0
    # the journal must have actually spilled during the on-streams
    spilled = sum(len(j["records"])
                  for r in range(rounds)
                  for j in read_process_journals(
                      os.path.join(root, f"round{r}")))
    assert spilled > 0, "journal-on rounds wrote no records"
    log(f"postmortem: journaling off {wall_off:.3f}s / on {wall_on:.3f}s"
        f" -> overhead {overhead * 100:+.2f}% ({spilled} records "
        f"spilled over {rounds} rounds)")
    return {"wall_off_s": round(wall_off, 4),
            "wall_on_s": round(wall_on, 4),
            "overhead": overhead, "spilled_records": spilled}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="CI budget: fewer frames")
    ap.add_argument("--count", type=int, default=0,
                    help="frames for the kill leg (0 = 12 quick / 18 "
                         "full)")
    ap.add_argument("--stage-delay-s", type=float, default=0.4,
                    help="per-frame stage-1 delay keeping the kill "
                         "inside the in-flight window")
    ap.add_argument("--delay-ms", type=float, default=6.0,
                    help="per-hop codec delay for the overhead leg")
    ap.add_argument("--max-overhead", type=float, default=0.05,
                    help="journaling wall overhead bound vs journal-off")
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:N, cpu, or an index N")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = pick_device(args.device)
    sys.setswitchinterval(SWITCH_INTERVAL_S)
    count = args.count or (12 if args.quick else 18)

    t0 = time.time()
    with tempfile.TemporaryDirectory() as jdir, \
            tempfile.TemporaryDirectory() as out:
        ff = run_first_fault(count, args.stage_delay_s,
                             kill_at=count // 3, jdir=jdir,
                             out_dir=os.path.join(out, "bundle"))
        ov = run_overhead(32 if args.quick else 48, args.delay_ms,
                          rounds=3, root=os.path.join(out, "bench"))
    assert ov["overhead"] < args.max_overhead, (
        f"journaling overhead {ov['overhead'] * 100:.2f}% exceeds "
        f"{args.max_overhead * 100:.0f}% (on {ov['wall_on_s']}s vs off "
        f"{ov['wall_off_s']}s)")
    row = {"metric": "blackbox_overhead",
           "value": round(ov["overhead"], 4),
           "unit": "frac_wall_overhead_vs_no_journal",
           "quick": args.quick,
           **ff, **{k: v for k, v in ov.items() if k != "overhead"},
           "elapsed_s": round(time.time() - t0, 1)}
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
