"""Chaos smoke: replica failover + zero-downtime live replan.

Both legs of the seq-replay substrate (docs/ROBUSTNESS.md) — the same
retain-until-ack / quiesce mechanism driven from its two entry points:

1. FAILOVER (multi-process): a 3-stage resnet_tiny chain with stage 1
   replicated R=2 and ``failover=True``, stage-1 frames slowed so the
   stream is mid-flight when a killer thread SIGKILLs replica 0.  The
   supervisor respawns it on its old port, the upstream fan-out heals
   (redial + preamble + replay of unacked frames), and the run must
   end byte-identical to an undisturbed reference over the same
   inputs.  The healed hop's ``failover`` flight-recorder event — read
   back through the nodes' teardown stats — carries the replayed-frame
   count and the recovery wall time, which becomes the bench row's
   value.

2. REPLAN (in-process persist chain): stream half the inputs, cut the
   chain over to a different set of cuts mid-stream via
   :class:`~defer_tpu_torch.plan.replan.LiveReplan` (quiesce -> in-band
   redeploy onto the same processes -> resume), stream the rest.  The
   combined output must be byte-identical to the segment-wise
   composition of two plain runs; the receipt's ``cutover_ms`` lands
   in the row.

Exit 0 on success; one JSON row on stdout (the ``pipeline_failover``
row of ``benchmarks/run.py``).

The PyTorch port's copy of ``scripts/chaos_smoke.py``: the same checks,
flags, bounds and row, run on ``--device`` (the card by default; the node
processes it spawns run there too).

Usage:  python scripts/torch_chaos_smoke.py [--quick] [--count N]
            [--stage-delay-s 0.4] [--device cuda|cpu]
"""

import argparse
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


def _failover_events(stats_rows: list) -> list[dict]:
    """Every ``failover`` flight-recorder event the teardown stats
    carried (the healed fan-out lives in the upstream stage's
    process; its events ride that node's stats payload)."""
    out = []
    for row in stats_rows:
        if not isinstance(row, dict):
            continue
        for e in (row.get("events") or {}).get("events", []):
            if e.get("kind") == "failover":
                out.append(e)
    return out


# ---------------------------------------------------------------------------
# leg 1: kill -9 a mid-chain replica, multi-process
# ---------------------------------------------------------------------------

def run_failover(count: int, stage_delay_s: float, kill_at: int) -> dict:
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
            log(f"chaos: SIGKILL pid {procs[1].pid} (stage 1, replica 0)")
            procs[1].send_signal(signal.SIGKILL)
        threading.Thread(target=killer, daemon=True).start()

    stats: list = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = run_chain(stages, params, feeder(), batch=1,
                         **chain_opts(),
                         replicas={1: 2}, failover=True,
                         on_spawn=on_spawn, artifact_dir=tmp,
                         stage_delays=[0.0, stage_delay_s, 0.0],
                         stats_out=stats)
        wall_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_chain(stages, params, list(xs), batch=1,
                        **chain_opts(),
                        artifact_dir=tmp)
    if len(outs) != count or len(ref) != count:
        raise SystemExit(f"FAIL: {len(outs)} outputs, {len(ref)} "
                         f"reference, wanted {count}")
    for i, (a, b) in enumerate(zip(outs, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"sample {i}")
    evs = _failover_events(stats)
    if not evs:
        raise SystemExit("FAIL: stream survived but no `failover` event "
                         "reached the teardown stats — the kill missed "
                         "the in-flight window (raise --stage-delay-s)")
    ev = evs[-1]["data"]
    log(f"chaos: byte-identical x{count}, {len(evs)} failover(s), "
        f"replayed={ev.get('replayed')}, "
        f"recovery={ev.get('recovery_ms')}ms, wall={wall_s:.1f}s")
    return {"byte_identical": True, "count": count,
            "failovers": len(evs),
            "replayed": int(ev.get("replayed", 0)),
            "recovery_ms": float(ev.get("recovery_ms", 0.0)),
            "wall_s": round(wall_s, 2)}


# ---------------------------------------------------------------------------
# leg 2: live replan cutover, in-process persist chain
# ---------------------------------------------------------------------------

def run_replan(count: int) -> dict:
    from defer_tpu_torch.graph.analysis import valid_cut_points
    from defer_tpu_torch.plan.cost import StageCostModel
    from defer_tpu_torch.plan.replan import LiveReplan
    from defer_tpu_torch.plan.solver import evaluate_cuts, solve
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode

    g = resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    cost = StageCostModel(g)
    plan1 = solve(g, 3, cost)
    valid = [c for c in g.topo_order if c in set(valid_cut_points(g))]
    cuts2 = next(([a, b] for i, a in enumerate(valid)
                  for b in valid[i + 1:]
                  if [a, b] != list(plan1.cuts)), None)
    if cuts2 is None:
        raise SystemExit("FAIL: no alternative cut pair on resnet_tiny")
    plan2 = evaluate_cuts(g, cuts2, cost)
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
          for _ in range(count)]
    cut = count // 2

    def boot(persist: bool):
        nodes = [StageNode(None, "127.0.0.1:0", None, **node_opts(), persist=persist)
                 for _ in range(3)]
        addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
        ths = [threading.Thread(target=n.serve, daemon=True)
               for n in nodes]
        for t in ths:
            t.start()
        return addrs, ths

    addrs, ths = boot(True)
    disp = ChainDispatcher(addrs[0], codec="raw")
    disp.deploy(partition(g, list(plan1.cuts)), params, addrs, batch=1)
    live = LiveReplan(disp, g, params, addrs, batch=1)
    outs = disp.stream(xs[:cut])
    receipt = live.apply(plan2)
    outs += disp.stream(xs[cut:])
    disp.close()
    live.shutdown()
    for t in ths:
        t.join(timeout=30)

    def plain(cuts, inputs):
        p_addrs, p_ths = boot(False)
        d = ChainDispatcher(p_addrs[0], codec="raw")
        d.deploy(partition(g, list(cuts)), params, p_addrs, batch=1)
        got = d.stream(inputs)
        d.close()
        for t in p_ths:
            t.join(timeout=30)
        return got

    ref = plain(plan1.cuts, xs[:cut]) + plain(plan2.cuts, xs[cut:])
    for i, (a, b) in enumerate(zip(outs, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"sample {i}")
    log(f"chaos: replan byte-identical x{count}, "
        f"cutover={receipt['cutover_ms']}ms, "
        f"quiesced={receipt['quiesced']}")
    return {"replan_byte_identical": True,
            "cutover_ms": float(receipt["cutover_ms"]),
            "quiesced": receipt["quiesced"],
            "old_cuts": list(plan1.cuts),
            "new_cuts": list(plan2.cuts)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="CI budget: fewer frames, single kill trial")
    ap.add_argument("--count", type=int, default=0,
                    help="frames per leg (0 = 16 quick / 24 full)")
    ap.add_argument("--stage-delay-s", type=float, default=0.4,
                    help="per-frame stage-1 delay keeping the kill "
                         "inside the in-flight window")
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:N, cpu, or an index N")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = pick_device(args.device)
    sys.setswitchinterval(SWITCH_INTERVAL_S)
    count = args.count or (16 if args.quick else 24)

    t0 = time.time()
    fo = run_failover(count, args.stage_delay_s, kill_at=count // 3)
    rp = run_replan(max(8, count // 2))
    row = {"metric": "pipeline_failover",
           "value": round(fo["recovery_ms"], 3),
           "unit": "ms recovery",
           **fo, **rp,
           "elapsed_s": round(time.time() - t0, 1)}
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
