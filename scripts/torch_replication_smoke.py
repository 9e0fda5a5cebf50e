"""Stage-replication smoke: prove hybrid pipeline/data-parallelism pays.

A 3-stage resnet_tiny chain is given an artificial bottleneck stage:
stage 1's inbound hop uses a decode-side delay codec (``dsleep<ms>+raw``)
and its outbound hop an encode-side one (``esleep<ms>+raw``), so every
frame costs the *stage-1 process* a fixed non-CPU delay on each side —
the resource profile of an accelerator-bound fat stage a 1-core host
cannot express with real compute.  No cut can fix a single slow stage;
running R=2 data-parallel replicas of it (``--replicas stage1=2``,
ordered fan-out/fan-in with protocol-v2 sequence numbers) should halve
its effective service time.

Checks:

1. QUICK (in-process thread chain): replicated vs serial over identical
   inputs — byte-identical outputs in identical ORDER (the reorder merge
   is exercised for real: per-replica ``stage1.rN.*`` spans must appear
   in the collected trace, and the round-robin split must show in per-
   replica ``stats``), measured speedup >= ``--quick-min-speedup``.

2. SOLVER (predictive): on a cost model with one dominating stage, the
   replica-aware solver must replicate that stage and predict a
   bottleneck <= the best cuts-only plan's (the full DP-vs-brute-force
   property lives in tests/test_plan.py).

3. SPEEDUP (multi-process, skipped with ``--quick``): the same chain as
   real OS processes — R=2 replicas of stage 1 vs the unreplicated
   baseline, warmup excluded, byte-identical outputs required, measured
   throughput >= ``--min-speedup`` (default 1.5) better.  The delays
   sleep rather than burn CPU, so the win is real even on a 1-core CI
   host.

Exit 0 on success; one JSON row on stdout (the ``stage_replication`` row
of ``benchmarks/run.py``).

The PyTorch port's copy of ``scripts/replication_smoke.py``: the same checks,
flags, bounds and row, run on ``--device`` (the card by default; the node
processes it spawns run there too).

Usage:  python scripts/torch_replication_smoke.py [--quick] [--delay-ms D]
            [--count N] [--min-speedup 1.5] [--device cuda|cpu]
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
    """Per-stage outbound codecs that park the whole delay budget inside
    stage 1's process(es): decode-side sleep on its inbound hop,
    encode-side sleep on its outbound hop."""
    return [f"dsleep{delay_ms:g}+raw", f"esleep{delay_ms:g}+raw", "raw"]


# ---------------------------------------------------------------------------
# part 1: in-process thread chain — byte-identity, ordering, trace, speedup
# ---------------------------------------------------------------------------

def run_inproc(stages, params, xs, *, replicate: int, delay_ms: float):
    """Thread-per-node chain with the delay codecs; stage 1 optionally
    replicated.  Returns (outs, seconds, stats, spans)."""
    from defer_tpu_torch.obs import enable_tracing, tracer
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode

    tr = enable_tracing(process="dispatcher")
    tr.start_trace()
    r1 = max(1, replicate)
    groups = [
        [StageNode(None, "127.0.0.1:0", None, **node_opts())],
        [StageNode(None, "127.0.0.1:0", None, **node_opts(),
                   replica=j if r1 > 1 else None) for j in range(r1)],
        [StageNode(None, "127.0.0.1:0", None, **node_opts(), fan_in=r1)],
    ]
    addr_groups = [[f"127.0.0.1:{n.address[1]}" for n in grp]
                   for grp in groups]
    flat = [n for grp in groups for n in grp]
    threads = [threading.Thread(target=n.serve, daemon=True) for n in flat]
    for t in threads:
        t.start()
    disp = ChainDispatcher(addr_groups[0][0], codec="raw")
    try:
        disp.deploy(stages, params, addr_groups, batch=xs[0].shape[0],
                    codecs=hop_codecs(delay_ms))
        disp.stream(xs[:2])            # warm: compile + connect
        tracer().drain()               # drop warmup spans
        t0 = time.perf_counter()
        outs = disp.stream(xs)
        dt = time.perf_counter() - t0
        stats = disp.stats([a for grp in addr_groups for a in grp])
        spans = tracer().drain()
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=60)
    return outs, dt, stats, spans


def quick_check(stages, params, *, count: int, batch: int,
                delay_ms: float, min_speedup: float) -> dict:
    import numpy as np

    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)
          for _ in range(count)]
    base, base_s, _, _ = run_inproc(stages, params, xs, replicate=1,
                                    delay_ms=delay_ms)
    rep, rep_s, stats, spans = run_inproc(stages, params, xs, replicate=2,
                                          delay_ms=delay_ms)
    assert len(base) == len(rep) == count
    for a, b in zip(base, rep):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # the round-robin actually split the stream across both replicas
    per_rep = {s["replica"]: s["processed"] for s in stats
               if s.get("stage") == 1}
    assert set(per_rep) == {0, 1}, per_rep
    assert min(per_rep.values()) >= count // 2 - 1, per_rep

    # per-replica spans prove the interleave is observable
    names = {s.get("name", "") for s in spans}
    for r in (0, 1):
        assert any(n.startswith(f"stage1.r{r}.") for n in names), (
            f"no stage1.r{r}.* spans in the trace: {sorted(names)[:10]}")

    speedup = base_s / rep_s
    log(f"quick: serial {count * batch / base_s:6.1f} inf/s, replicated "
        f"{count * batch / rep_s:6.1f} inf/s -> {speedup:.3f}x "
        f"(split {per_rep})")
    assert speedup >= min_speedup, (
        f"in-process replication speedup {speedup:.3f}x under the "
        f"{min_speedup}x bar")
    return {"serial_s": base_s, "replicated_s": rep_s,
            "speedup": round(speedup, 4),
            "replica_split": {str(k): v for k, v in per_rep.items()}}


# ---------------------------------------------------------------------------
# part 2: the solver predicts replication for a dominating stage
# ---------------------------------------------------------------------------

def solver_check() -> dict:
    """One fat indivisible stage: cuts alone cannot beat it, replicas
    can.  The full optimality property (DP == brute force) is in
    tests/test_plan.py; this is the smoke-level sanity tie-in."""
    from defer_tpu_torch.graph import GraphBuilder
    from defer_tpu_torch.graph import ops
    from defer_tpu_torch.plan import StageCostModel, solve, solve_replicated

    b = GraphBuilder("fatstage")
    x = b.input((16,))
    x = b.add(ops.Dense(16), x, name="pre")
    x = b.add(ops.Dense(16), x, name="fat")
    x = b.add(ops.Dense(16), x, name="post")
    g = b.build()
    costs = {"pre": 1e-4, "fat": 1e-3, "post": 1e-4}  # fat dominates 10x
    cm = StageCostModel(g, gen="v4", link_bw_s=1e9, node_costs=costs)
    budget = 4
    rp = solve_replicated(g, cm, num_nodes=budget)
    cuts_only = min((solve(g, s, cm) for s in range(1, 4)),
                    key=lambda p: p.bottleneck_s)
    assert rp.bottleneck_s <= cuts_only.bottleneck_s * (1 + 1e-9), (
        rp.bottleneck_s, cuts_only.bottleneck_s)
    assert max(rp.replicas) > 1, (
        f"solver kept every stage unreplicated for a 10x-dominant "
        f"stage: {rp.to_json()}")
    # the replicated stage must be the one containing the fat node
    k = rp.bottleneck_stage if max(rp.replicas) == 1 else \
        rp.replicas.index(max(rp.replicas))
    log(f"solver: cuts-only bottleneck {cuts_only.bottleneck_s * 1e3:.3f} "
        f"ms vs hybrid {rp.bottleneck_s * 1e3:.3f} ms "
        f"(cuts {rp.cuts}, replicas {rp.replicas}, budget {budget})")
    return {"cuts_only_bottleneck_ms": round(cuts_only.bottleneck_s * 1e3, 4),
            "hybrid_bottleneck_ms": round(rp.bottleneck_s * 1e3, 4),
            "predicted_speedup": round(
                cuts_only.bottleneck_s / rp.bottleneck_s, 4),
            "replicas": rp.replicas, "cuts": rp.cuts,
            "replicated_stage": k}


# ---------------------------------------------------------------------------
# part 3: multi-process chain — the >= 1.5x measured throughput claim
# ---------------------------------------------------------------------------

def _free_ports(n):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def timed_chain(paths, xs_warm, xs, *, replicate: int, delay_ms: float,
                log_dir: str):
    """Spawn the 3-stage chain as OS processes (stage 1 as ``replicate``
    replicas), warm it, stream ``xs`` timed, tear down.  Returns
    (outputs, seconds, stats).  Uses run_chain's hardening helpers
    (bind await, kill-all teardown) so a lost port race or dead child
    fails fast and attributed instead of stalling out the dispatcher
    timeout; the caller retries on ``_BindRace``."""
    from defer_tpu_torch.runtime.node import (ChainDispatcher, _await_binds,
                                        _kill_procs)

    codecs = hop_codecs(delay_ms)
    r1 = max(1, replicate)
    ports = _free_ports(2 + r1 + 1)
    s1_addrs = [f"127.0.0.1:{ports[1 + j]}" for j in range(r1)]
    s2_addr = f"127.0.0.1:{ports[1 + r1]}"
    result = f"127.0.0.1:{ports[-1]}"
    mode = f"rep{r1}"
    # --tier tcp everywhere: this row measures stage REPLICATION over
    # the wire protocol; an auto-negotiated shm hop on the non-fan
    # boundaries would bypass the dsleep/esleep codecs that make the
    # middle stage the bottleneck
    argvs = [[sys.executable, "-m", "defer_tpu_torch", "node", *node_flags(),
              "--artifact", paths[0], "--listen", f"127.0.0.1:{ports[0]}",
              "--next", ",".join(s1_addrs), "--codec", codecs[0],
              "--tier", "tcp"]]
    for j in range(r1):
        argv = [sys.executable, "-m", "defer_tpu_torch", "node", *node_flags(),
                "--artifact", paths[1], "--listen", s1_addrs[j],
                "--next", s2_addr, "--codec", codecs[1], "--tier", "tcp"]
        if r1 > 1:
            argv += ["--replica", str(j)]
        argvs.append(argv)
    argv = [sys.executable, "-m", "defer_tpu_torch", "node", *node_flags(),
            "--artifact", paths[2], "--listen", s2_addr,
            "--next", result, "--codec", codecs[2], "--tier", "tcp"]
    if r1 > 1:
        argv += ["--fan-in", str(r1)]
    argvs.append(argv)

    child_env = node_env()
    procs, logs = [], []
    all_addrs = [f"127.0.0.1:{ports[0]}"] + s1_addrs + [s2_addr]
    labels = [f"node{i}" for i in range(len(argvs))]
    failed = True
    try:
        for i, argv in enumerate(argvs):
            lf = open(os.path.join(log_dir, f"{mode}_node_{i}.log"), "w+")
            logs.append(lf)
            procs.append(subprocess.Popen(argv, env=child_env, stdout=lf,
                                          stderr=subprocess.STDOUT))
        _await_binds(procs, labels, logs, all_addrs)
        disp = ChainDispatcher(f"127.0.0.1:{ports[0]}", listen=result,
                               codec="raw")
        try:
            disp.stream(xs_warm)   # boot+compile excluded from the window
            t0 = time.perf_counter()
            outs = disp.stream(xs)
            dt = time.perf_counter() - t0
            stats = disp.stats(all_addrs)
            failed = False
        finally:
            if failed:
                _kill_procs(procs)  # dead sockets make close() fast
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
    return outs, dt, stats


def speedup_check(stages, params, *, count: int, batch: int,
                  delay_ms: float, min_speedup: float) -> dict:
    import numpy as np

    from defer_tpu_torch.utils.export import export_pipeline

    from defer_tpu_torch.runtime.node import _BindRace

    def with_retry(**kw):
        for attempt in range(3):
            try:
                return timed_chain(**kw)
            except _BindRace as e:
                log(f"bind race on attempt {attempt + 1} ({e}); retrying")
        return timed_chain(**kw)

    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)
          for _ in range(count)]
    xs_warm = xs[:4]
    with tempfile.TemporaryDirectory(prefix="defer_repl_") as tmp:
        paths = export_pipeline(stages, params, tmp, batch=batch)
        base, base_s, _ = with_retry(paths=paths, xs_warm=xs_warm, xs=xs,
                                     replicate=1, delay_ms=delay_ms,
                                     log_dir=tmp)
        log(f"serial:     {count * batch / base_s:8.1f} inf/s "
            f"({base_s:.2f}s)")
        rep, rep_s, stats = with_retry(paths=paths, xs_warm=xs_warm,
                                       xs=xs, replicate=2,
                                       delay_ms=delay_ms, log_dir=tmp)
        log(f"replicated: {count * batch / rep_s:8.1f} inf/s "
            f"({rep_s:.2f}s)")
    assert len(base) == len(rep) == count
    for a, b in zip(base, rep):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    per_rep = {s["replica"]: s["processed"] for s in stats
               if s.get("stage") == 1}
    speedup = base_s / rep_s
    log(f"stage1 split across replicas: {per_rep} -> {speedup:.3f}x")
    assert speedup >= min_speedup, (
        f"stage replication speedup {speedup:.3f}x is under the "
        f"{min_speedup}x bar (serial {count * batch / base_s:.1f} inf/s, "
        f"replicated {count * batch / rep_s:.1f} inf/s)")
    return {"serial_s": base_s, "replicated_s": rep_s,
            "speedup": round(speedup, 4),
            "serial_inf_s": round(count * batch / base_s, 2),
            "replicated_inf_s": round(count * batch / rep_s, 2),
            "replica_split": {str(k): v for k, v in per_rep.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-speedup", type=float, default=1.5,
                    help="required replicated/serial throughput ratio "
                         "(multi-process chain)")
    ap.add_argument("--quick-min-speedup", type=float, default=1.2,
                    help="required ratio for the in-process quick check "
                         "(more scheduling noise, lower bar)")
    ap.add_argument("--count", type=int, default=24,
                    help="timed microbatches through each chain")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--delay-ms", type=float, default=25.0,
                    help="per-side bottleneck-stage delay")
    ap.add_argument("--quick", action="store_true",
                    help="in-process + solver checks only (no spawns)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default), cuda:N, cpu, or an index N")
    args = ap.parse_args(argv)
    global DEVICE
    DEVICE = pick_device(args.device)
    sys.setswitchinterval(SWITCH_INTERVAL_S)

    import torch

    from defer_tpu_torch import partition
    from defer_tpu_torch.models import resnet_tiny

    graph = resnet_tiny()
    params = graph.init(torch.Generator().manual_seed(0))
    stages = partition(graph, num_stages=3)

    r_quick = quick_check(stages, params, count=min(args.count, 16),
                          batch=min(args.batch, 2),
                          delay_ms=min(args.delay_ms, 15.0),
                          min_speedup=args.quick_min_speedup)
    r_solver = solver_check()

    row = {"metric": "stage_replication", "unit": "x_vs_serial_chain",
           "stages": len(stages), "replicas": {"stage1": 2},
           "count": args.count, "batch": args.batch,
           "delay_ms": args.delay_ms,
           "cpu_count": os.cpu_count() or 1,
           "quick": r_quick, "solver": r_solver}
    if args.quick:
        row["value"] = None
    else:
        r = speedup_check(stages, params, count=args.count,
                          batch=args.batch, delay_ms=args.delay_ms,
                          min_speedup=args.min_speedup)
        row.update({"value": r["speedup"], **{
            k: v for k, v in r.items() if k != "speedup"}})
    print(json.dumps(row))
    log("stage replication smoke: OK")


if __name__ == "__main__":
    main()
