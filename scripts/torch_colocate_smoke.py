"""Colocated fast-path smoke: prove the transport tiers pay.

A 3-stage resnet_tiny chain is made codec-delay-bound the same way
``torch_replication_smoke.py`` does: stage 0's outbound hop uses a decode-side
delay codec (``dsleep<ms>+raw``) and stage 1's an encode-side one
(``esleep<ms>+raw``), so every frame charges the chain a fixed non-CPU
delay per inter-stage hop — the resource profile of real host
serialization cost, expressible on a 1-core box.  The colocated tiers
eliminate exactly that cost: a ``local`` hop hands the live array
through an in-memory channel (no codec runs at all) and a ``device`` hop
fuses the two stages into one exported program (no hop at all).

Checks:

1. QUICK / LOCAL (in-process thread chain): the same inputs through the
   all-TCP chain and the all-``auto`` chain (every hop negotiates
   ``local``) — byte-identical outputs, every stats row reports the
   negotiated ``local`` tier, zero ``codec.*`` histogram samples on the
   colocated run, and min-of-3 wall ≥ ``--quick-min-speedup`` faster.

2. FUSED (in-process): ``hop_tiers=["device","device"]`` collapses the
   chain to ONE stage program — byte-identical to the 3-stage TCP chain,
   and the inter-stage frame provably GONE: zero wire tensor frames
   during the stream, fewer local frames than the unfused local chain,
   and no ``stage1.*``/``stage2.*`` or ``.rx``/``.tx`` spans in the
   collected trace (span/counter absence, not just speed).

3. PLANNER: given the hop-tier map, the solver's colocated plan predicts
   a bottleneck ≤ (strictly < on this comm-bound model) the TCP-only
   plan's — cut placement exploits colocation.

4. FULL (multi-process, skipped with ``--quick``): the same chain as
   real OS processes — 3 separate processes over TCP vs ONE process
   hosting all 3 stages (``node --co-stage``, hops negotiated local via
   the tier_probe handshake) — byte-identical outputs, negotiated tiers
   visible in ``stats``, measured speedup ≥ ``--min-speedup`` (1.5).

Exit 0 on success; one JSON row on stdout (the ``colocated_fastpath``
row of ``benchmarks/run.py``).

The PyTorch port's copy of ``scripts/colocate_smoke.py``: the same checks,
flags, bounds and row, run on ``--device`` (the card by default; the node
processes it spawns run there too).

Usage:  python scripts/torch_colocate_smoke.py [--quick] [--delay-ms D]
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
    """Per-stage outbound codecs charging ``delay_ms`` of non-CPU codec
    time to each inter-stage hop (decode-side on hop 0->1, encode-side
    on hop 1->2); the result hop stays raw."""
    return [f"dsleep{delay_ms:g}+raw", f"esleep{delay_ms:g}+raw", "raw"]


# ---------------------------------------------------------------------------
# in-process chains
# ---------------------------------------------------------------------------

def run_inproc(stages, params, xs, *, tier: str, codecs, streams: int = 3):
    """Thread-per-node chain under ``tier``; streams ``xs`` ``streams``
    times (after a warm stream) and keeps the MIN wall — single-stream
    walls jitter >15% on this 1-core box.  Returns (outs, wall, stats).
    """
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode

    nodes = [StageNode(None, "127.0.0.1:0", None, **node_opts(), tier=tier)
             for _ in range(len(stages))]
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    threads = [threading.Thread(target=n.serve, daemon=True)
               for n in nodes]
    for t in threads:
        t.start()
    disp = ChainDispatcher(addrs[0], codec="raw", tier=tier)
    try:
        disp.deploy(stages, params, addrs, batch=xs[0].shape[0],
                    codecs=codecs, tiers=[tier] * len(stages))
        disp.stream(xs[:2])  # warm: compile + connect + negotiate
        wall = float("inf")
        for _ in range(streams):
            t0 = time.perf_counter()
            outs = disp.stream(xs)
            wall = min(wall, time.perf_counter() - t0)
        stats = disp.stats(addrs)
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=60)
    return outs, wall, stats


def quick_check(stages, params, xs, *, delay_ms: float,
                min_speedup: float) -> dict:
    import numpy as np

    from defer_tpu_torch.obs import REGISTRY

    codecs = hop_codecs(delay_ms)
    base, base_s, base_st = run_inproc(stages, params, xs, tier="tcp",
                                       codecs=codecs)
    enc0 = REGISTRY.histogram("codec.encode_s").summary().get("count", 0)
    loc, loc_s, loc_st = run_inproc(stages, params, xs, tier="local",
                                    codecs=codecs)
    enc1 = REGISTRY.histogram("codec.encode_s").summary().get("count", 0)

    assert len(base) == len(loc) == len(xs)
    for a, b in zip(base, loc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tiers = [s["tier"] for s in loc_st]
    assert tiers == ["local"] * 3, f"hops did not negotiate local: {tiers}"
    assert enc1 == enc0, (
        f"local hops recorded {enc1 - enc0} codec.encode_s samples; "
        f"the colocated path must do ZERO codec work")
    speedup = base_s / loc_s
    log(f"quick: tcp {len(xs) / base_s:6.1f} inf/s, local "
        f"{len(xs) / loc_s:6.1f} inf/s -> {speedup:.2f}x")
    assert speedup >= min_speedup, (
        f"colocated speedup {speedup:.3f}x under the {min_speedup}x bar "
        f"(tcp {base_s:.3f}s vs local {loc_s:.3f}s)")
    return {"tcp_s": round(base_s, 4), "local_s": round(loc_s, 4),
            "speedup": round(speedup, 4), "tiers": tiers}


def fused_check(stages, params, xs, *, delay_ms: float, base) -> dict:
    """Device-tier fusion: the inter-stage frames must be GONE —
    asserted by span and counter ABSENCE, not timing."""
    import numpy as np

    from defer_tpu_torch.obs import REGISTRY, enable_tracing, tracer
    from defer_tpu_torch.partition import fuse_stages

    fused, groups = fuse_stages(stages, ["device", "device"])
    assert len(fused) == 1, groups
    tr = enable_tracing(process="dispatcher")
    tr.start_trace()
    tx0 = REGISTRY.counter("transport.tx_frames").value
    lf0 = REGISTRY.counter("transport.local_frames").value
    outs, wall, stats = run_inproc(fused, params, xs, tier="local",
                                   codecs=["raw"], streams=1)
    tx_frames = REGISTRY.counter("transport.tx_frames").value - tx0
    local_frames = REGISTRY.counter("transport.local_frames").value - lf0
    spans = {s.get("name", "") for s in tracer().drain()}
    tr.enabled = False

    for a, b in zip(base, outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # frame elimination: the fused+local chain moved ZERO tensor frames
    # over any wire (the one deploy blob is the only wire frame), and
    # only 2 local hops remain (disp -> fused stage -> result)
    assert tx_frames <= 2, f"{tx_frames} wire frames on a fused chain"
    assert local_frames == 2 * (len(xs) + 2), (
        f"expected 2 hops x {len(xs) + 2} frames through local pipes, "
        f"got {local_frames}")
    gone = [n for n in spans
            if n.startswith(("stage1.", "stage2."))
            or n.endswith((".rx", ".tx", ".rx_wait", ".tx_wait"))]
    assert not gone, f"fused chain still recorded hop spans: {gone}"
    assert any(n.startswith("stage0.infer") for n in spans), spans
    log(f"fused: 1 stage, wire tensor frames 0 (+{tx_frames} ctrl/blob), "
        f"{local_frames} local handoffs, no stage1/stage2 or rx/tx spans")
    return {"stages": len(fused), "wire_frames": tx_frames,
            "local_frames": local_frames}


# ---------------------------------------------------------------------------
# planner: the hop-tier map changes the plan
# ---------------------------------------------------------------------------

def planner_check() -> dict:
    from defer_tpu_torch.graph import GraphBuilder
    from defer_tpu_torch.graph import ops
    from defer_tpu_torch.plan import StageCostModel, solve

    b = GraphBuilder("fatcut")
    x = b.input((4096,))
    for i in range(3):
        x = b.add(ops.Dense(4096), x, name=f"d{i}")
    x = b.add(ops.Dense(8), x, name="head")
    g = b.build()
    costs = {"d0": 1e-3, "d1": 1e-3, "d2": 1e-3, "head": 1e-4}
    cm = StageCostModel(g, gen="v4", link_bw_s=1e6, node_costs=costs)
    p_tcp = solve(g, 3, cm)
    p_colo = solve(g, 3, cm,
                   hop_tiers={c: "local" for c in ("d0", "d1", "d2")})
    assert p_colo.bottleneck_s <= p_tcp.bottleneck_s, (
        p_colo.bottleneck_s, p_tcp.bottleneck_s)
    assert p_colo.bottleneck_s < p_tcp.bottleneck_s, (
        "comm-bound model: the colocated plan must be strictly better")
    log(f"planner: tcp bottleneck {p_tcp.bottleneck_s * 1e3:.3f} ms "
        f"({p_tcp.bound_by}-bound) vs colocated "
        f"{p_colo.bottleneck_s * 1e3:.3f} ms ({p_colo.bound_by}-bound), "
        f"hop tiers {p_colo.hop_tiers}")
    return {"tcp_bottleneck_ms": round(p_tcp.bottleneck_s * 1e3, 4),
            "colocated_bottleneck_ms": round(p_colo.bottleneck_s * 1e3, 4),
            "predicted_speedup": round(
                p_tcp.bottleneck_s / p_colo.bottleneck_s, 4),
            "hop_tiers": p_colo.hop_tiers}


# ---------------------------------------------------------------------------
# multi-process: one colocated process vs three TCP processes
# ---------------------------------------------------------------------------

def _free_ports(n):
    socks = [socket.create_server(("127.0.0.1", 0)) for _ in range(n)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def timed_chain(paths, xs_warm, xs, *, colocate: bool, delay_ms: float,
                log_dir: str):
    """Spawn the 3-stage chain — 3 OS processes (TCP hops) or ONE
    process hosting all 3 stages (``--co-stage``, local hops) — warm it,
    stream ``xs`` timed, tear down.  Returns (outputs, seconds, stats)."""
    from defer_tpu_torch.runtime.node import (ChainDispatcher, _await_binds,
                                        _kill_procs)

    codecs = hop_codecs(delay_ms)
    ports = _free_ports(4)
    addrs = [f"127.0.0.1:{p}" for p in ports[:3]]
    result = f"127.0.0.1:{ports[3]}"
    nxt = addrs[1:] + [result]
    # dispatcher edges are always cross-process: keep them on "auto"
    # (they negotiate shm as before) — only the IN-process co-stage
    # hops pin "local", since auto's top rung is now the ici tier
    tier = "auto" if colocate else "tcp"
    if colocate:
        argv = [sys.executable, "-m", "defer_tpu_torch", "node", *node_flags(),
                "--artifact", paths[0], "--listen", addrs[0],
                "--next", nxt[0], "--codec", codecs[0], "--tier", "local"]
        for k in (1, 2):
            # the LAST housemate's outbound is the result edge (cross-
            # process): a "local" pin there could only degrade to tcp
            co_tier = "local" if k < 2 else "auto"
            argv += ["--co-stage",
                     f"listen={addrs[k]};artifact={paths[k]}"
                     f";next={nxt[k]};codec={codecs[k]};tier={co_tier}"
                     f";accept=1"]
        argvs = [argv]
        proc_of = [0, 0, 0]
    else:
        argvs = [[sys.executable, "-m", "defer_tpu_torch", "node", *node_flags(),
                  "--artifact", paths[k], "--listen", addrs[k],
                  "--next", nxt[k], "--codec", codecs[k], "--tier", "tcp"]
                 for k in range(3)]
        proc_of = [0, 1, 2]

    child_env = node_env()
    mode = "coloc" if colocate else "tcp"
    procs, logs = [], []
    failed = True
    try:
        for i, a in enumerate(argvs):
            lf = open(os.path.join(log_dir, f"{mode}_proc_{i}.log"), "w+")
            logs.append(lf)
            procs.append(subprocess.Popen(a, env=child_env, stdout=lf,
                                          stderr=subprocess.STDOUT))
        _await_binds(procs, [f"stage{k}" for k in range(3)], logs, addrs,
                     proc_of=proc_of)
        disp = ChainDispatcher(addrs[0], listen=result, codec="raw",
                               tier=tier)
        try:
            disp.stream(xs_warm)  # boot+compile+negotiation excluded
            t0 = time.perf_counter()
            outs = disp.stream(xs)
            dt = time.perf_counter() - t0
            stats = disp.stats(addrs)
            failed = False
        finally:
            if failed:
                _kill_procs(procs)
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

    from defer_tpu_torch.runtime.node import _BindRace
    from defer_tpu_torch.utils.export import export_pipeline

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
    with tempfile.TemporaryDirectory(prefix="defer_colo_") as tmp:
        paths = export_pipeline(stages, params, tmp, batch=batch)
        base, base_s, _ = with_retry(paths=paths, xs_warm=xs_warm, xs=xs,
                                     colocate=False, delay_ms=delay_ms,
                                     log_dir=tmp)
        log(f"3-process tcp:      {count * batch / base_s:8.1f} inf/s "
            f"({base_s:.2f}s)")
        colo, colo_s, stats = with_retry(paths=paths, xs_warm=xs_warm,
                                         xs=xs, colocate=True,
                                         delay_ms=delay_ms, log_dir=tmp)
        log(f"1-process colocated:{count * batch / colo_s:8.1f} inf/s "
            f"({colo_s:.2f}s)")
    assert len(base) == len(colo) == count
    for a, b in zip(base, colo):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tiers = {s["stage"]: s["tier"] for s in stats}
    # both inter-stage hops negotiated local inside the one process (the
    # result hop crosses back to the dispatcher process -> tcp)
    assert tiers[0] == "local" and tiers[1] == "local", tiers
    speedup = base_s / colo_s
    log(f"negotiated tiers {tiers} -> {speedup:.3f}x")
    assert speedup >= min_speedup, (
        f"colocated speedup {speedup:.3f}x is under the {min_speedup}x "
        f"bar (tcp {count * batch / base_s:.1f} inf/s, colocated "
        f"{count * batch / colo_s:.1f} inf/s)")
    return {"tcp_s": base_s, "colocated_s": colo_s,
            "speedup": round(speedup, 4),
            "tcp_inf_s": round(count * batch / base_s, 2),
            "colocated_inf_s": round(count * batch / colo_s, 2),
            "tiers": {str(k): v for k, v in sorted(tiers.items())}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-speedup", type=float, default=1.5,
                    help="required colocated/tcp throughput ratio "
                         "(multi-process chain)")
    ap.add_argument("--quick-min-speedup", type=float, default=1.5,
                    help="required ratio for the in-process quick check "
                         "(delay-dominated, so the bar holds even with "
                         "1-core scheduling noise)")
    ap.add_argument("--count", type=int, default=24,
                    help="timed microbatches through each chain")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--delay-ms", type=float, default=25.0,
                    help="per-hop codec delay the fast path eliminates")
    ap.add_argument("--quick", action="store_true",
                    help="in-process + planner checks only (no spawns)")
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

    graph = resnet_tiny()
    params = graph.init(torch.Generator().manual_seed(0))
    stages = partition(graph, num_stages=3)

    rng = np.random.default_rng(0)
    q_count, q_batch = min(args.count, 12), min(args.batch, 2)
    xs = [rng.standard_normal((q_batch, 32, 32, 3)).astype(np.float32)
          for _ in range(q_count)]
    r_quick = quick_check(stages, params, xs,
                          delay_ms=min(args.delay_ms, 15.0),
                          min_speedup=args.quick_min_speedup)
    base, _, _ = run_inproc(stages, params, xs, tier="tcp",
                            codecs=["raw"] * 3, streams=1)
    r_fused = fused_check(stages, params, xs, delay_ms=args.delay_ms,
                          base=base)
    r_plan = planner_check()

    row = {"metric": "colocated_fastpath", "unit": "x_vs_tcp_chain",
           "stages": len(stages), "hop_tiers": ["local", "local"],
           "count": args.count, "batch": args.batch,
           "delay_ms": args.delay_ms,
           "cpu_count": os.cpu_count() or 1,
           "quick": r_quick, "fused": r_fused, "planner": r_plan}
    if args.quick:
        row["value"] = None
    else:
        r = speedup_check(stages, params, count=args.count,
                          batch=args.batch, delay_ms=args.delay_ms,
                          min_speedup=args.min_speedup)
        row.update({"value": r["speedup"], **{
            k: v for k, v in r.items() if k != "speedup"}})
    print(json.dumps(row))
    log("colocated fast-path smoke: OK")


if __name__ == "__main__":
    main()
