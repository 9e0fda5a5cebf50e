"""Shared-memory transport-tier smoke: prove the same-host fast path pays.

A 3-stage resnet_tiny chain is made codec-delay-bound the same way
``torch_colocate_smoke.py`` does: stage 0's outbound hop uses a decode-side
delay codec (``dsleep<ms>+raw``) and stage 1's an encode-side one
(``esleep<ms>+raw``), so every frame charges the chain a fixed non-CPU
delay per inter-stage hop.  The shm tier eliminates exactly that cost:
activations cross a ``multiprocessing.shared_memory`` ring (one memcpy
per side, no codec, no socket payload bytes) while the TCP socket is
demoted to a per-frame doorbell — and unlike the ``local`` tier this
works BETWEEN separate OS processes, the repo's standard proof mode.

Checks:

1. QUICK (in-process thread chain, ``tier="shm"`` pins the shm offer so
   the local rung doesn't win): the same inputs through the all-TCP
   chain and the all-shm chain — byte-identical outputs, every stats
   row reports the negotiated ``shm`` tier on BOTH ends, zero
   ``codec.*`` histogram samples on the shm run, zero per-hop fallback
   counts, and min-of-3 wall >= ``--quick-min-speedup``.

2. FALLBACK: a hop whose peer refuses the offer degrades to tcp with
   the stream byte-identical and the refused hop's ``tier_fallbacks``
   stat incremented — attributable, unlike a never-offered hop.

3. PLANNER: given a shm hop-tier map, the solver's plan crosses a fat
   boundary the all-TCP plan avoids (strictly better predicted
   bottleneck on the comm-bound model), and the tier survives the
   plan-JSON roundtrip.

4. FULL (multi-process, skipped with ``--quick``): the same chain as 3
   REAL OS processes — all hops (dispatcher edges included) negotiated
   ``shm`` via the tier_probe handshake vs the all-TCP chain —
   byte-identical outputs, min-of-3 streams, measured speedup >=
   ``--min-speedup`` (1.5), zero codec samples on every stage's stats
   row, and no ``defer_shm_*`` segment left in /dev/shm afterwards.

Exit 0 on success; one JSON row on stdout (the ``shm_fastpath`` row of
``benchmarks/run.py``).

The PyTorch port's copy of ``scripts/shm_smoke.py``: the same checks,
flags, bounds and row, run on ``--device`` (the card by default; the node
processes it spawns run there too).

Usage:  python scripts/torch_shm_smoke.py [--quick] [--delay-ms D]
            [--count N] [--min-speedup 1.5] [--device cuda|cpu]
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


def segments() -> set:
    try:
        return {n for n in os.listdir("/dev/shm")
                if n.startswith("defer_shm_")}
    except OSError:
        return set()


# ---------------------------------------------------------------------------
# in-process chains (quick mode)
# ---------------------------------------------------------------------------

def run_inproc(stages, params, xs, *, tier: str, codecs, accepts=None,
               streams: int = 3):
    """Thread-per-node chain under ``tier``; warm stream then ``streams``
    timed streams keeping the MIN wall (single-stream walls jitter >15%
    on this 1-core box).  Returns (outs, wall, stats)."""
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode

    nodes = [StageNode(None, "127.0.0.1:0", None, **node_opts(), tier=tier,
                       tier_accept=True if accepts is None else accepts[i])
             for i in range(len(stages))]
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
    before = segments()
    shm, shm_s, shm_st = run_inproc(stages, params, xs, tier="shm",
                                    codecs=codecs)
    enc1 = REGISTRY.histogram("codec.encode_s").summary().get("count", 0)

    assert len(base) == len(shm) == len(xs)
    for a, b in zip(base, shm):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tiers = [s["tier"] for s in shm_st]
    tiers_in = [s["tier_in"] for s in shm_st]
    assert tiers == ["shm"] * 3, f"hops did not negotiate shm: {tiers}"
    assert tiers_in == ["shm"] * 3, tiers_in
    assert [s["tier_fallbacks"] for s in shm_st] == [0] * 3
    assert enc1 == enc0, (
        f"shm hops recorded {enc1 - enc0} codec.encode_s samples; "
        f"the shared-memory path must do ZERO codec work")
    assert segments() <= before, "quick chain leaked /dev/shm segments"
    speedup = base_s / shm_s
    log(f"quick: tcp {len(xs) / base_s:6.1f} inf/s, shm "
        f"{len(xs) / shm_s:6.1f} inf/s -> {speedup:.2f}x")
    assert speedup >= min_speedup, (
        f"shm speedup {speedup:.3f}x under the {min_speedup}x bar "
        f"(tcp {base_s:.3f}s vs shm {shm_s:.3f}s)")
    return {"tcp_s": round(base_s, 4), "shm_s": round(shm_s, 4),
            "speedup": round(speedup, 4), "tiers": tiers}


def fallback_check(stages, params, xs, *, base) -> dict:
    """A refused offer degrades the hop to tcp — byte-identical stream,
    and the DEGRADED hop (not its neighbors) carries the fallback."""
    import numpy as np

    outs, _, stats = run_inproc(stages, params, xs, tier="shm",
                                codecs=["raw"] * 3,
                                accepts=[True, False, True], streams=1)
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    by_stage = {s["stage"]: s for s in stats}
    assert by_stage[0]["tier"] == "tcp" \
        and by_stage[0]["tier_fallbacks"] >= 1, by_stage[0]
    assert by_stage[1]["tier"] == "shm" \
        and by_stage[1]["tier_fallbacks"] == 0, by_stage[1]
    log(f"fallback: refused hop degraded to tcp with tier_fallbacks="
        f"{by_stage[0]['tier_fallbacks']}, granted hop untouched")
    return {"degraded_hop_fallbacks": by_stage[0]["tier_fallbacks"],
            "granted_hop_fallbacks": by_stage[1]["tier_fallbacks"]}


# ---------------------------------------------------------------------------
# planner: the shm hop-tier map changes the plan
# ---------------------------------------------------------------------------

def planner_check() -> dict:
    from defer_tpu_torch.graph import GraphBuilder
    from defer_tpu_torch.graph import ops
    from defer_tpu_torch.plan import StageCostModel, plan_from_json, solve

    b = GraphBuilder("fatcut")
    x = b.input((4096,))
    for i in range(3):
        x = b.add(ops.Dense(4096), x, name=f"d{i}")
    x = b.add(ops.Dense(8), x, name="head")
    g = b.build()
    costs = {"d0": 1e-3, "d1": 1e-3, "d2": 1e-3, "head": 1e-4}
    cm = StageCostModel(g, gen="v4", link_bw_s=1e6, node_costs=costs)
    p_tcp = solve(g, 3, cm)
    p_shm = solve(g, 3, cm,
                  hop_tiers={c: "shm" for c in ("d0", "d1", "d2")})
    assert p_shm.bottleneck_s < p_tcp.bottleneck_s, (
        "comm-bound model: the shm plan must be strictly better")
    assert plan_from_json(p_shm.to_json()).hop_tiers == p_shm.hop_tiers
    log(f"planner: tcp bottleneck {p_tcp.bottleneck_s * 1e3:.3f} ms "
        f"vs shm {p_shm.bottleneck_s * 1e3:.3f} ms, hop tiers "
        f"{p_shm.hop_tiers}")
    return {"tcp_bottleneck_ms": round(p_tcp.bottleneck_s * 1e3, 4),
            "shm_bottleneck_ms": round(p_shm.bottleneck_s * 1e3, 4),
            "predicted_speedup": round(
                p_tcp.bottleneck_s / p_shm.bottleneck_s, 4),
            "hop_tiers": p_shm.hop_tiers}


# ---------------------------------------------------------------------------
# multi-process: 3 real OS processes, shm hops vs tcp hops
# ---------------------------------------------------------------------------

def timed_chain(paths, xs_warm, xs, *, tier: str, delay_ms: float,
                log_dir: str, streams: int = 3):
    """Spawn the 3-stage chain as 3 SEPARATE OS processes under
    ``tier``, warm it, stream ``xs`` ``streams`` times keeping the min
    wall, tear down.  Returns (outputs, seconds, stats)."""
    import socket as _socket

    from defer_tpu_torch.runtime.node import (ChainDispatcher, _await_binds,
                                        _kill_procs)

    codecs = hop_codecs(delay_ms)
    socks = [_socket.create_server(("127.0.0.1", 0)) for _ in range(4)]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    addrs = [f"127.0.0.1:{p}" for p in ports[:3]]
    result = f"127.0.0.1:{ports[3]}"
    nxt = addrs[1:] + [result]
    argvs = [[sys.executable, "-m", "defer_tpu_torch", "node", *node_flags(),
              "--artifact", paths[k], "--listen", addrs[k],
              "--next", nxt[k], "--codec", codecs[k], "--tier", tier]
             for k in range(3)]

    child_env = node_env()
    procs, logs = [], []
    failed = True
    try:
        for i, a in enumerate(argvs):
            lf = open(os.path.join(log_dir, f"{tier}_proc_{i}.log"), "w+")
            logs.append(lf)
            procs.append(subprocess.Popen(a, env=child_env, stdout=lf,
                                          stderr=subprocess.STDOUT))
        _await_binds(procs, [f"stage{k}" for k in range(3)], logs, addrs,
                     proc_of=[0, 1, 2])
        disp = ChainDispatcher(addrs[0], listen=result, codec="raw",
                               tier=tier)
        try:
            disp.stream(xs_warm)  # boot+compile+negotiation excluded
            dt = float("inf")
            for _ in range(streams):
                t0 = time.perf_counter()
                outs = disp.stream(xs)
                dt = min(dt, time.perf_counter() - t0)
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
    before = segments()
    with tempfile.TemporaryDirectory(prefix="defer_shm_smoke_") as tmp:
        paths = export_pipeline(stages, params, tmp, batch=batch)
        base, base_s, _ = with_retry(paths=paths, xs_warm=xs_warm, xs=xs,
                                     tier="tcp", delay_ms=delay_ms,
                                     log_dir=tmp)
        log(f"3-process tcp: {count * batch / base_s:8.1f} inf/s "
            f"({base_s:.2f}s)")
        shm, shm_s, stats = with_retry(paths=paths, xs_warm=xs_warm,
                                       xs=xs, tier="shm",
                                       delay_ms=delay_ms, log_dir=tmp)
        log(f"3-process shm: {count * batch / shm_s:8.1f} inf/s "
            f"({shm_s:.2f}s)")
    assert len(base) == len(shm) == count
    for a, b in zip(base, shm):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tiers = {s["stage"]: s["tier"] for s in stats}
    # EVERY hop negotiated shm: both inter-stage hops, the inbound side
    # of each stage, and the last stage's result dial-back
    assert all(t == "shm" for t in tiers.values()), tiers
    assert all(s["tier_in"] == "shm" for s in stats), stats
    # zero codec work on shm hops, asserted per stage OFF the live
    # channels (each row's encode/decode summaries are per-channel)
    for s in stats:
        assert not s["encode_latency_s"].get("count"), s["stage"]
        assert not s["decode_latency_s"].get("count"), s["stage"]
    assert segments() <= before, "full chain leaked /dev/shm segments"
    speedup = base_s / shm_s
    log(f"negotiated tiers {tiers} -> {speedup:.3f}x")
    assert speedup >= min_speedup, (
        f"shm speedup {speedup:.3f}x is under the {min_speedup}x bar "
        f"(tcp {count * batch / base_s:.1f} inf/s, shm "
        f"{count * batch / shm_s:.1f} inf/s)")
    return {"tcp_s": base_s, "shm_s": shm_s,
            "speedup": round(speedup, 4),
            "tcp_inf_s": round(count * batch / base_s, 2),
            "shm_inf_s": round(count * batch / shm_s, 2),
            "tiers": {str(k): v for k, v in sorted(tiers.items())}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-speedup", type=float, default=1.5,
                    help="required shm/tcp throughput ratio "
                         "(multi-process chain, min-of-3 streams)")
    ap.add_argument("--quick-min-speedup", type=float, default=1.5,
                    help="required ratio for the in-process quick check "
                         "(delay-dominated, so the bar holds even with "
                         "1-core scheduling noise)")
    ap.add_argument("--count", type=int, default=24,
                    help="timed microbatches through each chain")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--delay-ms", type=float, default=25.0,
                    help="per-hop codec delay the shm path eliminates")
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
    r_fall = fallback_check(stages, params, xs, base=base)
    r_plan = planner_check()

    row = {"metric": "shm_fastpath", "unit": "x_vs_tcp_chain",
           "stages": len(stages), "hop_tiers": ["shm", "shm"],
           "count": args.count, "batch": args.batch,
           "delay_ms": args.delay_ms,
           "cpu_count": os.cpu_count() or 1,
           "quick": r_quick, "fallback": r_fall, "planner": r_plan}
    if args.quick:
        row["value"] = None
    else:
        r = speedup_check(stages, params, count=args.count,
                          batch=args.batch, delay_ms=args.delay_ms,
                          min_speedup=args.min_speedup)
        row.update({"value": r["speedup"], **{
            k: v for k, v in r.items() if k != "speedup"}})
    print(json.dumps(row))
    log("shm fast-path smoke: OK")


if __name__ == "__main__":
    main()
