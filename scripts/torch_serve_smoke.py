"""Serving front door smoke: prove the admission layer's three claims.

The chain is made DELAY-bound the way every smoke on this 1-core box
does it (``dsleep<ms>+raw``: a decode-side sleep charges each frame a
fixed non-CPU cost — the resource profile of real serialization /
accelerator time), so per-frame amortization is measurable by physics
rather than by CPU luck.

Checks:

1. MULTI-TENANT BYTE-IDENTITY: >= 3 concurrent client streams over ONE
   deployed chain produce per-request outputs byte-identical to each
   request run alone through the same serving path.

2. CONTINUOUS BATCHING >= ``--min-speedup`` (1.5): the same offered
   load served (a) sequentially, one stream at a time, one sample per
   frame — today's single-client dispatcher model — vs (b) through the
   front door: concurrent tenants, samples coalesced across tenants
   into width-W frames.  min-of-3 walls each (1-core jitter rule).

3. SLO SHEDDING UNDER A 2x BURST: a deterministic open-loop Poisson
   trace with a 2x-rate burst phase is played against the door twice —
   a deadline-bound tenant (admission sheds when the predicted
   completion blows the SLO) and a no-deadline tenant (nothing sheds).
   The shedding run's admitted-request p99 stays within the SLO; the
   no-shedding run blows it.

Plus a decode row: the continuous-batching decode engine (gpt_tiny,
requests joining/leaving between steps) byte-identical to solo runs,
with sustained tokens/s reported for the batched vs sequential drive.

``--quick`` keeps everything in-process (thread-per-stage chain nodes);
the full mode runs the SAME chain as real OS ``defer_tpu_torch node``
processes.  Exit 0 on success; one JSON row on stdout (the
``serving_frontdoor`` row of ``benchmarks/run.py``).

The PyTorch port's copy of ``scripts/serve_smoke.py``: the same checks,
flags, bounds and row, run on ``--device`` (the card by default; the node
processes it spawns run there too).

Usage:  python scripts/torch_serve_smoke.py [--quick] [--delay-ms D]
            [--per-tenant N] [--min-speedup 1.5] [--seed S] [--device cuda|cpu]
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
from defer_tpu_torch.models.gpt import gpt_tiny  # noqa: E402
from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode  # noqa: E402
from defer_tpu_torch.serve import (ContinuousBatchEngine,  # noqa: E402
                             DecodeRequest, LoadGenerator, ServeClient,
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


def hop_codecs(delay_ms: float) -> list[str]:
    """Decode-side delay on the stage0->stage1 hop: every frame charges
    the chain ``delay_ms`` of non-CPU time inside stage 1."""
    return [f"dsleep{delay_ms:g}+raw", "raw", "raw"]


class Deployment:
    """One booted 3-stage chain + front door (threads or processes)."""

    def __init__(self, door, disp, *, threads=None, procs=None,
                 logs=None):
        self.door = door
        self.disp = disp
        self._threads = threads or []
        self._procs = procs or []
        self._logs = logs or []

    @property
    def addr(self):
        return self.door.address

    def close(self):
        from defer_tpu_torch.runtime.node import _kill_procs
        self.door.stop()
        if self._procs:
            _kill_procs(self._procs)
        for t in self._threads:
            t.join(timeout=30)
        for lf in self._logs:
            lf.close()


def boot_door(stages, params, width, codecs, *, quick: bool,
              log_dir: str, tag: str, window: int = 8) -> Deployment:
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
            # --tier tcp: this row measures the serving front door over
            # a delay-bound wire chain; an auto-negotiated shm hop
            # would bypass the dsleep codec that makes it delay-bound
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
    door = ServeFrontDoor(
        backend=ChainBackend(disp, width, IN_SHAPE, window=window)).start()
    return Deployment(door, disp, **dep)


def run_streams(addr, data, *, concurrent: bool, suffix: str,
                deadline_ms=None):
    """Each tenant's samples through one client; returns (outs, wall)."""
    host, port = addr
    outs = {}

    def one(t):
        c = ServeClient(host, port, t + suffix, deadline_ms=deadline_ms)
        outs[t] = c.stream(data[t])

    t0 = time.perf_counter()
    if concurrent:
        ths = [threading.Thread(target=one, args=(t,)) for t in data]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=300)
    else:
        for t in data:
            one(t)
    return outs, time.perf_counter() - t0


def assert_identical(a, b, what):
    for t in a:
        for i, (oa, ob) in enumerate(zip(a[t], b[t])):
            assert oa[0] == "ok" and ob[0] == "ok", (what, t, i, oa, ob)
            assert np.array_equal(oa[1], ob[1]), \
                f"{what}: tenant {t} sample {i} NOT byte-identical"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="in-process thread chain (CI mode)")
    ap.add_argument("--delay-ms", type=float, default=25.0)
    ap.add_argument("--per-tenant", type=int, default=8)
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--min-speedup", type=float, default=1.5)
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
    codecs = hop_codecs(args.delay_ms)
    rng = np.random.default_rng(args.seed)
    tenants = ("alpha", "beta", "gamma")
    data = {t: [rng.standard_normal(IN_SHAPE).astype(np.float32)
                for _ in range(args.per_tenant)] for t in tenants}
    row = {"metric": "serving_frontdoor", "unit": "x", "tenants": 3,
           "width": args.width, "delay_ms": args.delay_ms,
           "per_tenant": args.per_tenant,
           "mode": "quick" if args.quick else "full"}

    with tempfile.TemporaryDirectory(prefix="serve_smoke_") as tmp:
        # ---- the batched (front door) deployment: width W -------------
        wide = boot_door(stages, params, args.width, codecs,
                         quick=args.quick, log_dir=tmp, tag="wide")
        # ---- the sequential baseline: width 1, streams one at a time --
        narrow = boot_door(stages, params, 1, codecs,
                           quick=args.quick, log_dir=tmp, tag="narrow")
        try:
            # 1. BYTE-IDENTITY on the batched door: solo (one stream at
            # a time) vs 3 concurrent tenants, same chain
            solo, _ = run_streams(wide.addr, data, concurrent=False,
                                  suffix="_solo")
            log("serve_smoke: solo reference streams done")
            seq_walls, bat_walls = [], []
            for rep in range(3):  # min-of-3: 1-core wall jitter rule
                conc, bw = run_streams(wide.addr, data, concurrent=True,
                                       suffix=f"_c{rep}")
                assert_identical(solo, conc, f"concurrent rep {rep}")
                bat_walls.append(bw)
                _, sw = run_streams(narrow.addr, data, concurrent=False,
                                    suffix=f"_s{rep}")
                seq_walls.append(sw)
            wide.door.healthcheck()
            narrow.door.healthcheck()
            seq_wall, bat_wall = min(seq_walls), min(bat_walls)
            speedup = seq_wall / bat_wall
            log(f"serve_smoke: sequential {seq_wall:.3f}s vs batched "
                f"{bat_wall:.3f}s -> {speedup:.2f}x")
            assert speedup >= args.min_speedup, (
                f"continuous batching {speedup:.2f}x < "
                f"{args.min_speedup}x (seq {seq_wall:.3f}s, batched "
                f"{bat_wall:.3f}s)")
            row.update(value=round(speedup, 3),
                       byte_identical=True,
                       sequential_wall_s=round(seq_wall, 4),
                       batched_wall_s=round(bat_wall, 4),
                       samples_per_s=round(
                           3 * args.per_tenant / bat_wall, 2))

            # 2. SLO SHEDDING under a 2x-overload burst ----------------
            # capacity of the wide door ~ W / frame_delay; drive the
            # steady phases just under it and the burst at 2x
            cap_hz = args.width / (args.delay_ms / 1e3)
            base_hz = 0.6 * cap_hz
            dur = 6.0
            bursts = [(1.5, 3.5, 2.0)]
            offsets = poisson_trace(base_hz, dur, seed=args.seed + 1,
                                    bursts=bursts)
            slo_ms = 10 * args.delay_ms
            samples = data["alpha"]
            host, port = wide.addr

            def play(tenant, deadline_ms):
                c = ServeClient(host, port, tenant,
                                deadline_ms=deadline_ms,
                                timeout_s=300.0)
                return LoadGenerator(c, samples, offsets).run()

            noshed = play("burst_noshed", None)
            log(f"serve_smoke: no-shed p99 "
                f"{noshed['latency_p99_ms']:.1f}ms (SLO {slo_ms:g}ms)")
            shed = play("burst_shed", 0.8 * slo_ms)
            log(f"serve_smoke: shed p99 {shed['latency_p99_ms']:.1f}ms, "
                f"shed rate {shed['shed_rate']:.2%}")
            assert noshed["latency_p99_ms"] > slo_ms, (
                "the no-shedding baseline should have blown the "
                f"{slo_ms:g}ms SLO under the 2x burst "
                f"(p99 {noshed['latency_p99_ms']:.1f}ms) — raise the "
                "burst or lower the SLO")
            assert shed["latency_p99_ms"] <= slo_ms, (
                f"shedding failed its SLO: admitted p99 "
                f"{shed['latency_p99_ms']:.1f}ms > {slo_ms:g}ms")
            assert shed["shed"] > 0, "the burst should shed something"
            row.update(slo_ms=slo_ms,
                       trace={"base_rate_hz": round(base_hz, 1),
                              "burst": bursts, "duration_s": dur,
                              "offered": len(offsets)},
                       shed_p99_ms=shed["latency_p99_ms"],
                       shed_rate=shed["shed_rate"],
                       noshed_p99_ms=noshed["latency_p99_ms"])
        finally:
            wide.close()
            narrow.close()

    # 3. CONTINUOUS-BATCHING DECODE (in-process engine) ----------------
    gg = gpt_tiny()
    gp = gg.init(torch.Generator().manual_seed(1))
    prompts = [rng.integers(0, 97, (4,)).astype(np.int32)
               for _ in range(4)]
    new_tok = 8

    def reqs():
        return [DecodeRequest(prompt=p, max_new_tokens=new_tok,
                              request_id=i, seed=i)
                for i, p in enumerate(prompts)]

    solo_out, seq_wall = {}, 0.0
    eng = ContinuousBatchEngine(gg, gp, num_stages=2, width=4,
                                 device=DEVICE)
    eng.run_all(reqs()[:1])  # compile outside the timed windows
    for req in reqs():
        eng1 = ContinuousBatchEngine(gg, gp, num_stages=2, width=4,
                                 device=DEVICE)
        t0 = time.perf_counter()
        solo_out[req.request_id] = eng1.run_all([req])[req.request_id]
        seq_wall += time.perf_counter() - t0
    eng2 = ContinuousBatchEngine(gg, gp, num_stages=2, width=4,
                                 device=DEVICE)
    t0 = time.perf_counter()
    batched = eng2.run_all(reqs())
    bat_wall = time.perf_counter() - t0
    for rid, ids in solo_out.items():
        assert np.array_equal(batched[rid], ids), \
            f"decode request {rid} not byte-identical to its solo run"
    row.update(decode_tokens_per_s=round(
        len(prompts) * new_tok / bat_wall, 1),
        decode_speedup=round(seq_wall / bat_wall, 2))
    log(f"serve_smoke: decode batched {row['decode_tokens_per_s']} "
        f"tok/s ({row['decode_speedup']}x vs sequential), "
        f"byte-identical")

    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
