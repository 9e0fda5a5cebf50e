"""Port parity: the live observability plane (``obs/cluster.py``,
``obs/report.py``, the node's clock and push commands, the monitor's
table) against the JAX package's, mirroring ``tests/test_obs_live.py``,
``tests/test_obs_events.py``'s merge, and the monitor cases of
``tests/test_dag_chain.py``, ``tests/test_shm.py`` and
``tests/test_ici.py``.

Synthetic scenarios run once per package on the same pushes, drawn from a
numpy seed, under the same injected monotonic clock: rows, rates, flags,
verdicts and the rendered monitor text must be EQUAL.  Live scenarios
boot in-process node chains on the CPU: a JAX ``ClusterView`` watches port
nodes and a port ``ClusterView`` watches JAX nodes, and each agrees with
the other package's view of the same nodes field for field (the fields
that do not depend on when a push arrived).  Every socket binds
``127.0.0.1:0`` and every wait has a deadline.
"""

import contextlib
import io
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax

import defer_tpu.cli as jcli
import defer_tpu.obs as jobs
import defer_tpu.obs.cluster as jcluster
import defer_tpu.obs.report as jreport
import defer_tpu_torch.cli as tcli
import defer_tpu_torch.obs as tobs
import defer_tpu_torch.obs.cluster as tcluster
import defer_tpu_torch.obs.report as treport
from defer_tpu import partition as jpartition
from defer_tpu.models import resnet_tiny as jresnet_tiny
from defer_tpu.runtime import node as jnode
from defer_tpu_torch import models, params_from_jax, partition
from defer_tpu_torch.runtime import node as tnode
from defer_tpu_torch.transport import framed as tframed

torch.set_num_threads(1)

PKGS = {"jax": (jobs, jcluster, jreport), "torch": (tobs, tcluster, treport)}


class _Clock:
    """An injected ``time`` for a cluster module: ``monotonic`` steps
    0.25 s a call, the default report interval."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        self.t += 0.25
        return self.t


def both(fn, monkeypatch):
    """``fn(obs, cluster, report)`` for both packages under a fresh
    injected clock each; asserts equal results and returns the port's."""
    got = {}
    for name, (obs, cluster, report) in PKGS.items():
        monkeypatch.setattr(cluster, "time", _Clock())
        got[name] = fn(obs, cluster, report)
    assert got["torch"] == got["jax"]
    return got["torch"]


def _push(stage, *, processed, infer_ms=0.3, dec_ms=0.0, enc_ms=0.0,
          rx_hi=0, tx_hi=0, replica=None, depth=8, branch=None, join=0,
          tier="tcp", fallbacks=0, events=None, dropped=0):
    def summ(ms):
        if ms <= 0:
            return {"count": 0}
        return {"count": 10, "sum": ms / 1e3 * 10, "p50": ms / 1e3,
                "p95": ms / 1e3, "p99": ms / 1e3, "mean": ms / 1e3}
    return {"cmd": "obs_push",
            "node": {"stage": stage, "replica": replica, "fan_in": 1,
                     "branch": branch, "join": join, "tier": tier,
                     "tier_fallbacks": fallbacks,
                     "name": f"stage{stage}", "port": 5000 + stage},
            "processed": processed,
            "counters": {"tx_frames": processed, "tx_bytes": processed * 100,
                         "rx_frames": processed, "rx_bytes": processed * 100},
            "queues": {"rx_depth": depth, "tx_depth": depth, "rx": 0,
                       "tx": 0, "rx_hi": rx_hi, "tx_hi": tx_hi,
                       "inflight": 0, "merge": 0},
            "latency": {"infer_s": summ(infer_ms), "decode_s": summ(dec_ms),
                        "encode_s": summ(enc_ms), "rx_s": {"count": 0},
                        "tx_s": {"count": 0}},
            "capacity": {"flops": 1e9, "mfu": None,
                         "achieved_flops_s": 1e9 / (infer_ms / 1e3)},
            "mem_bytes": None, "recompiles": 0,
            "events": {"events": events or [], "dropped": dropped},
            "trace": {"dropped": 0}}


def _random_pushes(seed, stages=4, pushes=6, replicas=(None,)):
    """A seeded history of pushes: per interval, each stage's processed
    count, phase p50s and queue peaks."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(1, pushes + 1):
        for k in range(stages):
            for r in replicas:
                out.append((_push(
                    k, processed=int(10 * i + rng.integers(0, 3)),
                    infer_ms=float(rng.uniform(0.1, 5.0)),
                    dec_ms=float(rng.uniform(0.0, 3.0)),
                    enc_ms=float(rng.uniform(0.0, 3.0)),
                    rx_hi=int(rng.integers(0, 9)),
                    tx_hi=int(rng.integers(0, 9)), replica=r),
                    f"a:{k}:{r}"))
    return out


# ---------------------------------------------------------------------------
# the watermark splitter, the reporter, the clock estimator
# ---------------------------------------------------------------------------

class _FakeChan:
    def __init__(self):
        self.hi = 0

    def take_watermark(self):
        h, self.hi = self.hi, 0
        return h

    def qsize(self):
        return 0


def test_watermark_split_per_subscriber(monkeypatch):
    def fn(obs, cluster, report):
        split, chan, out = report.WatermarkSplit(), _FakeChan(), []
        split.register(1)
        split.register(2)
        for hi, sid in ((7, 1), (0, 2), (0, 1), (3, 2), (5, None), (0, 1)):
            chan.hi = hi or chan.hi
            out.append(split.take(sid, "rx", chan))
        split.unregister(2)
        return out, split.subscribers(), split.take(None, "rx", None)
    assert both(fn, monkeypatch) == ([7, 7, 0, 3, 5, 5], 1, 0)


def test_obs_reporter_dead_thread_survives_is_alive_check():
    class Src:
        def obs_snapshot(self, *, cursor, include_spans, span_limit):
            return {"node": {"stage": 0}, "processed": 0}, cursor

    a, b = socket.socketpair()
    rep = tobs.ObsReporter(Src(), a, interval_s=0.02)
    rep.start()
    kind, msg = tframed.recv_frame(b)
    assert kind == tframed.K_CTRL and msg["cmd"] == "obs_push"
    a.close()
    b.close()
    rep.join(timeout=10)
    assert rep.is_alive() is False
    rep.stop()


@pytest.fixture
def cpu_node():
    node = tnode.StageNode(None, "127.0.0.1:0", None, device="cpu")
    yield node
    node._srv.close()


def test_stage_node_watermarks_split_across_two_subscribers(cpu_node):
    rx = _FakeChan()
    rx.enc = rx.dec = tobs.LatencyHistogram()
    cpu_node._live_rx = rx
    cpu_node.obs_register(101)
    cpu_node.obs_register(202)
    rx.hi = 9
    p1, _, _ = cpu_node.obs_snapshot(subscriber=101, include_spans=False)
    p2, _, _ = cpu_node.obs_snapshot(subscriber=202, include_spans=False)
    assert p1["queues"]["rx_hi"] == p2["queues"]["rx_hi"] == 9
    p1b, _, _ = cpu_node.obs_snapshot(subscriber=101, include_spans=False)
    assert p1b["queues"]["rx_hi"] == 0
    cpu_node.obs_unregister(101)
    cpu_node.obs_unregister(202)
    # the push carries every key the JAX node's does
    jkeys = {"node", "processed", "reweights", "counters", "queues",
             "latency", "capacity", "recompiles", "mem_bytes", "trace",
             "events"}
    assert jkeys <= set(p1)
    assert p1["mem_bytes"] is None   # the CPU has no card to read


def test_obs_reporter_registers_with_the_node_splitter(cpu_node):
    a, b = socket.socketpair()
    rep = tobs.ObsReporter(cpu_node, a, interval_s=0.02, spans=False)
    rep.start()
    kind, msg = tframed.recv_frame(b)
    assert kind == tframed.K_CTRL and msg["cmd"] == "obs_push"
    assert cpu_node._wm().subscribers() == 1
    a.close()
    b.close()
    rep.join(timeout=10)
    assert not rep.is_alive() and cpu_node._wm().subscribers() == 0


def _probe_responder(sock, remote, framed):
    while True:
        kind, msg = framed.recv_frame(sock)
        if kind == framed.K_END:
            return
        if msg["cmd"] == "clock_probe":
            framed.send_ctrl(sock, {"cmd": "clock_probe_reply",
                                    "t_us": remote.now_us(),
                                    "echo": msg.get("echo")})
        elif msg["cmd"] == "clock_adjust":
            remote.shift_wall_anchor(int(msg["offset_us"]))
            framed.send_ack(sock)


def test_clock_offset_estimator_with_injected_skew():
    local = tobs.Tracer(process="disp")
    remote = tobs.Tracer(process="node")
    skew = 250_000
    remote.shift_wall_anchor(skew)
    a, b = socket.socketpair()
    t = threading.Thread(target=_probe_responder, args=(b, remote, tframed),
                         daemon=True)
    t.start()
    try:
        est = tobs.estimate_clock_offset(a, rounds=8, local=local)
        assert est["offset_us"] == pytest.approx(skew, abs=5_000)
        assert est["rtt_us"] >= 0 and est["rounds"] == 8
        tobs.align_clock(a, rounds=8, local=local)
        assert abs(remote.now_us() - local.now_us()) < 5_000
        tframed.send_end(a)
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        a.close()
        b.close()


def test_stage_node_clock_ctrl_roundtrip(cpu_node):
    tr = tobs.tracer()
    wall0 = tr._wall0_us
    a, b = socket.socketpair()
    try:
        before = tr.now_us()
        assert cpu_node._handle_ctrl(a, {"cmd": "clock_probe", "echo": 3})
        kind, reply = tframed.recv_frame(b)
        assert kind == tframed.K_CTRL and reply["echo"] == 3
        assert reply["t_us"] >= before
        assert cpu_node._handle_ctrl(a, {"cmd": "clock_adjust",
                                         "offset_us": -777})
        kind, _ = tframed.recv_frame(b)
        assert kind == tframed.K_ACK
        assert tr._wall0_us == wall0 - 777
    finally:
        tr.shift_wall_anchor(wall0 - tr._wall0_us)
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# ClusterView and StragglerDetector on the same pushes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cluster_view_rows_equal_on_seeded_pushes(seed, monkeypatch):
    def fn(obs, cluster, report):
        view = obs.ClusterView()
        for push, addr in _random_pushes(seed, replicas=(None, 0, 1)
                                         if seed % 2 else (None,)):
            view.ingest(push, addr)
        return (view.rows(), view.bottleneck(), view.stats_rows(),
                {str(k): v for k, v in view.stage_service_ms().items()},
                {str(k): v for k, v in view.stage_service_ms(
                    window=cluster.SERVICE_WINDOW).items()},
                {str(k): v for k, v in view.stage_effective_ms().items()})
    rows, bott, *_ = both(fn, monkeypatch)
    assert rows and all(r["throughput_per_s"] > 0 for r in rows)


def test_cluster_view_timing_and_backpressure_bottlenecks(monkeypatch):
    def fn(obs, cluster, report):
        out = []
        for shape in ("decode", "edge"):
            view = obs.ClusterView()
            for i in range(3):
                view.ingest(_push(0, processed=10 * (i + 1),
                                  tx_hi=8 if shape == "edge" else 0), "a:1")
                view.ingest(_push(1, processed=10 * (i + 1),
                                  dec_ms=12.0 if shape == "decode" else 0),
                            "a:2")
                view.ingest(_push(2, processed=10 * (i + 1)), "a:3")
            out.append((view.bottleneck(), view.rows()[1]["service_ms"]))
        return out
    assert both(fn, monkeypatch) == [(1, 12.0), (1, 0.3)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_flags_equal(seed, monkeypatch):
    def fn(obs, cluster, report):
        view = obs.ClusterView()
        det = obs.StragglerDetector([0.3, 0.3, 0.3, 0.3], factor=1.5,
                                    sustain=2)
        flags = []
        for push, addr in _random_pushes(seed):
            view.ingest(push, addr)
            flags.append([f.to_json() for f in det.observe(view)])
        # a stalled stage: stage 2 stops while stage 0 keeps producing
        for i in range(7, 10):
            view.ingest(_push(0, processed=100 * i), "a:0:None")
            view.ingest(_push(2, processed=60), "a:2:None")
        flags.append([f.to_json() for f in det.observe(view)])
        return flags
    flags = both(fn, monkeypatch)
    assert any(f["reason"] == "slow" for f in flags[-1])
    assert {"stage": 2, "reason": "stalled"}.items() <= next(
        f for f in flags[-1] if f["stage"] == 2).items()


def test_straggler_suggest_replan_equal(monkeypatch):
    """The same live pushes give the same replan suggestion: each package
    replans its own graph (the same nodes and costs) against its own
    plan."""
    import defer_tpu.graph as jdt
    import defer_tpu.graph.ops as jops
    import defer_tpu.plan as jplan
    import defer_tpu_torch.graph as tdt
    import defer_tpu_torch.graph.ops as tops
    import defer_tpu_torch.plan as tplan

    def graph(dt, ops):
        b = dt.GraphBuilder("3stage")
        x = b.input((16,))
        for i in range(3):
            x = b.add(ops.Dense(16), x, name=f"n{i}")
        return b.build()

    graphs = {jcluster: (graph(jdt, jops), jplan),
              tcluster: (graph(tdt, tops), tplan)}

    def fn(obs, cluster, report):
        g, plan_mod = graphs[cluster]
        cm = plan_mod.StageCostModel(
            g, gen="v4", link_bw_s=1e9,
            node_costs={"n0": 3e-4, "n1": 3e-4, "n2": 3e-4})
        plan = plan_mod.evaluate_cuts(g, ["n0", "n1"], cm)
        view = obs.ClusterView()
        for i in range(1, 4):
            view.ingest(_push(0, processed=8 * i), "a:0")
            view.ingest(_push(1, processed=8 * i, enc_ms=10.0), "a:1")
            view.ingest(_push(2, processed=8 * i), "a:2")
        det = obs.StragglerDetector(obs.expected_stage_ms(plan),
                                    factor=1.5, sustain=2)
        flags = [f.to_json() for f in det.observe(view)]
        return flags, det.suggest(view, g, plan, cm).to_json()
    flags, sugg = both(fn, monkeypatch)
    assert [f["stage"] for f in flags] == [1]
    json.dumps(sugg)


def test_cluster_view_merges_cross_process_events(monkeypatch):
    def fn(obs, cluster, report):
        a = obs.FlightRecorder(process="stage0")
        b = obs.FlightRecorder(process="stage1")
        e0 = a.emit("stream_begin", hop="stage0")
        e1 = b.emit("stream_begin", hop="stage1")
        e2 = a.emit("stream_end", hop="stage0", n=4)
        e0["t_us"], e1["t_us"], e2["t_us"] = 100, 200, 300
        for e in (e0, e1, e2):
            e.pop("seq")
        view = obs.ClusterView()
        view.ingest(_push(0, processed=1, events=[dict(e0, seq=1),
                                                  dict(e2, seq=2)]), "a:1")
        view.ingest(_push(1, processed=1, events=[dict(e1, seq=1)],
                          dropped=2), "b:2")
        merged = view.events(include_local=False)
        return ([(e["t_us"], e["proc"], e["kind"]) for e in merged],
                view.events_dropped, len(view.take_events()),
                view.take_events())
    assert both(fn, monkeypatch) == (
        [(100, "stage0", "stream_begin"), (200, "stage1", "stream_begin"),
         (300, "stage0", "stream_end")], 2, 3, [])


def test_cluster_rows_carry_branch_ident(monkeypatch):
    def fn(obs, cluster, report):
        view = obs.ClusterView()
        view.ingest({"node": {"stage": 2, "name": "g/stage2.b1",
                              "replica": None, "branch": 1, "join": 0,
                              "fan_in": 1, "port": 1, "codec": "raw",
                              "tier": "tcp", "tier_in": None},
                     "processed": 3, "queues": {}, "latency": {},
                     "counters": {}}, "127.0.0.1:1")
        return view.rows()
    (r,) = both(fn, monkeypatch)
    assert r["branch"] == 1 and r["join"] == 0 and r["stage"] == 2


# ---------------------------------------------------------------------------
# the monitor's table, rendered by both packages' CLIs
# ---------------------------------------------------------------------------

def _render(cli, *args, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli._render_monitor(*args, **kw)
    return buf.getvalue()


def _row(stage, **kw):
    d = {"stage": stage, "replica": None, "branch": None, "join": None,
         "tier": "tcp", "tier_fallbacks": 0, "alive": True, "addr": "a:1",
         "infer_ms": {"p50": 1.0, "p95": 2.0, "p99": 3.0},
         "throughput_per_s": 10.0, "rx_q": 0, "tx_q": 0, "rx_hi": 0,
         "tx_hi": 0, "inflight": 0, "rx_bytes_per_s": 0.0,
         "tx_bytes_per_s": 0.0, "processed": 5}
    d.update(kw)
    return d


def _render_both(*args, **kw) -> str:
    out = _render(tcli, *args, **kw)
    assert out == _render(jcli, *args, **kw)
    return out


def test_monitor_renders_branch_column():
    out = _render_both([_row(0), _row(1, branch=1), _row(2, branch=2),
                        _row(3, join=3)], 1, [], {}, clear=False)
    assert "BR" in out.splitlines()[0]
    assert " b1 " in out and " b2 " in out and " j3 " in out
    marked = [ln for ln in out.splitlines() if "<- bottleneck" in ln]
    assert len(marked) == 1 and " b1 " in marked[0]


def test_monitor_renders_degraded_hop():
    row = _row(0, join=0, tier_fallbacks=1, infer_ms={"p50": 0.0,
                                                      "p95": 0.0,
                                                      "p99": 0.0})
    lines = _render_both([row, dict(row, tier_fallbacks=0)], None, [], {},
                         clear=False).splitlines()
    assert "tcp!" in lines[1] and "tcp!" not in lines[2]
    out = _render_both([dict(row, tier="shm"),
                        dict(row, tier="local", tier_fallbacks=0)], None, [],
                       {}, clear=False)
    assert "shm!" not in out and " shm " in out
    assert "local" in out and "loca!" not in out


def test_monitor_renders_host_sync_column():
    row = _row(0, join=0, tier="ici",
               host_sync_ms={"p50": 0.0, "count": 0})
    row2 = dict(row, stage=1, tier="local",
                host_sync_ms={"p50": 1.25, "count": 5})
    out = _render_both([row, row2], None, [], {}, clear=False)
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert "HS50" in out and "-" in lines[1].split()
    assert "1.250" in lines[2]


def test_monitor_renders_phase_mfu_drift_and_flags():
    rows = [_row(0, dispatch_ms={"p50": 0.5, "count": 3},
                 device_ms={"p50": 0.25, "count": 3}, mem_bytes=2.5e8,
                 mfu=0.0123, pred_ms=1.0, meas_ms=1.3, err=0.3),
            _row(1, alive=False)]
    flags = [tobs.StragglerFlag(1, "slow", 9.0, 0.3, 30.0, 2)]
    drift = [tobs.DriftFlag(0, 1.0, 1.3, 0.3, 2)]
    offs = {"a:1": {"offset_us": -1500.0}, "a:2": {"offset_us": 20.0}}
    out = _render_both(rows, 1, flags, offs, clear=False, drift=drift)
    assert "250.0M" in out and "1.2" in out and "+30.0" in out
    assert "[DEAD]" in out and "straggler: stage 1 [slow]" in out
    assert "model_drift: stage 0" in out and "worst offset 1.500 ms" in out
    # a row with no phase samples renders "-", never a fake 0
    assert "-" in out.splitlines()[2].split()


def test_serve_stats_render_equal():
    doc = {"mode": "tensor", "width": 8, "frames": 3, "queued": 0,
           "inflight": 1, "service_estimate_ms": 2.5,
           "tenants": {"a": {"weight": 2.0, "priority": 1, "queued": 0,
                             "admitted": 4, "shed": 1, "completed": 3,
                             "queue_delay_s": {"count": 3, "p50": 0.002,
                                               "p99": 0.004},
                             "slo_attainment": 0.75}},
           "attribution": {"a": {"e2e": {"count": 3, "p50": 0.01},
                                 "chain": {"p50": 0.006}}}}
    outs = []
    for cli in (tcli, jcli):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli._render_serve_stats(doc)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "75.0" in outs[0]


# ---------------------------------------------------------------------------
# live chains: each package's ClusterView watches the other's nodes
# ---------------------------------------------------------------------------

#: row fields that do not depend on when a push arrived (the frame
#: counters are the process's, and count the pushes themselves)
STATIC = ("stage", "replica", "branch", "join", "name", "tier",
          "tier_fallbacks", "processed", "infer_ms", "host_sync_ms",
          "dispatch_ms", "device_ms", "queue_ms", "service_ms", "flops",
          "mfu", "achieved_flops_s", "rx_depth", "tx_depth")


def _serve(nodes):
    ths = [threading.Thread(target=n.serve, daemon=True) for n in nodes]
    for t in ths:
        t.start()
    return ths


def _views_agree(addrs, n_stages):
    """Subscribe a JAX and a port ClusterView to ``addrs`` and wait until
    both hold two pushes of every node; returns both views' rows."""
    views = [jobs.ClusterView().connect(addrs, interval_ms=40,
                                        timeout_s=20),
             tobs.ClusterView().connect(addrs, interval_ms=40,
                                        timeout_s=20)]
    try:
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            rows = [v.rows() for v in views]
            if all(len(r) == n_stages and all(x["pushes"] >= 2 for x in r)
                   for r in rows):
                break
            time.sleep(0.05)
        rows = [v.rows() for v in views]
        botts = [v.bottleneck() for v in views]
        offs = [v.clock_offsets for v in views]
    finally:
        for v in views:
            v.close()
    assert [len(r) for r in rows] == [n_stages, n_stages]
    assert botts[0] == botts[1]
    assert set(offs[0]) == set(offs[1]) == set(addrs)
    for jr, tr in zip(*rows):
        assert {k: jr[k] for k in STATIC} == {k: tr[k] for k in STATIC}
    return rows


@pytest.fixture(scope="module")
def tiny():
    jg = jresnet_tiny()
    jp = jg.init(jax.random.key(0))
    g = models.resnet_tiny()
    p = params_from_jax(g, jax.tree.map(np.asarray, jp))
    return jg, jp, g, p


def _frames(m, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
            for _ in range(m)]


@pytest.mark.timeout(120)
def test_jax_and_port_views_agree_on_port_nodes(tiny):
    """A JAX ClusterView subscribed to port nodes reads what the port's
    view reads; the rows' service estimate is the stats row's max of the
    infer, decode and encode p50s (the formula ``plan/calibrate.py``
    predicts), and the deploy's capacity arrives as FLOPs."""
    _, _, g, p = tiny
    stages = partition(g, ["add_1"])
    nodes = [tnode.StageNode(None, "127.0.0.1:0", None, device="cpu")
             for _ in stages]
    ths = _serve(nodes)
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    disp = tnode.ChainDispatcher(addrs[0])
    try:
        disp.deploy(stages, p, addrs, batch=2)
        offs = disp.align_clocks(addrs)
        assert set(offs) == set(addrs)
        assert len(disp.stream(_frames(6))) == 6
        stats = disp.stats(addrs)
        rows, _ = _views_agree(addrs, len(stages))
    finally:
        disp.close()
    for t in ths:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ths)
    for r, s in zip(rows, stats):
        want = max(s[k]["p50"] if s[k].get("count") else 0.0
                   for k in ("infer_latency_s", "decode_latency_s",
                             "encode_latency_s")) * 1e3
        assert r["service_ms"] == pytest.approx(round(want, 4), abs=1e-9)
        assert r["processed"] == s["processed"] == 6
        assert r["flops"] == s["flops"] > 0
        # no peak for the CPU: MFU is None, never a number
        assert r["mfu"] is None and s["mfu"] is None
        assert s["achieved_flops_s"] > 0
        assert s["recompiles"] >= 0 and s["mem_bytes"] is None


@pytest.mark.timeout(120)
def test_jax_and_port_views_agree_on_jax_nodes(tiny):
    """A port ClusterView and a port dispatcher's clock alignment against
    JAX nodes."""
    jg, jp, _, _ = tiny
    jstages = jpartition(jg, ["add_1"])
    nodes = [jnode.StageNode(None, "127.0.0.1:0", None) for _ in jstages]
    ths = _serve(nodes)
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    jdisp = jnode.ChainDispatcher(addrs[0])
    try:
        jdisp.deploy(jstages, jp, addrs, batch=2)
        assert len(jdisp.stream(_frames(6, seed=1))) == 6
        for a in addrs:
            s = tframed.connect_retry("127.0.0.1", int(a.split(":")[1]), 20)
            try:
                est = tobs.align_clock(s)
                tframed.send_end(s)
            finally:
                s.close()
            assert abs(est["offset_us"]) < 5_000
        _views_agree(addrs, len(jstages))
    finally:
        jdisp.close()
    for t in ths:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ths)


@pytest.mark.timeout(120)
def test_run_chain_plan_appends_the_obs_entry(tiny):
    """``run_chain(plan=, graph=, stats_out=)`` watches the spawned chain
    and appends one ``obs`` entry after the nodes' rows, as JAX's does
    (pinned to tcp: it holds no shm segment)."""
    from defer_tpu_torch.plan import StageCostModel, evaluate_cuts

    _, _, g, p = tiny
    stages = partition(g, ["add_1"])
    plan = evaluate_cuts(g, ["add_1"], StageCostModel(g, batch=2,
                                                      gen="unknown"))
    stats = []
    xs = _frames(4, seed=2)
    outs = tnode.run_chain(stages, p, xs, batch=2, plan=plan, graph=g,
                           stats_out=stats, report_interval_ms=50,
                           tier="tcp", device="cpu")
    assert len(outs) == 4
    assert [s.get("stage") for s in stats[:-1]] == [0, 1]
    obs = stats[-1]["obs"]
    assert sorted(r["stage"] for r in obs["rows"]) == [0, 1]
    assert set(obs) >= {"rows", "bottleneck", "stragglers"}
    assert "replan" in obs or "replan_error" in obs
    json.dumps(obs)
