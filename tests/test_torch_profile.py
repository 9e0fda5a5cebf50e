"""Port parity: the profiling plane (``obs/profile.py``) against the JAX
package's, mirroring ``tests/test_profile.py``.

``ProfileSession`` window arithmetic, the recompile episode discipline
through ``wrap()`` and the memory watcher's thresholds and hysteresis run
once per package on the same inputs and must give EQUAL reports and
events.  The port counts its compile points through one hook: a
``torch.export`` trace and an artifact load here (and a hand kernel's
``nvcc`` build, with a stand-in compiler); a CUDA-graph capture is checked
on the card (``tests/test_torch_cuda.py``).  On the CPU the memory
reading is ``None``, as JAX's is without a device allocator; the watcher's
arithmetic is fed stand-in readings.  The node's ``profile_start``/
``profile_stop`` protocol, the phase-sum invariant on a live chain and
both packages' ``profile`` CLIs run against port nodes.
"""

import contextlib
import io
import json
import socket
import stat
import threading
import time

import numpy as np
import pytest
import torch

import defer_tpu.cli as jcli
import defer_tpu.obs as jobs
import defer_tpu.obs.profile as jprofile
import defer_tpu_torch.cli as tcli
import defer_tpu_torch.obs as tobs
import defer_tpu_torch.obs.profile as tprofile
from defer_tpu_torch import models, partition
from defer_tpu_torch.runtime import node as tnode
from defer_tpu_torch.transport import framed as tframed
from defer_tpu_torch.utils import export as texport

torch.set_num_threads(1)

PKGS = {"jax": (jobs, jprofile), "torch": (tobs, tprofile)}


def both(fn):
    got = {name: fn(*mods) for name, mods in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _events(obs, kind, since):
    _, evs = obs.recorder().events_since(since)
    return [e["data"] for e in evs if e["kind"] == kind]


# ---------------------------------------------------------------------------
# ProfileSession: window deltas over cumulative histograms
# ---------------------------------------------------------------------------

def test_profile_session_deltas_and_double_start():
    def fn(obs, profile):
        rng = np.random.default_rng(0)
        h = {"dispatch": obs.LatencyHistogram(),
             "infer": obs.LatencyHistogram()}
        h["dispatch"].record(0.010)
        h["infer"].record(0.015)
        seen = [7]
        sess = obs.ProfileSession(h, processed=lambda: seen[0])
        started = sess.start()
        assert started["t0_unix"] > 0
        with pytest.raises(RuntimeError, match="already started"):
            sess.start()
        for v in rng.uniform(0.001, 0.004, 4):
            h["dispatch"].record(float(v))
            h["infer"].record(float(v) * 1.5)
        seen[0] = 12
        rep = sess.stop()
        with pytest.raises(RuntimeError, match="never started"):
            sess.stop()
        assert rep["duration_s"] > 0
        return rep["phases"], rep["processed"], rep["recompiles"]
    phases, processed, recompiles = both(fn)
    assert phases["dispatch"]["count"] == 4 and processed == 5
    assert recompiles == 0


def test_profile_session_absent_phase_stays_honest():
    def fn(obs, profile):
        sess = obs.ProfileSession({"gather": None})
        sess.start()
        return sess.stop()["phases"]
    assert both(fn) == {"gather": {"count": 0, "sum_s": 0.0,
                                   "mean_ms": None, "p50_ms_cum": None}}


def test_profile_session_kernel_launch_window():
    """The port's session also prices the window's hand-kernel launches."""
    counts = {"flash_attention": 3, "quant_int8": 1}
    sess = tobs.ProfileSession({}, launches=lambda: dict(counts))
    sess.start()
    counts["flash_attention"] += 24
    rep = sess.stop()
    assert rep["kernel_launches"] == {"flash_attention": 24,
                                      "quant_int8": 0}
    assert rep["trace_dir"] is None and rep["trace_file"] is None


# ---------------------------------------------------------------------------
# recompiles: wrap(), the episode discipline, and the port's compile points
# ---------------------------------------------------------------------------

def test_recompile_wrap_episode_discipline():
    def fn(obs, profile):
        w = obs.RecompileWatcher(episode_gap_s=0.2)
        since = obs.recorder().cursor()
        calls = []
        f = w.wrap(lambda *a: calls.append(a), label="stage_fn")
        c0, counts = w.count, []
        f(np.zeros((2, 4), np.float32))        # warm-up: counted, silent
        f(np.zeros((2, 4), np.float32))        # a repeat: no count
        counts.append(w.count - c0)
        w.arm()
        for rows in (3, 4, 5):                 # one burst, one event
            f(np.zeros((rows, 4), np.float32))
        counts.append(w.count - c0)
        time.sleep(0.25)                        # quiet re-arms lazily
        f(np.zeros((6, 4), np.float32))
        w.disarm()
        f(np.zeros((7, 4), np.float32))        # counted, silent
        counts.append(w.count - c0)
        evs = [{k: v for k, v in e.items() if k != "count"}
               for e in _events(obs, "recompile", since)]
        return counts, evs, len(calls)
    counts, evs, calls = both(fn)
    assert counts == [1, 4, 6] and calls == 7
    assert evs == [{"via": "wrap", "label": "stage_fn",
                    "shapes": ["float32[3,4]"]},
                   {"via": "wrap", "label": "stage_fn",
                    "shapes": ["float32[6,4]"]}]


def test_wrap_formats_tensors_as_arrays():
    w = tobs.RecompileWatcher()
    since = tobs.recorder().cursor()
    w.arm()
    w.wrap(lambda x: x, label="t")(torch.zeros(2, 3, dtype=torch.bfloat16))
    (ev,) = _events(tobs, "recompile", since)
    assert ev["shapes"] == ["bfloat16[2,3]"]
    w.disarm()


def test_export_trace_and_load_count_as_compilations(monkeypatch):
    """A ``torch.export`` trace and an artifact load each record one
    compilation; the process-kept trace of the same stage records none; an
    armed watcher's first compile after quiet emits one event naming its
    compile point."""
    g = models.resnet_tiny()
    p = g.init(torch.Generator().manual_seed(0))
    stage = partition(g, ["add_1"])[0]
    monkeypatch.setattr(texport, "_PROGRAMS", {})
    w = tprofile.recompile_watcher()
    since = tobs.recorder().cursor()
    c0 = w.count
    w.arm()
    blob = texport.export_stage_bytes(stage, p, batch=3)
    assert w.count - c0 == 1
    texport.export_stage_bytes(stage, p, batch=3)       # kept: no count
    assert w.count - c0 == 1
    texport.load_stage_program(blob, device="cpu")
    assert w.count - c0 == 2
    w.disarm()
    (ev,) = _events(tobs, "recompile", since)
    assert ev["via"] == "export.trace" and ev["label"] == stage.output_name
    assert tobs.REGISTRY.histogram("compile_s").count >= 2


def test_nvcc_build_counts_as_a_compilation(tmp_path, monkeypatch):
    """``ops/_build.build`` records one compilation per source it builds
    (a stand-in compiler that writes its ``-o`` file), none for a library
    built already."""
    from defer_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = \"-o\" ]; then : > \"$2\"; fi\n"
                    "  shift\ndone\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    w = tprofile.recompile_watcher()
    c0 = w.count
    out = _build.build(["quant_int8.cu", "flash_attention.cu"])
    assert w.count - c0 == 2 and all(v["path"].exists()
                                     for v in out.values())
    _build.build(["quant_int8.cu"])
    assert w.count - c0 == 2


# ---------------------------------------------------------------------------
# memory: the watcher's thresholds and hysteresis
# ---------------------------------------------------------------------------

def test_memory_watcher_threshold_and_hysteresis(monkeypatch):
    readings = [(512, 3), (600, 3), (600, 3), (10, 1), (700, 4)]
    thresholds = [1.0, 1.0, 1e15, 1.0, 1.0]

    def fn(obs, profile):
        it = iter(readings)
        monkeypatch.setattr(profile, "device_memory",
                            lambda *a, **k: next(it))
        mw = obs.MemoryWatcher()
        since = obs.recorder().cursor()
        got = []
        for thr in thresholds:
            mw.set_threshold(thr)
            got.append(mw.observe())
        return (got, _events(obs, "mem_pressure", since),
                obs.REGISTRY.gauge("device.mem_bytes").value)
    got, evs, gauge = both(fn)
    assert got == [512, 600, 600, 10, 700] and gauge == 700.0
    assert evs == [{"bytes": 512, "threshold": 1, "live_arrays": 3},
                   {"bytes": 10, "threshold": 1, "live_arrays": 1}]


def test_memory_watcher_environment_thresholds(monkeypatch):
    def fn(obs, profile):
        mw = obs.MemoryWatcher()
        monkeypatch.delenv("DEFER_MEM_PRESSURE_BYTES", raising=False)
        monkeypatch.setenv("DEFER_MEM_PRESSURE_FRAC", "0.5")
        unset = mw.threshold_bytes()     # no card here: no limit to scale
        monkeypatch.setenv("DEFER_MEM_PRESSURE_BYTES", "12345")
        env = mw.threshold_bytes()
        mw.set_threshold(99.0)           # explicit beats the environment
        return unset, env, mw.threshold_bytes()
    assert both(fn) == (None, 12345.0, 99.0)


def test_device_memory_is_none_on_the_cpu():
    assert tprofile.device_memory() is None
    assert tprofile.device_memory_bytes(device="cpu") is None
    assert tprofile.memory_watcher().observe("cpu") is None


# ---------------------------------------------------------------------------
# the node's profile commands
# ---------------------------------------------------------------------------

@pytest.fixture
def cpu_node():
    node = tnode.StageNode(None, "127.0.0.1:0", None, device="cpu")
    node.prog = type("P", (), {"manifest": {"index": 1, "name": "stage1"}})()
    yield node
    node._srv.close()


def test_profile_ctrl_window_and_double_start(cpu_node, tmp_path):
    node = cpu_node
    a, b = socket.socketpair()
    try:
        assert node._handle_ctrl(a, {"cmd": "profile_start",
                                     "trace_dir": str(tmp_path)})
        kind, rep = tframed.recv_frame(b)
        assert rep["cmd"] == "profile_started" and rep["node"] == "stage1"
        assert node._handle_ctrl(a, {"cmd": "profile_start"})
        kind, rep = tframed.recv_frame(b)
        assert rep["cmd"] == "profile_err" and "already active" in \
            rep["error"]
        assert node._profile is not None
        for _ in range(3):
            node.disp_hist.record(0.001)
            node.queue_hist.record(0.0005)
            node.dev_hist.record(0.002)
            node.host_sync_hist.record(0.0015)
            node.infer_hist.record(0.005)
        node.processed = 3
        assert node._handle_ctrl(a, {"cmd": "profile_stop"})
        kind, rep = tframed.recv_frame(b)
        r = rep["report"]
        assert rep["cmd"] == "profile_report" and r["stage"] == 1
        assert r["processed"] == 3 and r["recompiles"] == 0
        for name in tobs.NODE_PHASES:
            assert r["phases"][name]["count"] == 3
        assert r["phases"]["infer"]["sum_s"] == pytest.approx(0.015,
                                                              rel=0.01)
        assert r["mem_bytes"] is None
        assert r["kernel_launches"] == {"quant_int8": 0,
                                        "flash_attention": 0}
        # the window's torch.profiler trace, in the asked directory
        assert r["trace_dir"] == str(tmp_path)
        assert json.loads(open(r["trace_file"]).read())["traceEvents"] \
            is not None
        assert node._handle_ctrl(a, {"cmd": "profile_stop"})
        kind, rep = tframed.recv_frame(b)
        assert rep["cmd"] == "profile_err"
        assert "no active profile session" in rep["error"]
    finally:
        a.close()
        b.close()


def test_stats_reply_carries_profile_telemetry(cpu_node):
    node = cpu_node
    node.disp_hist.record(0.004)
    node.queue_hist.record(0.001)
    node.dev_hist.record(0.006)
    a, b = socket.socketpair()
    try:
        assert node._handle_ctrl(a, {"cmd": "stats"})
        _, rep = tframed.recv_frame(b)
    finally:
        a.close()
        b.close()
    assert rep["dispatch_s"]["count"] == rep["queue_s"]["count"] == 1
    assert rep["recompiles"] == tobs.REGISTRY.counter("compiles").value
    assert rep["mem_bytes"] is None and rep["profiling"] is False


def _chain(n=2):
    g = models.resnet_tiny()
    p = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=n)
    nodes = [tnode.StageNode(None, "127.0.0.1:0", None, device="cpu")
             for _ in stages]
    ths = [threading.Thread(target=nd.serve, daemon=True) for nd in nodes]
    for t in ths:
        t.start()
    addrs = [f"127.0.0.1:{nd.address[1]}" for nd in nodes]
    disp = tnode.ChainDispatcher(addrs[0])
    disp.deploy(stages, p, addrs, batch=2)
    return nodes, ths, addrs, disp


def _xs(m):
    return [np.random.default_rng(i).standard_normal(
        (2, 32, 32, 3)).astype(np.float32) for i in range(m)]


@pytest.mark.timeout(120)
def test_phase_sums_tile_infer_on_a_live_chain():
    nodes, ths, addrs, disp = _chain()
    try:
        disp.stream(_xs(4))
        disp.stream(_xs(16))
        for node in nodes:
            inf = node.infer_hist.summary()
            parts = sum(h.summary().get("sum", 0.0)
                        for h in (node.disp_hist, node.queue_hist,
                                  node.dev_hist, node.host_sync_hist))
            assert inf["count"] == 20
            assert parts == pytest.approx(inf["sum"], rel=0.15)
    finally:
        disp.close()
    for t in ths:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ths)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cli", [tcli, jcli], ids=["port", "jax"])
def test_profile_cli_against_port_nodes(cli, tmp_path):
    """Either package's ``profile`` CLI brackets a window on port nodes
    while a stream runs, and reads one report per node."""
    nodes, ths, addrs, disp = _chain()
    out = tmp_path / "profile.json"
    try:
        disp.stream(_xs(2))
        done = threading.Event()

        def feed():
            while not done.is_set():
                disp.stream(_xs(4))

        th = threading.Thread(target=feed, daemon=True)
        th.start()
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                cli.main(["profile", "--nodes", ",".join(addrs),
                          "--seconds", "1.0", "--out", str(out)])
        finally:
            done.set()
            th.join(timeout=60)
        assert not th.is_alive()
    finally:
        disp.close()
    for t in ths:
        t.join(timeout=30)
    doc = json.loads(out.read_text())
    assert set(doc["nodes"]) == set(addrs)
    for rep in doc["nodes"].values():
        assert set(rep["phases"]) == {"dispatch", "queue", "device",
                                      "host_sync", "infer"}
        assert rep["phases"]["infer"]["count"] == rep["processed"] > 0
        assert rep["recompiles"] == 0
    assert set(doc["clock_offsets"]) == set(addrs)


def test_monitor_renders_phase_columns_and_dash_when_absent():
    def row(stage, *, disp=None, dev=None, mem=None):
        def ms(v):
            return ({"p50": v, "count": 10} if v is not None
                    else {"p50": 0.0, "count": 0})
        return {"stage": stage, "replica": None, "branch": None, "join": 0,
                "tier": "tcp", "tier_fallbacks": 0,
                "throughput_per_s": 10.0, "processed": 100, "alive": True,
                "infer_ms": {"p50": 1.0, "p95": 1.2, "p99": 1.4},
                "host_sync_ms": ms(0.2), "dispatch_ms": ms(disp),
                "device_ms": ms(dev), "queue_ms": ms(None),
                "mem_bytes": mem, "recompiles": None, "mfu": None,
                "pred_ms": None, "meas_ms": None, "err": None,
                "rx_q": 0, "tx_q": 0, "rx_hi": 0, "tx_hi": 0,
                "inflight": 0, "rx_bytes_per_s": 0.0,
                "tx_bytes_per_s": 0.0, "addr": f"127.0.0.1:{5000 + stage}"}

    rows = [row(0, disp=0.5, dev=1.25, mem=2.5e6), row(1)]
    outs = []
    for cli in (tcli, jcli):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli._render_monitor(rows, None, [], {}, clear=False)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    body = [ln for ln in outs[0].splitlines()[1:] if ln.strip()]
    assert "0.500" in body[0] and "1.250" in body[0] and "2.5M" in body[0]
    cols = body[1].split()
    assert cols[9] == "-" and cols[10] == "-" and cols[11] == "-"

