"""Port parity: the metrics registry's exposition and JSON dump, the
tracer's anchor shift and hooks, the flight recorder's coupled shift, and
``StopwatchWindow``, against the JAX package's (``tests/test_obs.py``,
``tests/test_obs_live.py``'s tracer and exposition cases,
``defer_tpu/utils/metrics.py``).

Every scenario runs once per package on the same instruments, fed the
same values from a numpy seed; the results are pure Python, so they must
be EQUAL: the exposition text byte for byte, snapshots, span timestamps.
"""

import json
import re
import threading
import time
import urllib.request

import numpy as np
import pytest

import defer_tpu.obs as jobs
import defer_tpu.obs.events as jevents
import defer_tpu.obs.trace as jtrace
import defer_tpu.utils.metrics as jmetrics
import defer_tpu_torch.obs as tobs
import defer_tpu_torch.obs.events as tevents
import defer_tpu_torch.obs.trace as ttrace
import defer_tpu_torch.utils.metrics as tmetrics

PKGS = {"jax": jobs, "torch": tobs}


def both(fn):
    """``fn(package)`` for both packages; asserts the results are equal
    and returns the port's."""
    got = {name: fn(pk) for name, pk in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _fill(pk, seed: int):
    """A registry holding every instrument kind, with hostile names, fed
    from one numpy seed."""
    rng = np.random.default_rng(seed)
    r = pk.MetricsRegistry()
    r.counter("transport.tx_frames").inc(int(rng.integers(1, 100)))
    r.counter("1starts.with-digit").inc(1)
    r.counter("weird name/with spaces").inc(2)
    r.gauge("node.rx_queue_depth").set(float(rng.integers(0, 9)))
    r.gauge('quote"and\\back\nslash').set(float(rng.random()))
    h = r.histogram("push.latency_s")
    for v in rng.exponential(0.01, 64):
        h.record(float(v))
    r.histogram("empty_s")
    r.register_callback("cb.int", lambda: 7)
    r.register_callback("cb.float", lambda: 1.5)
    r.register_callback("cb.dict", lambda: {"a": 1})
    return r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_text_equal(seed):
    text = both(lambda pk: _fill(pk, seed).exposition())
    assert text.endswith("\n")
    assert "_1starts_with_digit 1" in text
    assert "weird_name_with_spaces 2" in text
    assert 'push_latency_s{quantile="0.5"}' in text
    # a non-numeric callback has no exposition line
    assert "cb_dict" not in text


def test_exposition_lines_are_promtool_valid():
    help_re = re.compile(r"^# HELP [a-zA-Z_:][a-zA-Z0-9_:]* .*$")
    type_re = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                         r"(counter|gauge|summary|histogram)$")
    sample_re = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_]+='
                           r'"(\\.|[^"\\\n])*"\})? -?[0-9.eE+naif]+$')
    announced = set()
    for line in _fill(tobs, 3).exposition().strip().split("\n"):
        if line.startswith("# HELP"):
            assert help_re.match(line), line
            announced.add(line.split()[2])
        elif line.startswith("# TYPE"):
            assert type_re.match(line) and line.split()[2] in announced
        else:
            assert sample_re.match(line), line


def test_exposition_skips_a_raising_callback():
    def fn(pk):
        r = pk.MetricsRegistry()
        r.counter("ok").inc()
        r.register_callback("dead", lambda: 1 / 0)
        return r.exposition()
    assert both(fn) == ("# HELP ok defer_tpu metric ok\n"
                        "# TYPE ok counter\nok 1\n")


def test_snapshot_and_dump_json_equal(tmp_path):
    def fn(pk):
        r = _fill(pk, 4)
        path = tmp_path / f"{pk.__name__}.json"
        r.dump_json(str(path))
        return r.snapshot(), path.read_text()
    snap, text = both(fn)
    assert json.loads(text) == json.loads(json.dumps(snap))
    assert snap["cb.dict"] == {"a": 1}


def test_unregister_prefix_and_clear():
    def fn(pk):
        r = pk.MetricsRegistry()
        for name in ("p0.a", "p0.b", "p1.a"):
            r.counter(name)
        r.register_callback("p0.cb", lambda: 1)
        r.unregister("p0.")
        kept = sorted(r.snapshot())
        r.clear()
        return kept, r.snapshot(), r.exposition()
    assert both(fn) == (["p1.a"], {}, "\n")


def test_get_registry_is_the_process_registry():
    assert tobs.get_registry() is tobs.REGISTRY


def test_prom_http_endpoint_serves_the_exposition():
    r = _fill(tobs, 5)
    srv = tobs.start_prom_server(0, registry=r)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/metrics",
            timeout=10).read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
    assert body == r.exposition() == _fill(jobs, 5).exposition()


# ---------------------------------------------------------------------------
# the tracer's anchor shift and the recorder's coupled shift
# ---------------------------------------------------------------------------

def test_shift_wall_anchor_moves_buffered_spans_equally():
    def fn(pk):
        t = pk.Tracer(process="t", enabled=True)
        # pin the anchors so both packages stamp the same timestamps
        t._wall0_us, t._mono0 = 1_000_000, 0.0
        for i, (t0, dur) in enumerate([(0.5, 0.001), (1.25, 0.002)]):
            t.record(f"s{i}", t0, dur)
        before = [s["ts_us"] for s in t.spans]
        t.shift_wall_anchor(123_456)
        return before, [s["ts_us"] for s in t.spans], t._wall0_us
    before, after, wall0 = both(fn)
    assert after == [b + 123_456 for b in before]
    assert wall0 == 1_123_456


def test_anchor_hooks_follow_the_process_tracer_only():
    """A process tracer's shift runs the registered hooks (the flight
    recorder's buffered events shift with it); a test-local tracer's
    does not."""
    for trace_mod, events_mod in ((jtrace, jevents), (ttrace, tevents)):
        seen = []
        trace_mod.register_anchor_hook(seen.append)
        try:
            trace_mod.Tracer(process="local").shift_wall_anchor(5)
            assert seen == []
            ev = events_mod.emit("quiesce", hop="anchor-test", processed=0)
            t_us = ev["t_us"]
            tr = trace_mod.tracer()
            wall0 = tr._wall0_us
            try:
                tr.shift_wall_anchor(777)
                assert seen == [777]
                assert ev["t_us"] == t_us + 777
            finally:
                tr.shift_wall_anchor(-777)
            assert tr._wall0_us == wall0 and ev["t_us"] == t_us
        finally:
            trace_mod._ANCHOR_HOOKS.remove(seen.append)


def test_shift_survives_concurrent_recording():
    """shift_wall_anchor iterates a snapshot of the buffer: a hot-path
    thread appending meanwhile never raises in the shifting thread."""
    t = tobs.Tracer(process="t", enabled=True)
    stop = threading.Event()
    errs = []

    def record():
        try:
            while not stop.is_set():
                t.record("hot", 0.0, 1e-6)
        except BaseException as e:  # noqa: BLE001 — the regression
            errs.append(e)

    th = threading.Thread(target=record, daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + 0.3
        while time.monotonic() < deadline:
            t.shift_wall_anchor(7)
            t.drain()
    finally:
        stop.set()
        th.join(timeout=10)
    assert not th.is_alive() and errs == []


# ---------------------------------------------------------------------------
# StopwatchWindow
# ---------------------------------------------------------------------------

def test_stopwatch_window_matches_jax(monkeypatch):
    """The same tick sequence under the same injected clock gives the same
    window verdicts, counts and rate."""
    def fn(mod):
        clock = iter([10.0, 10.1, 10.6, 11.2, 11.5, 11.5])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        w = mod.StopwatchWindow(1.0)
        out = [w.tick(), w.tick(3), w.tick(2)]
        return out, w.count, w.elapsed, w.rate
    got = [fn(m) for m in (jmetrics, tmetrics)]
    assert got[0] == got[1]
    assert got[1][0] == [True, True, False] and got[1][1] == 6
