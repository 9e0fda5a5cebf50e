"""``Defer.run_defer`` on the port: the queue service, its failure handling,
the resubmit log's ``ReplayBuffer`` and the flight recorder's events.

Mirrors ``tests/test_dispatcher.py``'s ``run_defer`` cases,
``tests/test_failure.py`` and the ``ReplayBuffer`` cases of
``tests/test_replay.py`` on the CPU, with resnet_tiny and the JAX
package's weights; outputs are held against the JAX forward to 2e-4, as
the JAX tests hold theirs.

No test here depends on timing.  A simulated hung dispatch ("wedge") is
keyed on what the push carries — the block that holds a given input, or
the first all-bubble push after the last real input — never on a count of
calls, which the gather's timing changes; every wedge is released in a
``finally``; and a test that pokes the watchdog first waits until the
serve thread is idle.
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

import jax

import defer_tpu.models as jax_models
from defer_tpu.utils.config import DeferConfig as JaxDeferConfig
from defer_tpu_torch import (END_OF_STREAM, Defer, DeferConfig, DeferHandle,
                             models, params_from_jax)
from defer_tpu_torch.graph.ir import tree_map
from defer_tpu_torch.obs import REGISTRY
from defer_tpu_torch.obs.events import (EVENT_KINDS, FlightRecorder,
                                        merge_events, recorder,
                                        validate_event)
from defer_tpu_torch.transport.replay import ReplayBuffer

torch.set_num_threads(1)

#: generous bound on any wait for the serve thread (never reached when the
#: code is right)
WAIT_S = 120


@pytest.fixture(scope="module")
def tiny():
    jg = jax_models.resnet_tiny()
    np_params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(0)))
    tg = models.resnet_tiny()
    fwd = jax.jit(jg.apply)
    ref = lambda xs: np.stack([np.asarray(fwd(np_params, x)) for x in xs])
    return tg, params_from_jax(tg, np_params), ref


def _xs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
            for _ in range(n)]


def _drain(out_q, n, h):
    outs = []
    while len(outs) < n:
        o = out_q.get(timeout=WAIT_S)
        assert o is not END_OF_STREAM, \
            f"stream aborted after {len(outs)} outputs (error: {h.error!r})"
        outs.append(o)
    return outs


def _cpu(**kw):
    return Defer(DeferConfig(device="cpu", **kw))


# ---------------------------------------------------------------------------
# the queue service
# ---------------------------------------------------------------------------

def test_run_defer_queue_service(tiny):
    """The reference harness pattern: spawn run_defer, feed an input
    queue, drain an output queue."""
    tg, params, ref = tiny
    disp = REGISTRY.counter("dispatcher.dispatches")
    n0 = disp.n
    in_q, out_q = queue.Queue(maxsize=10), queue.Queue()
    h = _cpu(microbatch=1, chunk=4).run_defer(tg, params, ["add_1"],
                                              in_q, out_q)
    xs = _xs(7, 3)
    for x in xs:
        in_q.put(x)
    in_q.put(END_OF_STREAM)
    h.join(timeout=WAIT_S)
    assert not h._thread.is_alive()
    outs = [out_q.get_nowait() for _ in range(7)]
    assert out_q.empty()
    assert all(o.dtype == np.float32 and o.shape == (1, 10) for o in outs)
    np.testing.assert_allclose(np.stack(outs), ref(xs), rtol=2e-4,
                               atol=2e-4)
    assert h.healthy and h.metrics.inferences == 7
    assert disp.n - n0 >= 2  # the preflight, the pushes and the flush
    assert REGISTRY.snapshot()["dispatcher.dispatch_s"]["count"] >= 2


def test_run_defer_bf16_equals_run(tiny):
    """bf16 compute on the int8 wire: the service's outputs equal
    ``Defer.run`` on the same inputs exactly (same engine, same chunks of
    work per microbatch)."""
    tg, params, _ = tiny
    d = _cpu(microbatch=1, chunk=3, wire="int8", compute_dtype="bfloat16")
    xs = _xs(2 * 3 + 2, 4)
    in_q, out_q = queue.Queue(), queue.Queue()
    h = d.run_defer(tg, params, ["add_1"], in_q, out_q)
    for x in xs:
        in_q.put(x)
    in_q.put(END_OF_STREAM)
    h.join(timeout=WAIT_S)
    outs = np.stack([out_q.get_nowait() for _ in xs])
    np.testing.assert_array_equal(outs, d.run(tg, params, np.stack(xs),
                                              ["add_1"]))


def test_run_defer_mpmd_mode(tiny):
    tg, params, ref = tiny
    in_q, out_q = queue.Queue(), queue.Queue()
    h = _cpu(mode="mpmd").run_defer(tg, params, ["add_1"], in_q, out_q)
    xs = _xs(3, 4)
    for x in xs:
        in_q.put(x)
    in_q.put(END_OF_STREAM)
    h.join(timeout=WAIT_S)
    outs = [out_q.get_nowait() for _ in range(3)]
    np.testing.assert_allclose(np.stack(outs), ref(xs), rtol=2e-4,
                               atol=2e-4)


def test_run_defer_error_propagates(tiny):
    """A bad input must not silently kill the serve thread: join()
    re-raises and the output queue gets the sentinel."""
    tg, params, _ = tiny
    in_q, out_q = queue.Queue(), queue.Queue()
    h = _cpu(microbatch=1, chunk=2).run_defer(tg, params, ["add_1"],
                                              in_q, out_q)
    in_q.put(np.zeros((1, 8, 8, 3), np.float32))  # wrong spatial shape
    with pytest.raises(RuntimeError, match="dispatcher thread failed"):
        h.join(timeout=WAIT_S)
    assert out_q.get(timeout=10) is END_OF_STREAM
    assert not h.healthy


# ---------------------------------------------------------------------------
# failure detection and recovery (tests/test_failure.py)
# ---------------------------------------------------------------------------

def test_health_check_ok_and_reports_failure(tiny):
    tg, params, _ = tiny
    rep = _cpu(microbatch=1, chunk=2).health_check(tg, params, num_stages=4)
    assert rep["ok"] and rep["stages"] == 4 and rep["error"] is None
    assert rep["device"] == "cpu"
    # missing parameters: every stage fails when it runs
    rep = _cpu(microbatch=1, chunk=2).health_check(tg, {}, num_stages=1)
    assert not rep["ok"] and rep["error"] is not None


def test_run_defer_propagates_stage_error(tiny):
    tg, params, _ = tiny
    in_q, out_q = queue.Queue(), queue.Queue()
    h = _cpu(microbatch=1, chunk=2).run_defer(tg, params, None, in_q, out_q,
                                              num_stages=2)
    in_q.put(np.zeros((1, 7), np.float32))  # wrong input shape
    assert out_q.get(timeout=WAIT_S) is END_OF_STREAM
    assert not h.healthy
    with pytest.raises(RuntimeError, match="dispatcher thread failed"):
        h.join(timeout=60)


def _wait_idle(h):
    """Until the preflight dispatch has completed (the serve thread then
    waits for input, outside any dispatch)."""
    deadline = time.monotonic() + WAIT_S
    while h._dispatches < 1:
        assert time.monotonic() < deadline, "preflight never completed"
        assert h.error is None, h.error
        time.sleep(0.01)


def test_watchdog_declares_hung_dispatch(tiny):
    tg, params, _ = tiny
    # detection only (max_recoveries=0): the first fire is fatal
    d = _cpu(microbatch=1, chunk=2, watchdog_s=0.5, max_recoveries=0)
    in_q, out_q = queue.Queue(), queue.Queue()
    cursor = recorder().cursor()
    h = d.run_defer(tg, params, None, in_q, out_q, num_stages=2)
    try:
        _wait_idle(h)
        # a dispatch that entered long ago and never finished
        h._busy_since = time.monotonic() - 1e4
        assert out_q.get(timeout=WAIT_S) is END_OF_STREAM
        assert isinstance(h.error, TimeoutError) and not h.healthy
        _, evs = recorder().events_since(cursor)
        assert [e["data"]["action"] for e in evs
                if e["kind"] == "watchdog"] == ["dead"]
    finally:
        h.stop()


def test_failure_detection_defaults_on():
    """The dispatcher's defaults equal the JAX package's: detection and
    recovery on out of the box."""
    cfg, jcfg = DeferConfig(), JaxDeferConfig()
    assert cfg.watchdog_s == 60.0
    assert cfg.preflight is True
    assert cfg.max_recoveries == 1
    for field in ("gather_timeout_s", "watchdog_s", "watchdog_scale",
                  "preflight", "max_recoveries", "microbatch", "chunk",
                  "buffer_dtype", "compute_dtype", "wire", "mode"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


class _Wedge:
    """Makes ``pipe.push`` block, once, on the first push that ``hit``
    selects, until ``release`` is set."""

    def __init__(self, pipe, hit):
        self.release = threading.Event()
        self.entered = threading.Event()
        real = pipe.push

        def push(xs, n_real=None, **kw):
            if not self.entered.is_set() and hit(xs, n_real):
                self.entered.set()
                self.release.wait()
            return real(xs, n_real=n_real, **kw)

        pipe.push = push


def _holds(xs, n_real, x) -> bool:
    """The pushed block holds input ``x`` among its real entries."""
    return isinstance(xs, np.ndarray) and any(
        np.array_equal(xs[j], x) for j in range(n_real or 0))


def test_watchdog_recovery_replays_unemitted(tiny):
    """A dispatch wedges mid-stream; the watchdog rebuilds the pipeline,
    replays the fed-but-unemitted microbatches, and the output queue
    completes with no gap, in order, equal to the forward."""
    tg, params, ref = tiny
    d = _cpu(microbatch=1, chunk=2, watchdog_s=2.0, gather_timeout_s=0.01)
    xs = _xs(8, 7)
    in_q, out_q = queue.Queue(), queue.Queue()
    cursor = recorder().cursor()
    h = d.run_defer(tg, params, None, in_q, out_q, num_stages=2)
    first = h.pipeline
    wedge = _Wedge(first, lambda b, n: _holds(b, n, xs[3]))
    try:
        for x in xs:
            in_q.put(x)
        in_q.put(END_OF_STREAM)
        outs = _drain(out_q, 8, h)
        assert wedge.entered.is_set()
        assert h.healthy and h.recoveries == 1
        assert h.pipeline is not first  # a fresh engine, same weights
        np.testing.assert_allclose(np.stack(outs), ref(xs), rtol=2e-4,
                                   atol=2e-4)
        h.join(timeout=WAIT_S)
        assert out_q.empty()
        _, evs = recorder().events_since(cursor)
        kinds = [e["kind"] for e in evs]
        assert kinds.count("watchdog") == 1 and kinds.count("failover") == 1
        fo = next(e for e in evs if e["kind"] == "failover")
        assert fo["data"]["hop"] == "dispatcher"
        assert fo["data"]["replayed"] >= 1
        for e in evs:
            validate_event(e)
    finally:
        h.stop()
        wedge.release.set()  # let the abandoned generation's thread exit


def test_watchdog_recovery_after_end_consumed(tiny):
    """A wedge in the final drain — AFTER the caller's END_OF_STREAM was
    consumed — still recovers: the new generation replays, flushes and
    completes the stream without waiting for a second END."""
    tg, params, ref = tiny
    d = _cpu(microbatch=1, chunk=2, watchdog_s=2.0, gather_timeout_s=0.01)
    xs = _xs(4, 13)
    in_q, out_q = queue.Queue(), queue.Queue()
    h = d.run_defer(tg, params, None, in_q, out_q, num_stages=2)
    last_fed = threading.Event()

    def hit(block, n_real):
        if _holds(block, n_real, xs[-1]):
            last_fed.set()
            return False
        return last_fed.is_set() and n_real == 0  # the flush's first push

    wedge = _Wedge(h.pipeline, hit)
    try:
        for x in xs:
            in_q.put(x)
        in_q.put(END_OF_STREAM)
        outs = _drain(out_q, 4, h)
        assert wedge.entered.is_set() and h._end_seen
        assert h.healthy and h.recoveries == 1
        np.testing.assert_allclose(np.stack(outs), ref(xs), rtol=2e-4,
                                   atol=2e-4)
        h.join(timeout=WAIT_S)
    finally:
        h.stop()
        wedge.release.set()


def test_join_raises_immediately_when_error_set():
    """join() re-raises a recorded error even while the serve thread is
    wedged for good (it polls, never blocks forever)."""
    release = threading.Event()
    th = threading.Thread(target=release.wait, daemon=True)
    th.start()
    try:
        h = DeferHandle(th, None, threading.Event())
        h.error = TimeoutError("deployment declared dead")
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="dispatcher thread failed"):
            h.join()
        assert time.monotonic() - t0 < 5
    finally:
        release.set()


def test_preflight_surfaces_failure_without_input(tiny):
    """With preflight on, a deployment whose stages cannot run reports its
    error and unblocks readers before any input is enqueued."""
    tg, params, _ = tiny
    # every leaf one wider than the graph wants: the build packs the rows,
    # the stages fail when they first run
    bad = tree_map(lambda v: torch.zeros(v.shape[:-1] + (v.shape[-1] + 1,))
                   if v.dim() else v, params)
    in_q, out_q = queue.Queue(), queue.Queue()
    h = _cpu(microbatch=1, chunk=2).run_defer(tg, bad, None, in_q, out_q,
                                              num_stages=2)
    assert out_q.get(timeout=WAIT_S) is END_OF_STREAM
    assert not h.healthy


# ---------------------------------------------------------------------------
# ReplayBuffer (tests/test_replay.py) and the events schema
# ---------------------------------------------------------------------------

def test_replay_buffer_retain_ack_release():
    b = ReplayBuffer(8)
    for s in range(5):
        b.retain(s, f"f{s}")
    assert b.depth() == 5 and b.hi == 5
    assert b.unacked() == [(s, f"f{s}") for s in range(5)]
    b.ack(3)  # cumulative: 0..2 released
    assert b.depth() == 2
    assert [s for s, _ in b.unacked()] == [3, 4]
    b.ack(1)  # stale ack: no-op
    assert b.depth() == 2 and b.acked == 3
    b.retain(2, "late")  # already-acked seq: no-op
    assert b.depth() == 2
    with pytest.raises(ValueError, match="capacity"):
        ReplayBuffer(0)


def test_replay_buffer_full_window_blocks_until_ack():
    b = ReplayBuffer(2, gauge="test.replay_depth")
    b.retain(0, "a")
    b.retain(1, "b")
    assert REGISTRY.snapshot()["test.replay_depth"] == 2
    started = threading.Event()
    done = threading.Event()

    def producer():
        started.set()
        b.retain(2, "c", timeout=60.0)
        done.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    started.wait(WAIT_S)
    assert not done.wait(0.2), "a full window must hold the producer"
    b.ack(1)
    t.join(timeout=WAIT_S)
    assert done.is_set() and not t.is_alive()
    assert REGISTRY.gauge("test.replay_depth").value == 2
    with pytest.raises(TimeoutError, match="replay window full"):
        b.retain(3, "d", timeout=0.1)


def test_replay_buffer_fail_wakes_parked_producer():
    b = ReplayBuffer(1)
    b.retain(0, "a")
    errs: list = []

    def producer():
        try:
            b.retain(1, "b", timeout=60.0)
        except ConnectionError as e:
            errs.append(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    b.fail(ConnectionError("replica gone"))  # parked or not, it raises
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert errs and isinstance(errs[0], ConnectionError)


def test_flight_recorder_schema_and_merge():
    r = FlightRecorder(process="a", capacity=3)
    with pytest.raises(ValueError, match="unknown event kind"):
        r.emit("no_such_kind")
    evs = [r.emit("watchdog", action="recover", gen=i) for i in range(5)]
    assert [e["seq"] for e in evs] == list(range(5))
    assert r.dropped == 2 and [e["seq"] for e in r.snapshot()] == [2, 3, 4]
    for e in evs:
        assert validate_event(e) is e and e["kind"] in EVENT_KINDS
    # paging: the oldest first, the cursor stops after them
    cur, page = r.events_since(0, limit=2)
    assert [e["seq"] for e in page] == [2, 3] and cur == 4
    cur, page = r.events_since(cur)
    assert [e["seq"] for e in page] == [4] and cur == r.cursor() == 5
    assert [e["t_us"] for e in evs] == sorted(e["t_us"] for e in evs)
    for bad in ({}, dict(evs[0], seq=-1), dict(evs[0], t_us=1.5),
                dict(evs[0], kind="nope"), dict(evs[0], data=[]),
                dict(evs[0], extra=1)):
        with pytest.raises(ValueError):
            validate_event(bad)
    other = FlightRecorder(process="b")
    eb = other.emit("failover", hop="dispatcher", chan=1, addr="x",
                    replayed=0, recovery_ms=0.0)
    merged = merge_events(r.snapshot(), [eb], r.snapshot())
    assert len(merged) == 4  # duplicates of one (proc, seq) collapse
    assert merged == sorted(merged, key=lambda e: (e["t_us"], e["proc"],
                                                   e["seq"]))
    assert r.drain() and r.snapshot() == [] and r.cursor() == 5
