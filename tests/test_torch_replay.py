"""Port parity: the seq-replay substrate (``defer_tpu_torch.transport.
replay``) — the retain-until-ack window, the replay-tolerant fan-in
dedup, channel healing over real sockets, and a replica's failover in a
chain — mirroring the transport scenarios of ``tests/test_replay.py``
(``:48-312``) and its ``kill -9`` test.

The correctness claim is byte-identity: a stream that crosses a failover
equals the undisturbed stream bit for bit, with no dropped, duplicated or
reordered frame.  The packages meet on the ack plane too: the port's and
the JAX package's merges dedup the same random replay overlaps alike, each
package's ``ReplayFanOut`` heals against a replica that speaks the other's
frames, and a chain fails over across packages in both directions (a port
fan-out into a JAX fan-in, a JAX fan-out into a port fan-in, with a JAX and
a port replica between them).

Tolerances, with their reasons:

* a stream across a failover against the undisturbed stream of the same
  nodes: equal (the same programs on the same frames);
* a port chain against the JAX forward: 1e-5 of max |output| (resnet_tiny
  in f32; the convolutions sum in another order than XLA's);
* rows that crossed a JAX node against the JAX forward: rtol 2e-4 (atol
  2e-4), the JAX chain tests' own bound.

Every socket test binds ``127.0.0.1:0``, joins its threads with a bound
and carries its own time limit.
"""

import os
import queue
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from defer_tpu import partition as jax_partition
from defer_tpu.models import resnet_tiny as jax_resnet_tiny
from defer_tpu.obs.events import recorder as jax_recorder
from defer_tpu.runtime import node as jnode
from defer_tpu.transport import framed as jf
from defer_tpu.transport import replay as jreplay
from defer_tpu.transport import replicate as jr
from defer_tpu.utils import export as jexport
from defer_tpu_torch import models, params_from_jax, partition
from defer_tpu_torch.obs.events import recorder
from defer_tpu_torch.runtime import node as tnode
from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode
from defer_tpu_torch.transport import framed as tframed
from defer_tpu_torch.transport.framed import (K_CTRL, K_END, recv_frame,
                                              send_ctrl, send_end)
from defer_tpu_torch.transport.replay import ReplayBuffer, ReplayFanOut
from defer_tpu_torch.transport.replicate import FanInMerge
from defer_tpu_torch.utils import export as texport

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
REL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    jg = jax_resnet_tiny()
    jp = jg.init(jax.random.key(0))
    g = models.resnet_tiny()
    p = params_from_jax(g, jax.tree.map(np.asarray, jp))
    return jg, jp, g, p


def _stages(tiny, n):
    """Both packages' stages at the same cuts: (JAX stages, port stages)."""
    jg, _, g, _ = tiny
    jstages = jax_partition(jg, num_stages=n)
    return jstages, partition(g, [s.output_name for s in jstages[:-1]])


# ---------------------------------------------------------------------------
# ReplayBuffer: the bounded retain-until-ack window
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
    b.ack(1)  # a stale ack is a no-op (acks race across R relay paths)
    assert b.depth() == 2 and b.acked == 3
    b.retain(2, "late")  # an already-acked seq: no-op
    assert b.depth() == 2


@pytest.mark.timeout(60)
def test_replay_buffer_full_window_blocks_until_ack():
    b = ReplayBuffer(2)
    b.retain(0, "a")
    b.retain(1, "b")
    parked = threading.Event()
    done = threading.Event()

    def producer():
        parked.set()
        b.retain(2, "c", timeout=30.0)
        done.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    parked.wait(5.0)
    time.sleep(0.2)
    assert not done.is_set(), "a full window must backpressure the sender"
    b.ack(1)
    t.join(timeout=10)
    assert done.is_set()
    with pytest.raises(TimeoutError, match="replay window full"):
        b.retain(3, "d", timeout=0.1)


@pytest.mark.timeout(60)
def test_replay_buffer_fail_wakes_parked_producer():
    b = ReplayBuffer(1)
    b.retain(0, "a")
    errs: list = []

    def producer():
        try:
            b.retain(1, "b", timeout=30.0)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.1)
    b.fail(ConnectionError("replica gone"))
    t.join(timeout=10)
    assert errs and isinstance(errs[0], ConnectionError)


# ---------------------------------------------------------------------------
# FanInMerge under replay: dedup inside the window
# ---------------------------------------------------------------------------

def test_merge_dedups_replay_overlap_inside_window():
    """A healed fan-out replays frames its acks had not covered; the merge
    absorbs the overlap and the released stream is untouched."""
    m = FanInMerge(1, capacity=8, replay_window=4)
    for s in range(4):
        m.put(s, f"v{s}")
    got = [m.get(1.0)[1] for _ in range(4)]
    m.put(2, "v2")
    m.put(3, "v3")
    m.put(4, "v4")
    assert m.get(1.0)[1] == "v4"
    assert got == ["v0", "v1", "v2", "v3"]
    assert m.duplicates == 2


def test_merge_replay_window_still_rejects_ancient_seqs():
    """The window is a tolerance, not amnesia: a seq older than the window
    behind the head is a protocol violation."""
    m = FanInMerge(1, capacity=8, replay_window=2)
    for s in range(5):
        m.put(s, s)
        m.get(1.0)
    m.put(3, 3)  # inside the window: absorbed
    assert m.duplicates == 1
    with pytest.raises(ValueError, match="duplicate/stale"):
        m.put(0, 0)  # 0 < next(5) - window(2)


def test_merge_strict_mode_unchanged_without_window():
    m = FanInMerge(1, capacity=8)
    m.put(0, "a")
    m.get(1.0)
    with pytest.raises(ValueError, match="duplicate/stale"):
        m.put(0, "a")


def _drain(m, out: list) -> bool:
    """Move every frame ``m`` releases now into ``out``; True at END."""
    while True:
        try:
            kind, v = m.get_nowait()
        except queue.Empty:
            return False
        if kind == K_END:
            return True
        out.append(v)


def _put(m, seq) -> str:
    """Put ``seq`` into ``m``: "ok", or "stale" where the merge refuses it
    as older than its replay window."""
    try:
        m.put(seq, seq)
        return "ok"
    except ValueError as e:
        assert "duplicate/stale" in str(e)
        return "stale"


@pytest.mark.timeout(60)
def test_merge_dedup_property_random_replay_overlaps():
    """For random streams with random replay overlaps (any slice of the
    trailing window, re-put at any point) the released stream is exactly
    0..N-1 in order and every overlap frame counts as a duplicate.  The
    JAX package's merge, fed the same puts beside the port's, and with
    overlaps that reach up to two frames past the window, releases the
    same frames at the same points, refuses the same ancient seqs and
    counts the same duplicates."""
    rng = np.random.default_rng(42)
    stale = 0
    for trial in range(25):
        window = int(rng.integers(1, 9))
        n = int(rng.integers(10, 50))
        merges = [FanInMerge(1, capacity=64, replay_window=window),
                  jr.FanInMerge(1, capacity=64, replay_window=window)]
        outs: list = [[], []]
        dups = 0
        for s in range(n):
            for m, out in zip(merges, outs):
                assert _put(m, s) == "ok"
                assert not _drain(m, out)
            if rng.random() < 0.35:
                lo = max(0, s + 1 - window - 2)
                start = int(rng.integers(lo, s + 1))
                for r in range(start, s + 1):
                    got = [_put(m, r) for m in merges]
                    assert got[0] == got[1], \
                        f"trial {trial}: seq {r} {got} (port, jax)"
                    assert got[0] == "stale" or r >= s + 1 - window
                    dups += got[0] == "ok"
                    stale += got[0] == "stale"
            for m, out in zip(merges, outs):
                assert not _drain(m, out)
            assert outs[0] == outs[1], f"trial {trial}: the merges diverge"
        for m, out in zip(merges, outs):
            m.end()
            assert _drain(m, out)
        assert outs[0] == outs[1] == list(range(n)), \
            f"trial {trial} (window={window})"
        assert merges[0].duplicates == merges[1].duplicates == dups, \
            f"trial {trial}"
    assert stale, "no overlap reached past the window"


# ---------------------------------------------------------------------------
# ReplayFanOut: heal over real sockets
# ---------------------------------------------------------------------------

def _replica_reader(conn, frames: list, stop_after: int | None = None,
                    fr=tframed):
    """A minimal fan-in stand-in speaking ``fr``'s frames (the port's or
    the JAX package's ``framed``): record seq-stamped frames; on END play
    the clean-shutdown half of the ack protocol (a final cumulative ack
    and ``replay_done``); with ``stop_after``, stop early (the caller
    closes the socket to simulate death)."""
    try:
        while True:
            kind, value = fr.recv_frame(conn)
            if kind == K_END:
                if frames:
                    hi = max(int(seq) for seq, _ in frames) + 1
                    fr.send_ctrl(conn, {"cmd": "replay_ack", "seq": hi})
                fr.send_ctrl(conn, {"cmd": "replay_done"})
                return
            if kind == K_CTRL:
                continue
            frames.append(value)
            if stop_after is not None and len(frames) >= stop_after:
                return
    except (OSError, ConnectionError):
        pass


#: (fan-out, replica stand-in): the port's ReplayFanOut against the port's
#: frames and the JAX package's, and the JAX package's against the port's
HEAL_PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


@pytest.mark.timeout(90)
@pytest.mark.parametrize("fan_out,replica", HEAL_PAIRS)
def test_fanout_heals_dead_channel_and_replays_unacked(fan_out, replica):
    """A one-channel fan-out against a replica that acks part of its
    window and dies: the heal redials the same address, resends the
    preamble, replays exactly the unacked frames, and later sends go on
    on the new connection.  Across packages, the acks, ``replay_done`` and
    the replayed frames are the same bytes: either package's fan-out heals
    against a replica that speaks the other's frames."""
    fan_cls, rec = ((ReplayFanOut, recorder) if fan_out == "port"
                    else (jreplay.ReplayFanOut, jax_recorder))
    fr = tframed if replica == "port" else jf
    srv = socket.create_server(("127.0.0.1", 0))
    srv.settimeout(30.0)
    port = srv.getsockname()[1]
    s = socket.create_connection(("127.0.0.1", port), timeout=10.0)
    conn1, _ = srv.accept()
    fo = fan_cls([s], [("127.0.0.1", port)], window=64,
                  redial_timeout_s=15.0, replay_gauge=None)
    second: list = []
    accepted2 = threading.Event()

    def acceptor2():
        conn2, _ = srv.accept()
        accepted2.set()
        _replica_reader(conn2, second, fr=fr)
        conn2.close()

    t2 = threading.Thread(target=acceptor2, daemon=True)
    try:
        fo.send_ctrl({"cmd": "stream_begin", "stage": 0})
        xs = [np.full((2,), i, np.float32) for i in range(10)]
        for x in xs[:4]:
            fo.send(x)
        fo.flush(timeout=10.0)
        first: list = []
        rt = threading.Thread(target=_replica_reader,
                              args=(conn1, first, 4, fr), daemon=True)
        rt.start()
        rt.join(timeout=10)
        assert len(first) == 4
        # ack frames 0, 1, then die without replay_done
        fr.send_ctrl(conn1, {"cmd": "replay_ack", "seq": 2})
        deadline = time.monotonic() + 10
        while fo.replay_depth() > 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fo.replay_depth() == 2
        t2.start()
        conn1.close()  # the replica's death: EOF on the ack reader
        assert accepted2.wait(20.0), "the heal never redialed"
        for x in xs[4:]:
            fo.send(x)
        fo.send_end()
        fo.close(timeout=15.0)
        t2.join(timeout=10.0)
        assert not t2.is_alive(), "the replica reader never saw END"
        assert fo.failovers == 1
        # the new connection saw the replayed window (2, 3), then the rest,
        # with their original seqs.  The wire may carry one duplicate of
        # the first frame after the heal (a send that detects the death
        # has already retained its frame, which the heal replays and the
        # send's retry sends again): dedup as the merge does
        seqs = [int(seq) for seq, _ in second]
        deduped: list = []
        for q in seqs:
            if deduped and q == deduped[-1]:
                continue
            assert not deduped or q > deduped[-1], f"out of order: {seqs}"
            deduped.append(q)
        assert deduped == [2, 3] + list(range(4, 10))
        for seq, arr in second:
            np.testing.assert_array_equal(arr, xs[int(seq)])
        evs = [e for e in rec().snapshot()
               if e["kind"] == "failover"
               and e["data"].get("addr") == f"127.0.0.1:{port}"]
        assert evs and evs[-1]["data"]["replayed"] in (2, 3)
        assert evs[-1]["data"]["recovery_ms"] > 0
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# a replica's failover in a chain of in-process nodes
# ---------------------------------------------------------------------------

def _kill_node(node) -> None:
    """A node's death as its peers see it: the listener stops, and its
    data connections reach EOF both ways (the serve thread then fails)."""
    node._srv.shutdown(socket.SHUT_RDWR)
    for ch in (node._live_rx, node._live_tx):
        sock = getattr(ch, "_sock", None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def _inputs(seed: int, m: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
            for _ in range(m)]


#: the item the dispatcher draws only after 4 results (its window is 4):
#: replica 1 of stage 1 dies there
KILL_AT = 8


class _Chain:
    """Nodes served on threads, the dispatcher's stream through them, and
    (with ``kill``) the death of ``victim`` at item KILL_AT and its
    replacement from ``respawn()``, bound on its port as the supervisor's
    respawn would be."""

    def __init__(self, nodes, first: str, **disp_kw):
        self.nodes = nodes
        self.errs: list = []
        self.fresh: list = []
        self.threads = [threading.Thread(target=self._serve, args=(n,),
                                         daemon=True) for n in nodes]
        for t in self.threads:
            t.start()
        self.disp = ChainDispatcher(first, window=4, **disp_kw)

    def _serve(self, node) -> None:
        try:
            node.serve()
        except BaseException as e:  # noqa: BLE001 — the killed replica's
            self.errs.append((node, e))

    def _respawn(self, respawn) -> None:
        deadline = time.monotonic() + 20
        while True:
            # the port frees once the dead node's serve loop closes it
            try:
                node = respawn()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self.fresh.append(node)
        self._serve(node)

    def inputs(self, xs, victim=None, respawn=None):
        for i, x in enumerate(xs):
            if i == KILL_AT and victim is not None:
                _kill_node(victim)
                self.killed_at = time.monotonic()
                t = threading.Thread(target=self._respawn, args=(respawn,),
                                     daemon=True)
                t.start()
                self.threads.append(t)
            yield x

    def join(self) -> None:
        for t in self.threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in self.threads)


def _addr(node) -> str:
    return f"127.0.0.1:{node.address[1]}"


@pytest.mark.timeout(180)
def test_replica_failover_in_process_is_byte_identical(tiny, tmp_path,
                                                       monkeypatch):
    """resnet_tiny in three stages, stage 1 twice, every node under
    ``failover``: once 4 results have arrived, replica 1's sockets are
    shut (its death), and a fresh node on the same port, booted from the
    artifact as the supervisor would, takes its place.  The stream equals
    the undisturbed one byte for byte and lies within 1e-5 of max |output|
    of the JAX forward; stage 0 reports ``failovers == 1`` with a
    ``failover`` event, and the fan-in counts the replayed frames it had
    merged already.  Acks go out only at the end here, so every frame
    replica 1 relayed before its death is replayed."""
    monkeypatch.setattr(tnode, "ACK_EVERY", 1 << 20)
    jg, jp, g, p = tiny
    _, stages = _stages(tiny, 3)
    xs = _inputs(3, 16)
    with torch.inference_mode():
        ref = [g.apply(p, torch.from_numpy(x)).numpy() for x in xs]
    path1 = str(tmp_path / "stage1.zip")
    texport.export_stage(stages[1], p, path1, batch=1)

    def boot(**kw):
        return StageNode(None, "127.0.0.1:0", None, device="cpu",
                         failover=True, **kw)

    n0 = boot()
    reps = [boot(replica=j, infer_delay_s=0.02) for j in range(2)]
    n2 = boot(fan_in=2)
    nodes = [n0] + reps + [n2]
    addrs = [_addr(n) for n in nodes]
    ch = _Chain(nodes, addrs[0])
    try:
        ch.disp.deploy(stages, p, [addrs[0], addrs[1:3], addrs[3]], batch=1)
        outs = ch.disp.stream(ch.inputs(xs, reps[1], lambda: StageNode(
            path1, addrs[2], addrs[3], device="cpu", replica=1,
            failover=True)))
        st = ch.disp.stats([addrs[0], addrs[3]])
    finally:
        ch.disp.close()
    ch.join()
    assert len(outs) == len(xs)
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)
    fwd = jax.jit(jg.apply)
    for x, y in zip(xs, outs):
        want = np.asarray(fwd(jp, x))
        assert np.abs(y - want).max() <= REL * np.abs(want).max()
    assert st[0]["failovers"] == 1
    assert st[1]["merge_duplicates"] >= 2
    assert [e[0] for e in ch.errs] == [reps[1]]
    assert ch.fresh and ch.fresh[0].processed > 0
    evs = [e for e in recorder().snapshot() if e["kind"] == "failover"
           and e["data"].get("addr") == addrs[2]]
    assert len(evs) == 1 and evs[0]["data"]["replayed"] >= 2
    assert any(e["kind"] == "replica_lost" for e in recorder().snapshot())


@pytest.fixture(scope="module")
def artifacts(tiny, tmp_path_factory):
    """resnet_tiny's three stages exported by both packages (batch 1)."""
    jg, jp, g, p = tiny
    jstages, stages = _stages(tiny, 3)
    d = tmp_path_factory.mktemp("mixed")
    out = {"port": [], "jax": []}
    for k in range(3):
        out["port"].append(str(d / f"t{k}.zip"))
        texport.export_stage(stages[k], p, out["port"][-1], batch=1)
        out["jax"].append(str(d / f"j{k}.zip"))
        jexport.export_stage(jstages[k], jp, out["jax"][-1], batch=1)
    return out


def _mixed_chain(art, fan_out: str, xs, kill: bool):
    """Stage 0 of package ``fan_out`` fans out under failover to a JAX
    replica 0 and a port replica 1 of stage 1, merged by a stage 2 of the
    other package; with ``kill``, the port replica dies at item KILL_AT
    and a fresh port node takes its port.  The stream, stage 0's and the
    fan-in's stats, and the chain."""
    pkgs = {"port": lambda path, listen, nxt, **kw: StageNode(
        path, listen, nxt, device="cpu", failover=True, **kw),
        "jax": lambda path, listen, nxt, **kw: jnode.StageNode(
            path, listen, nxt, failover=True, **kw)}
    fan_in = "jax" if fan_out == "port" else "port"
    res = f"127.0.0.1:{tnode._free_ports(1)[0]}"
    n2 = pkgs[fan_in](art[fan_in][2], "127.0.0.1:0", res, fan_in=2)
    r0 = pkgs["jax"](art["jax"][1], "127.0.0.1:0", _addr(n2), replica=0)
    r1 = pkgs["port"](art["port"][1], "127.0.0.1:0", _addr(n2), replica=1,
                      infer_delay_s=0.02)
    n0 = pkgs[fan_out](art[fan_out][0], "127.0.0.1:0",
                       f"{_addr(r0)},{_addr(r1)}")
    ch = _Chain([n0, r0, r1, n2], _addr(n0), listen=res)
    try:
        outs = [np.asarray(y) for y in ch.disp.stream(ch.inputs(
            xs, r1 if kill else None, lambda: pkgs["port"](
                art["port"][1], _addr(r1), _addr(n2), replica=1)))]
        st = ch.disp.stats([_addr(n0), _addr(n2)])
    finally:
        ch.disp.close()
    ch.join()
    return outs, st, ch


@pytest.mark.timeout(240)
@pytest.mark.parametrize("fan_out", ["port", "jax"])
def test_failover_across_packages_is_byte_identical(tiny, artifacts,
                                                    fan_out, monkeypatch):
    """A failover that crosses the packages: a port fan-out into a JAX
    fan-in, and a JAX fan-out into a port fan-in, with a JAX and a port
    replica between them.  The port replica dies after 4 results and a
    fresh port node takes its port: the replica relays the other
    package's acks, the fan-out heals and replays, the fan-in drops what it
    had merged already.  The stream equals the same nodes' undisturbed
    stream byte for byte and the JAX forward within the JAX chain tests'
    bound; stage 0 reports ``failovers == 1`` and one ``failover`` event in
    its package's recorder, and the fan-in counts the duplicates.  Acks
    go out only at the end, so the dead replica's every frame is
    replayed."""
    monkeypatch.setattr(tnode, "ACK_EVERY", 1 << 20)
    monkeypatch.setattr(jnode, "ACK_EVERY", 1 << 20)
    jg, jp, _, _ = tiny
    xs = _inputs(5, 16)
    base, _, _ = _mixed_chain(artifacts, fan_out, xs, kill=False)
    outs, st, ch = _mixed_chain(artifacts, fan_out, xs, kill=True)
    assert len(base) == len(outs) == len(xs)
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b)
    fwd = jax.jit(jg.apply)
    for x, y in zip(xs, outs):
        np.testing.assert_allclose(y, np.asarray(fwd(jp, x)), rtol=TOL,
                                   atol=TOL)
    assert st[0]["failovers"] == 1
    assert st[1]["merge_duplicates"] >= 2
    assert [e[0] for e in ch.errs] == [ch.nodes[2]]
    assert ch.fresh and ch.fresh[0].processed > 0
    rec = recorder if fan_out == "port" else jax_recorder
    evs = [e for e in rec().snapshot() if e["kind"] == "failover"
           and e["data"].get("addr") == _addr(ch.nodes[2])]
    assert len(evs) == 1 and evs[0]["data"]["replayed"] >= 2


@pytest.mark.timeout(120)
def test_respawn_whose_load_hangs_fails_the_stream_at_the_grace(
        tiny, tmp_path, monkeypatch):
    """A node binds, then loads its artifact, then serves, as the JAX
    node does, so the fan-in's grace bounds a respawn's whole boot: a
    replacement that binds in time but whose load hangs takes the heal's
    redial yet never registers with the fan-in, and the stream fails at
    the fan-in's ``failover_grace_s``, long before the dispatcher's own
    timeout."""
    grace, timeout = 2.0, 90.0
    _, stages = _stages(tiny, 3)
    p = tiny[3]
    path1 = str(tmp_path / "stage1.zip")
    texport.export_stage(stages[1], p, path1, batch=1)
    gate = threading.Event()
    real = texport.load_stage_program

    def held(*a, **kw):
        gate.wait(60)
        return real(*a, **kw)

    def respawn():
        monkeypatch.setattr(texport, "load_stage_program", held)
        return StageNode(path1, _addr(reps[1]), _addr(n2), device="cpu",
                         replica=1, failover=True)

    def boot(**kw):
        return StageNode(None, "127.0.0.1:0", None, device="cpu",
                         failover=True, **kw)

    n0 = boot()
    reps = [boot(replica=j, infer_delay_s=0.02) for j in range(2)]
    n2 = boot(fan_in=2, failover_grace_s=grace)
    nodes = [n0] + reps + [n2]
    ch = _Chain(nodes, _addr(n0), timeout_s=timeout)
    try:
        ch.disp.deploy(stages, p, [_addr(n0), [_addr(r) for r in reps],
                                   _addr(n2)], batch=1)
        with pytest.raises((ConnectionError, OSError, RuntimeError)):
            ch.disp.stream(ch.inputs(_inputs(7, 16), reps[1], respawn))
        failed_after = time.monotonic() - ch.killed_at
        held_at_failure = not gate.is_set()
    finally:
        ch.disp.close()
        for node in (n0, reps[0], n2):
            _kill_node(node)
        gate.set()
        deadline = time.monotonic() + 30
        while not ch.fresh and time.monotonic() < deadline:
            time.sleep(0.05)
        for node in ch.fresh:
            _kill_node(node)
    ch.join()
    assert held_at_failure
    assert grace <= failed_after < grace + 15 < timeout
    assert any(node is n2 for node, _ in ch.errs)
    # the respawn had bound: stage 0's heal redialed it and replayed
    evs = [e for e in recorder().snapshot() if e["kind"] == "failover"
           and e["data"].get("addr") == _addr(reps[1])]
    assert len(evs) == 1


# ---------------------------------------------------------------------------
# kill -9 failover, a full multi-process chain (slow)
# ---------------------------------------------------------------------------

_KILL_SCRIPT = r"""
import signal, sys, threading, time
import numpy as np, torch
from defer_tpu_torch import models, partition
from defer_tpu_torch.runtime.node import run_chain

g = models.resnet_tiny()
params = g.init(torch.Generator().manual_seed(0))
stages = partition(g, num_stages=3)
rng = np.random.default_rng(0)
xs = [rng.standard_normal((1,) + tuple(stages[0].in_spec.shape))
      .astype(np.float32) for _ in range(16)]
started = threading.Event()

def feeder():
    for i, x in enumerate(xs):
        if i == 6:
            started.set()
        yield x

def on_spawn(procs):
    def killer():
        started.wait(180)
        time.sleep(0.3)
        procs[1].send_signal(signal.SIGKILL)  # stage 1, replica 0
    threading.Thread(target=killer, daemon=True).start()

outs = run_chain(stages, params, feeder(), batch=1, replicas={1: 2},
                 failover=True, on_spawn=on_spawn, device="cpu",
                 artifact_dir=sys.argv[1], stage_delays=[0.0, 0.4, 0.0])
ref = run_chain(stages, params, list(xs), batch=1, device="cpu",
                artifact_dir=sys.argv[1])
assert len(outs) == len(ref) == len(xs), (len(outs), len(ref))
for a, b in zip(outs, ref):
    np.testing.assert_array_equal(a, b)
print("BYTE-IDENTICAL", len(outs))
"""


@pytest.mark.slow
@pytest.mark.timeout(700)
def test_kill9_replica_failover_byte_identical(tmp_path):
    """``kill -9`` of a mid-chain replica while the stream is in flight:
    the supervisor respawns it, the fan-out heals and replays, and the
    output equals the undisturbed run byte for byte."""
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "BYTE-IDENTICAL 16" in proc.stdout
