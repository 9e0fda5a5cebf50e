"""Port parity: the branch fan-out and join (``defer_tpu_torch.transport.
branch``), mirroring ``tests/test_branch_transport.py`` scenario for
scenario on the port's classes: the ``(path, seq)`` reorder buffer's
ordering, duplicate/stale/END-gap edges, backpressure liveness and
failure propagation.

Beyond the mirror, the packages meet twice: the same random sequences of
``BranchJoin`` calls go to both packages' joins and every release,
refusal and error must be equal; and a port ``BroadcastSender`` feeds a
JAX ``BranchJoin`` over real sockets (and a JAX sender a port join), the
frames decoded by the other package's ``recv_frame``.  Every socket test
binds ``127.0.0.1:0`` and carries its own time limit.
"""

import queue
import socket
import threading
import time

import numpy as np
import pytest

from defer_tpu.transport import branch as jbranch
from defer_tpu.transport import framed as jframed
from defer_tpu_torch.transport import branch as tbranch
from defer_tpu_torch.transport import framed as tframed
from defer_tpu_torch.transport.branch import BranchJoin, BroadcastSender
from defer_tpu_torch.transport.framed import K_CTRL, K_END, K_TENSOR_SEQ


def drain(j, timeout=5.0):
    out = []
    while True:
        kind, value = j.get(timeout=timeout)
        out.append((kind, value))
        if kind == K_END:
            return out


def test_join_orders_across_racing_paths():
    j = BranchJoin(3)
    n = 20

    def feeder(path, order):
        j.attach(path)
        for seq in order:
            j.put(path, seq, (path, seq))
        j.end(path)

    orders = [list(range(n)), list(range(n))[::-1],
              sorted(range(n), key=lambda s: s % 4)]
    # path 0 in order, path 1 reversed, path 2 shuffled: the consumer
    # still sees 0..n-1 strictly in order, parts in path order
    threads = [threading.Thread(target=feeder, args=(p, o))
               for p, o in enumerate(orders)]
    for t in threads:
        t.start()
    items = drain(j)
    for t in threads:
        t.join()
    tensors = [v for k, v in items if k == K_TENSOR_SEQ]
    assert [s for s, _ in tensors] == list(range(n))
    for s, parts in tensors:
        assert parts == [(0, s), (1, s), (2, s)]
    assert items[-1] == (K_END, None)


def test_join_duplicate_and_stale_raise():
    j = BranchJoin(2)
    j.attach(0)
    j.attach(1)
    j.put(0, 0, "a")
    with pytest.raises(ValueError, match="duplicate"):
        j.put(0, 0, "again")
    j.put(1, 0, "b")
    assert j.get() == (K_TENSOR_SEQ, (0, ["a", "b"]))
    with pytest.raises(ValueError, match="stale"):
        j.put(0, 0, "late")


def test_join_end_gap_raises():
    """All paths ended but a seq misses a part: the error names the
    missing (seq, paths) instead of truncating the stream."""
    j = BranchJoin(2)
    j.attach(0)
    j.attach(1)
    j.put(0, 0, "a")
    j.end(0)
    j.end(1)      # path 1 never delivered seq 0
    with pytest.raises(ConnectionError, match="missing"):
        j.get(timeout=1.0)


def test_join_double_end_and_double_attach_raise():
    j = BranchJoin(2)
    j.attach(0)
    with pytest.raises(ConnectionError, match="claimed"):
        j.attach(0)
    j.attach(1)
    j.end(0)
    j.end(0)      # poisoned: surfaced at the consumer
    with pytest.raises(ConnectionError, match="two END"):
        j.get(timeout=1.0)


def test_join_path_range_checked():
    j = BranchJoin(2)
    with pytest.raises(ValueError, match="out of range"):
        j.attach(2)
    with pytest.raises(ValueError, match="out of range"):
        j.put(5, 0, "x")
    with pytest.raises(ValueError):
        BranchJoin(1)
    with pytest.raises(ValueError, match="capacity"):
        BranchJoin(2, capacity=1)


def test_join_backpressure_liveness():
    """A full buffer parks depositors except for frames landing in an
    existing slot or opening the consumer's next needed seq."""
    j = BranchJoin(2, capacity=2)
    j.attach(0)
    j.attach(1)
    j.put(0, 1, "b1")
    j.put(0, 2, "b2")          # two distinct seqs buffered: full
    with pytest.raises(TimeoutError, match="full"):
        j.put(0, 3, "b3", timeout=0.2)
    j.put(1, 1, "c1")          # existing slot: admitted while full
    j.put(1, 0, "c0")          # opens seq 0, the next needed: admitted
    j.put(0, 0, "b0")
    assert j.get(timeout=1.0) == (K_TENSOR_SEQ, (0, ["b0", "c0"]))
    assert j.get(timeout=1.0) == (K_TENSOR_SEQ, (1, ["b1", "c1"]))


def test_join_parked_depositor_wakes_when_the_consumer_drains():
    """A reader parked on a full buffer is admitted once the consumer
    releases a sequence (the wake-up the node's join relies on)."""
    j = BranchJoin(2, capacity=2)
    for p in (0, 1):
        j.attach(p)
    j.put(0, 1, "b1")
    j.put(0, 2, "b2")
    done = threading.Event()

    def parked():
        j.put(0, 3, "b3", timeout=5.0)
        done.set()

    t = threading.Thread(target=parked, daemon=True)
    t.start()
    time.sleep(0.1)
    assert not done.is_set()
    j.put(0, 0, "b0")
    j.put(1, 0, "c0")
    assert j.get(timeout=1.0)[1][0] == 0
    time.sleep(0.1)
    assert not done.is_set()   # seqs 1 and 2 still fill the buffer
    j.put(1, 1, "c1")
    assert j.get(timeout=1.0)[1][0] == 1
    t.join(timeout=5.0)
    assert done.is_set()


def test_join_ctrl_rides_ahead_and_fail_propagates():
    j = BranchJoin(2)
    j.attach(0)
    j.put(0, 0, "x")
    j.put_ctrl({"cmd": "trace"})
    assert j.get(timeout=1.0) == (K_CTRL, {"cmd": "trace"})
    with pytest.raises(queue.Empty):
        j.get_nowait()         # seq 0 still misses path 1
    j.fail(ConnectionError("branch died"))
    with pytest.raises(ConnectionError, match="branch died"):
        j.get(timeout=1.0)
    # producers parked in put() wake up with the same failure
    with pytest.raises(ConnectionError, match="branch died"):
        j.put(0, 1, "y")


def test_join_get_timeout_reports_progress():
    j = BranchJoin(3)
    j.attach(0)
    j.put(0, 0, "only")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="1/3"):
        j.get(timeout=0.2)
    assert time.monotonic() - t0 < 2.0


def test_broadcast_sender_needs_two_channels():
    with pytest.raises(ValueError, match=">= 2"):
        BroadcastSender([object()])


# ---------------------------------------------------------------------------
# the two packages' joins on the same calls
# ---------------------------------------------------------------------------

def _outcome(fn):
    """``("ok", value)`` or ``("err", type name, message)`` of one call."""
    try:
        return ("ok", fn())
    except queue.Empty:
        return ("empty",)
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("err", type(e).__name__, str(e))


def _random_ops(rng, paths: int, n: int) -> list:
    """A random call sequence against a P-path join: deposits (in order,
    out of order, duplicated, stale), ENDs (one missing or doubled at
    times) and non-blocking gets, interleaved."""
    ops = [("attach", p) for p in range(paths)]
    if rng.random() < 0.2:
        ops.append(("attach", int(rng.integers(paths))))   # double claim
    pending = [(p, s) for s in range(n) for p in range(paths)]
    rng.shuffle(pending)
    if rng.random() < 0.3 and pending:
        pending.pop(int(rng.integers(len(pending))))       # a lost frame
    for p, s in pending:
        ops.append(("put", p, s))
        if rng.random() < 0.1:
            ops.append(("put", p, int(rng.integers(n))))   # dup or stale
        if rng.random() < 0.5:
            ops.append(("get",))
    ends = list(range(paths))
    if rng.random() < 0.2:
        ends.append(int(rng.integers(paths)))              # a second END
    for p in ends:
        ops.append(("end", p))
    ops += [("get",)] * (n + 2)
    return ops


def _replay(pkg, ops, paths: int, capacity: int) -> list:
    j = pkg.BranchJoin(paths, capacity=capacity)
    out = []
    for op in ops:
        if op[0] == "attach":
            out.append(_outcome(lambda: j.attach(op[1])))
        elif op[0] == "put":
            p, s = op[1], op[2]
            out.append(_outcome(lambda: j.put(p, s, f"{p}:{s}",
                                              timeout=0.0)))
        elif op[0] == "end":
            out.append(_outcome(lambda: j.end(op[1])))
        else:
            out.append(_outcome(j.get_nowait))
        out.append(("qsize", j.qsize()))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_join_equals_jax_join_on_random_calls(seed):
    """The port's ``BranchJoin`` and the JAX package's, fed the same call
    sequence: every release (kind, seq, parts), refusal (a full buffer's
    TimeoutError, a duplicate or stale ValueError, a double claim) and
    stream error (a gap at END, a second END) is equal, message and all."""
    rng = np.random.default_rng(seed)
    paths = int(rng.integers(2, 5))
    capacity = int(rng.integers(2, 6))
    ops = _random_ops(rng, paths, int(rng.integers(3, 9)))
    got = _replay(tbranch, ops, paths, capacity)
    want = _replay(jbranch, ops, paths, capacity)
    assert got == want


def test_random_calls_reach_every_outcome():
    """The seeds of the comparison above reach releases, the END, a full
    buffer's refusal, duplicate or stale deposits and a stream error."""
    seen = set()
    for seed in range(12):
        rng = np.random.default_rng(seed)
        paths = int(rng.integers(2, 5))
        capacity = int(rng.integers(2, 6))
        ops = _random_ops(rng, paths, int(rng.integers(3, 9)))
        for o in _replay(tbranch, ops, paths, capacity):
            if o[0] == "ok" and isinstance(o[1], tuple):
                seen.add(o[1][0])
            elif o[0] == "err":
                seen.add(o[1])
    assert {K_TENSOR_SEQ, K_END, "TimeoutError", "ValueError",
            "ConnectionError"} <= seen


# ---------------------------------------------------------------------------
# a fork of one package into the join of the other, over sockets
# ---------------------------------------------------------------------------

def _reader(sock, framed, join, path_box, errs):
    """A join node's path reader in miniature: the path label from the
    channel's ``stream_begin``, then every stamped frame into the join."""
    try:
        while True:
            kind, value = framed.recv_frame(sock)
            if kind == framed.K_END:
                join.end(path_box[0])
                return
            if kind == framed.K_CTRL:
                if value.get("cmd") == "stream_begin":
                    path_box[0] = int(value["path"])
                    join.attach(path_box[0])
                continue
            assert kind == framed.K_TENSOR_SEQ
            seq, arr = value
            join.put(path_box[0], seq, np.asarray(arr))
    except BaseException as e:  # noqa: BLE001 — asserted below
        errs.append(e)
        join.fail(e)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("fork", ["port", "jax"])
def test_broadcast_into_the_other_packages_join(fork):
    """A ``BroadcastSender`` of one package feeds three socket paths read
    into the other package's ``BranchJoin``: each path announces its label,
    every frame reaches every path under one shared stamp (a caller's seq
    is ignored), and the join releases each frame's three copies in
    order, bit-equal to what was sent."""
    send_pkg, recv_pkg = ((tbranch, jbranch) if fork == "port"
                          else (jbranch, tbranch))
    recv_framed = jframed if fork == "port" else tframed
    pairs = [socket.socketpair() for _ in range(3)]
    join = recv_pkg.BranchJoin(3, capacity=4)
    errs: list = []
    boxes = [[None] for _ in pairs]
    readers = [threading.Thread(target=_reader,
                                args=(b, recv_framed, join, boxes[i], errs),
                                daemon=True)
               for i, (_, b) in enumerate(pairs)]
    for t in readers:
        t.start()
    # channel i carries path label 2 - i: the join slots by label
    tx = send_pkg.BroadcastSender([a for a, _ in pairs], depth=2,
                                  paths=[2, 1, 0])
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((2, 7)).astype(np.float32) for _ in range(9)]
    for i, x in enumerate(xs):
        tx.send(x, seq=100 + i)
    tx.close(timeout=10.0)
    items = drain(join, timeout=10.0)
    for t in readers:
        t.join(timeout=10.0)
    for a, b in pairs:
        a.close()
        b.close()
    assert errs == []
    assert [b[0] for b in boxes] == [2, 1, 0]
    tensors = [v for k, v in items if k == K_TENSOR_SEQ]
    assert [s for s, _ in tensors] == list(range(len(xs)))
    for (s, parts), x in zip(tensors, xs):
        assert len(parts) == 3
        for part in parts:
            np.testing.assert_array_equal(part, x)
    assert tx.width == 3
