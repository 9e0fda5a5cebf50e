"""Port parity: stage replication — the ordered fan-out/fan-in
(``defer_tpu_torch.transport.replicate``), replicated chains of port
nodes, and the hardened ``run_chain`` paths, mirroring
``tests/test_replication.py`` scenario for scenario.

Beyond the mirror, the packages meet on the wire: a JAX ``FanOutSender``
feeds a port ``FanInMerge`` and the reverse, and one port fan-out is
served by a JAX replica and a port replica together (ROADMAP A10b's bar);
``_normalize_replicas`` and the hop-tier adjacency rules raise the JAX
package's messages.

Tolerances, with their reasons:

* a replicated port chain against the unreplicated port chain: equal (the
  same programs on the same frames; replication only schedules);
* a port chain against the JAX forward: 1e-5 of max |output| (resnet_tiny
  in f32; the convolutions sum in another order than XLA's);
* rows that crossed a JAX replica: rtol 2e-4 (atol 2e-4), the JAX chain
  tests' own bound, as in ``tests/test_torch_node_chain.py``.

Every socket test binds ``127.0.0.1:0``, joins its threads with a bound
and carries its own time limit.
"""

import json
import queue
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax

from defer_tpu import partition as jax_partition
from defer_tpu.models import resnet_tiny as jax_resnet_tiny
from defer_tpu.runtime import node as jnode
from defer_tpu.transport import framed as jf
from defer_tpu.transport import replicate as jr
from defer_tpu.utils import export as jexport
from defer_tpu_torch import models, params_from_jax, partition
from defer_tpu_torch.runtime import node as tnode
from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode, run_chain
from defer_tpu_torch.transport.framed import (K_CTRL, K_END, K_TENSOR,
                                              K_TENSOR_SEQ, recv_frame,
                                              send_frame)
from defer_tpu_torch.transport.replicate import FanInMerge, FanOutSender
from defer_tpu_torch.utils import export as texport

torch.set_num_threads(1)

TOL = 2e-4
REL = 1e-5
IN_SHAPE = (32, 32, 3)


@pytest.fixture(scope="module")
def tiny():
    jg = jax_resnet_tiny()
    jp = jg.init(jax.random.key(0))
    g = models.resnet_tiny()
    p = params_from_jax(g, jax.tree.map(np.asarray, jp))
    return jg, jp, g, p


def _stages(tiny, n):
    jg, jp, g, p = tiny
    jstages = jax_partition(jg, num_stages=n)
    return jstages, partition(g, [s.output_name for s in jstages[:-1]])


def _inputs(seed, m):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1,) + IN_SHAPE).astype(np.float32)
            for _ in range(m)]


# ---------------------------------------------------------------------------
# sequence-stamped frames (protocol v2)
# ---------------------------------------------------------------------------

@pytest.mark.timeout(60)
def test_seq_frame_round_trip():
    a, b = socket.socketpair()
    try:
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        send_frame(a, arr, seq=7, codec="bf8")
        kind, value = recv_frame(b)
        assert kind == K_TENSOR_SEQ
        seq, got = value
        assert seq == 7 and got.shape == (3, 4)
        # plain frames are untouched by the v2 addition
        send_frame(a, arr)
        kind, got = recv_frame(b)
        assert kind == K_TENSOR and got.shape == (3, 4)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# the reorder buffer
# ---------------------------------------------------------------------------

def test_merge_gap_stalls_consumer_until_filled():
    """Later frames buffered, the next one missing: the consumer parks
    (never reorders), then releases everything in order once the gap
    fills."""
    m = FanInMerge(2, capacity=8)
    m.put(1, "b")
    m.put(2, "c")
    with pytest.raises(queue.Empty):
        m.get_nowait()
    with pytest.raises(TimeoutError):
        m.get(timeout=0.2)
    m.put(0, "a")
    assert [m.get(1.0)[1] for _ in range(3)] == ["a", "b", "c"]


@pytest.mark.timeout(60)
def test_merge_backpressure_parks_producer_but_admits_needed_seq():
    """A full buffer of later frames blocks further out-of-order puts, but
    the sequence the consumer waits on is always admitted."""
    m = FanInMerge(2, capacity=2)
    m.put(1, "b")
    m.put(2, "c")  # full: {1, 2}
    blocked = threading.Event()
    unblocked = threading.Event()

    def slow_path():
        blocked.set()
        m.put(3, "d", timeout=30.0)  # parks: buffer full, not needed
        unblocked.set()

    t = threading.Thread(target=slow_path, daemon=True)
    t.start()
    blocked.wait(5.0)
    time.sleep(0.2)
    assert not unblocked.is_set()
    m.put(0, "a")                      # the needed seq is admitted anyway
    assert m.get(1.0)[1] == "a"        # back at capacity: still parked
    time.sleep(0.2)
    assert not unblocked.is_set()
    assert m.get(1.0)[1] == "b"        # below capacity: the producer wakes
    t.join(timeout=10)
    assert unblocked.is_set()
    assert [m.get(1.0)[1] for _ in range(2)] == ["c", "d"]


def test_merge_rejects_duplicate_and_stale_seq():
    m = FanInMerge(2, capacity=4)
    m.put(0, "a")
    with pytest.raises(ValueError, match="duplicate/stale"):
        m.put(0, "dup")            # a duplicate while buffered
    assert m.get(1.0) == (K_TENSOR, "a")
    with pytest.raises(ValueError, match="duplicate/stale"):
        m.put(0, "late")           # stale: already released
    m.put(1, "b")
    assert m.get(1.0)[1] == "b"


def test_merge_end_requires_all_upstreams():
    """One END of R is not the stream's end; R are, after the buffered
    frames drain in order."""
    m = FanInMerge(3, capacity=8)
    m.put(0, "a")
    m.end()
    m.end()
    assert m.get(1.0)[1] == "a"
    with pytest.raises(TimeoutError):
        m.get(timeout=0.2)          # 2 of 3 ENDs: not over yet
    m.put(1, "b")
    m.end()
    assert m.get(1.0)[1] == "b"
    assert m.get(1.0) == (K_END, None)


def test_merge_end_with_gap_raises():
    """Every upstream ended with a slot never filled: loud."""
    m = FanInMerge(2, capacity=8)
    m.put(1, "b")
    m.end()
    m.end()
    with pytest.raises(ConnectionError, match="gap"):
        m.get(timeout=1.0)


def test_merge_ctrl_rides_ahead_and_reader_failure_propagates():
    m = FanInMerge(2, capacity=4)
    m.put(0, "a")
    m.put_ctrl({"cmd": "trace"})
    kind, msg = m.get(1.0)
    assert kind == K_CTRL and msg["cmd"] == "trace"
    assert m.get(1.0)[1] == "a"
    m.fail(ConnectionError("replica died"))
    with pytest.raises(ConnectionError, match="replica died"):
        m.get(timeout=1.0)
    with pytest.raises(ConnectionError, match="replica died"):
        m.put(1, "b")


def test_merge_capacity_validation():
    with pytest.raises(ValueError, match="capacity"):
        FanInMerge(4, capacity=2)
    with pytest.raises(ValueError, match="expected"):
        FanInMerge(0)


# ---------------------------------------------------------------------------
# the fan-out sender, and frames across the packages
# ---------------------------------------------------------------------------

@pytest.mark.timeout(60)
def test_fanout_round_robin_stamps_sequence():
    """Tensor i goes to channel i % R carrying seq i; control and END
    frames go to every channel."""
    pairs = [socket.socketpair() for _ in range(2)]
    try:
        fo = FanOutSender([a for a, _ in pairs], depth=4)
        for i in range(6):
            fo.send(np.full((2,), i, np.int32))
        fo.close(timeout=10.0)
        for r, (_, b) in enumerate(pairs):
            seqs = []
            while True:
                kind, value = recv_frame(b)
                if kind == K_END:
                    break
                assert kind == K_TENSOR_SEQ
                seq, arr = value
                assert int(arr[0]) == seq
                seqs.append(seq)
            assert seqs == [r, r + 2, r + 4]
    finally:
        for a, b in pairs:
            a.close()
            b.close()


def _fan_round_trip(fan_out, merge, recv, n=12, delays=(0.0, 0.02)):
    """Fan ``n`` frames out over two socket pairs with ``fan_out`` and
    merge them back with ``merge`` (readers decode with ``recv``), one
    path's reader running behind; the merged stream's payloads."""
    pairs = [socket.socketpair() for _ in range(2)]
    try:
        fo = fan_out([a for a, _ in pairs], depth=8)

        def reader(r):
            sock = pairs[r][1]
            try:
                while True:
                    kind, value = recv(sock)
                    if kind == K_END:
                        merge.end()
                        return
                    if kind == K_CTRL:
                        continue
                    time.sleep(delays[r])  # one slow replica path
                    merge.put(*value)
            except BaseException as e:  # noqa: BLE001 — raised in get()
                merge.fail(e)

        threads = [threading.Thread(target=reader, args=(r,), daemon=True)
                   for r in range(2)]
        for t in threads:
            t.start()
        for i in range(n):
            fo.send(np.full((2,), i, np.int32))
        fo.close(timeout=10.0)
        got = []
        while True:
            kind, value = merge.get(timeout=30.0)
            if kind == K_END:
                break
            got.append(value)
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        return got
    finally:
        for a, b in pairs:
            a.close()
            b.close()


@pytest.mark.timeout(60)
def test_fanout_merge_round_trip_out_of_order_arrival():
    """End to end through real sockets: fan out two ways, merge back in
    order, one path's reader far behind."""
    got = _fan_round_trip(FanOutSender, FanInMerge(2, capacity=8),
                          recv_frame)
    assert [int(v[0]) for v in got] == list(range(12))


@pytest.mark.timeout(60)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_fans_interoperate_across_packages(direction):
    """A JAX ``FanOutSender`` into a port ``FanInMerge``, and a port
    ``FanOutSender`` into a JAX ``FanInMerge``: the stamped frames are the
    same bytes in both packages, so either half merges the other's
    stream, in order and value for value."""
    if direction == "jax_to_port":
        got = _fan_round_trip(jr.FanOutSender, FanInMerge(2, capacity=8),
                              recv_frame)
    else:
        got = _fan_round_trip(FanOutSender, jr.FanInMerge(2, capacity=8),
                              jf.recv_frame)
    assert len(got) == 12
    for i, v in enumerate(got):
        np.testing.assert_array_equal(np.asarray(v),
                                      np.full((2,), i, np.int32))


# ---------------------------------------------------------------------------
# replicated chains of in-process port nodes
# ---------------------------------------------------------------------------

def _run_chain_inproc(stages, params, xs, *, replicas=(1, 1, 1),
                      codecs=None):
    groups = []
    for k, r in enumerate(replicas):
        fan_in = replicas[k - 1] if k > 0 else 1
        groups.append([
            StageNode(None, "127.0.0.1:0", None, device="cpu",
                      replica=j if r > 1 else None, fan_in=fan_in)
            for j in range(r)])
    addr_groups = [[f"127.0.0.1:{n.address[1]}" for n in grp]
                   for grp in groups]
    flat = [n for grp in groups for n in grp]
    threads = [threading.Thread(target=n.serve, daemon=True) for n in flat]
    for t in threads:
        t.start()
    disp = ChainDispatcher(",".join(addr_groups[0]), codec="raw",
                           result_fan_in=replicas[-1])
    try:
        disp.deploy(stages, params,
                    [a[0] if len(a) == 1 else a for a in addr_groups],
                    batch=xs[0].shape[0], codecs=codecs)
        outs = disp.stream(xs)
        stats = disp.stats([a for grp in addr_groups for a in grp])
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return outs, stats


@pytest.mark.timeout(240)
def test_replicated_chain_byte_identical_and_split(tiny):
    """Replicating the middle stage only schedules: the same rows in the
    same order as the unreplicated port chain, within 1e-5 of max
    |output| of the JAX forward, the round-robin split in the replicas'
    stats, and each replica labelled ``stage1.rN``."""
    jg, jp, _, p = tiny
    _, stages = _stages(tiny, 3)
    xs = _inputs(21, 6)
    base, _ = _run_chain_inproc(stages, p, xs)
    rep, stats = _run_chain_inproc(stages, p, xs, replicas=(1, 2, 1))
    assert len(base) == len(rep) == 6
    for a, b in zip(base, rep):
        np.testing.assert_array_equal(a, b)
    fwd = jax.jit(jg.apply)
    for x, y in zip(xs, rep):
        ref = np.asarray(fwd(jp, x))
        assert np.abs(y - ref).max() <= REL * np.abs(ref).max()
    per_rep = {s["replica"]: s["processed"] for s in stats
               if s.get("stage") == 1}
    assert per_rep == {0: 3, 1: 3}
    assert [s["fan_in"] for s in stats] == [1, 1, 1, 2]
    assert [s["next"].count(",") for s in stats] == [1, 0, 0, 0]


@pytest.mark.timeout(240)
def test_replicated_last_stage_and_short_stream(tiny):
    """Last-stage replication (the dispatcher's own fan-in merge), a
    replicated first stage (the dispatcher's own fan-out), and the
    fewer-inputs-than-replicas edge where one replica only ever sees the
    cascaded END."""
    _, stages = _stages(tiny, 2)
    p = tiny[3]
    xs = _inputs(22, 3)
    base, _ = _run_chain_inproc(stages, p, xs, replicas=(1, 1))
    rep, _ = _run_chain_inproc(stages, p, xs, replicas=(1, 2))
    first, _ = _run_chain_inproc(stages, p, xs, replicas=(2, 1))
    for a, b, c in zip(base, rep, first):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    one, _ = _run_chain_inproc(stages, p, xs[:1], replicas=(1, 2))
    np.testing.assert_array_equal(one[0], base[0])


@pytest.mark.timeout(240)
def test_one_fan_out_served_by_a_jax_and_a_port_replica(tiny, tmp_path):
    """A port stage 0 fans out to two replicas of stage 1, replica 0 a
    JAX node on the JAX artifact and replica 1 a port node on the port's,
    merged by a port fan-in: the rows through the port replica equal the
    unreplicated port chain's, the rows through the JAX replica agree
    within the JAX chain tests' bound, and each replica processed its
    round-robin half."""
    jg, jp, g, p = tiny
    jstages, stages = _stages(tiny, 3)
    xs = _inputs(23, 6)
    base, _ = _run_chain_inproc(stages, p, xs)
    paths = [str(tmp_path / f"t{k}.zip") for k in range(3)]
    for stage, path in zip(stages, paths):
        texport.export_stage(stage, p, path, batch=1)
    jpath = str(tmp_path / "j1.zip")
    jexport.export_stage(jstages[1], jp, jpath, batch=1)
    res = f"127.0.0.1:{tnode._free_ports(1)[0]}"
    n2 = StageNode(paths[2], "127.0.0.1:0", res, device="cpu", fan_in=2)
    a2 = f"127.0.0.1:{n2.address[1]}"
    r0 = jnode.StageNode(jpath, "127.0.0.1:0", a2, replica=0)
    r1 = StageNode(paths[1], "127.0.0.1:0", a2, device="cpu", replica=1)
    n0 = StageNode(paths[0], "127.0.0.1:0",
                   f"127.0.0.1:{r0.address[1]},127.0.0.1:{r1.address[1]}",
                   device="cpu")
    nodes = [n0, r0, r1, n2]
    threads = [threading.Thread(target=n.serve, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    disp = ChainDispatcher(f"127.0.0.1:{n0.address[1]}", listen=res)
    try:
        outs = [np.asarray(y) for y in disp.stream(xs)]
        st = disp.stats([f"127.0.0.1:{n.address[1]}" for n in nodes])
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for i, (a, b) in enumerate(zip(base, outs)):
        if i % 2:
            np.testing.assert_array_equal(a, b)   # the port replica
        else:
            np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    assert [(s["replica"], s["processed"]) for s in st] == \
        [(None, 6), (0, 3), (1, 3), (None, 6)]


# ---------------------------------------------------------------------------
# validation, with the JAX package's messages
# ---------------------------------------------------------------------------

def _message(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("replicas,n", [
    ({0: 2, 1: 2}, 3), ({7: 2}, 3), ({1: 0}, 3), ({-1: 2}, 2),
    ({1: 3}, 3), ({0: 2, 2: 2}, 3), (None, 2)])
def test_normalize_replicas_equals_jax(replicas, n):
    """``_normalize_replicas``: the same counts, or the same
    ``ValueError`` message, as the JAX package's."""
    got = _message(tnode._normalize_replicas, replicas, n)
    want = _message(jnode._normalize_replicas, replicas, n)
    assert got == want
    if want is None:
        assert tnode._normalize_replicas(replicas, n) == \
            jnode._normalize_replicas(replicas, n)


@pytest.mark.parametrize("hop_tiers,n,r_of,default", [
    (["shm", "tcp"], 3, [1, 2, 1], "tcp"),
    (["ici", "tcp"], 3, [1, 2, 1], "tcp"),
    (["tcp", "local"], 3, [1, 2, 1], "tcp"),
    (["device"], 2, [2, 1], "tcp"),
    (None, 3, [1, 2, 1], "shm"),
    (None, 3, [1, 2, 1], "auto"),
    (["shm", "auto"], 3, [1, 1, 1], "tcp"),
    (["warp"], 2, [1, 1], "tcp")])
def test_hop_tier_adjacency_equals_jax(hop_tiers, n, r_of, default):
    """The hop-tier rules around a replicated stage: the same tiers, or
    the same ``ValueError`` message, as the JAX package's."""
    got = _message(tnode._normalize_hop_tiers, hop_tiers, n, default, r_of)
    want = _message(jnode._normalize_hop_tiers, hop_tiers, n, r_of, default)
    assert got == want
    if want is None:
        assert tnode._normalize_hop_tiers(hop_tiers, n, default, r_of) == \
            jnode._normalize_hop_tiers(hop_tiers, n, r_of, default)


@pytest.mark.timeout(60)
def test_adjacent_replication_rejected(tiny):
    with pytest.raises(ValueError, match="adjacent"):
        tnode._normalize_replicas({0: 2, 1: 2}, 3)
    with pytest.raises(ValueError, match="out of range"):
        tnode._normalize_replicas({7: 2}, 3)
    assert tnode._normalize_replicas({1: 3}, 3) == [1, 3, 1]
    disp = ChainDispatcher("127.0.0.1:1")
    try:
        _, stages = _stages(tiny, 3)
        with pytest.raises(ValueError, match="adjacent replication"):
            disp.deploy(stages, tiny[3], [["a:1", "a:2"], ["a:3", "a:4"],
                                          "a:5"])
    finally:
        disp._res_srv.close()


@pytest.mark.timeout(60)
def test_fan_role_nodes_refuse_a_colocated_tier_pin():
    """A shm/ici/local pin on a replica or a fan-out node raises (the
    fan paths ride tcp), at construction and after a deploy sets the
    role; ``auto`` stays allowed (tests/test_shm.py's and
    tests/test_ici.py's pin cases)."""
    for tier in ("shm", "ici", "local"):
        with pytest.raises(ValueError, match="replica"):
            StageNode(None, "127.0.0.1:0", None, device="cpu", tier=tier,
                      replica=0)
        with pytest.raises(ValueError, match="fan-out"):
            StageNode(None, "127.0.0.1:0", "127.0.0.1:1,127.0.0.1:2",
                      device="cpu", tier=tier)
    node = StageNode(None, "127.0.0.1:0", None, device="cpu", tier="auto",
                     replica=0)
    assert node._span_label() == f"node{node.address[1]}.r0"
    node._srv.close()
    node = StageNode(None, "127.0.0.1:0", None, device="cpu", tier="shm")
    node.replica = 0  # what {"cmd": "deploy", "replica": 0} sets
    with pytest.raises(ValueError, match="replica"):
        node._check_tier_pin()
    node._srv.close()


# ---------------------------------------------------------------------------
# run_chain with replicas, and the chain command
# ---------------------------------------------------------------------------

@pytest.mark.timeout(300)
def test_cli_chain_runs_replicas_with_failover(capsys):
    """``chain --replicas stage1=2 --failover`` on the CPU: four node
    processes (stage 1 twice), the rows equal to the forward, each
    replica's share in the row, no failover needed.  Pinned to tcp (the
    fan hops ride it anyway), so the chain holds no ``/dev/shm`` segment
    while the shm tests of other files count them."""
    from defer_tpu_torch import cli
    cli.main(["chain", "--model", "resnet_tiny", "--stages", "3",
              "--count", "4", "--replicas", "stage1=2", "--failover",
              "--tier", "tcp", "--device", "cpu"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["stages"] == 3 and row["replicas"] == {"stage1": 2}
    assert row["hop_tiers"] == ["tcp", "tcp"] and row["result_tier"] == "tcp"
    assert [(r["stage"], r["replica"], r["processed"])
            for r in row["per_node_processed"]] == \
        [(0, None, 4), (1, 0, 2), (1, 1, 2), (2, None, 4)]
    assert row["failovers"] == 0
    assert row["max_abs_err_vs_single_program"] == 0.0


@pytest.mark.slow
@pytest.mark.timeout(400)
def test_run_chain_kills_children_when_one_dies_mid_stream(tiny):
    """Kill one node mid-stream: run_chain raises (naming the dead node)
    and terminates every remaining child first."""
    _, stages = _stages(tiny, 3)
    rng = np.random.default_rng(23)
    spawned: list = []

    def inputs():
        for i in range(40):
            if i == 2:
                spawned[1].kill()
            yield rng.standard_normal((1,) + IN_SHAPE).astype(np.float32)

    with pytest.raises(RuntimeError, match="stage1"):
        run_chain(stages, tiny[3], inputs(), device="cpu",
                  on_spawn=spawned.extend, spawn_retries=1)
    assert len(spawned) == 3
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if all(pr.poll() is not None for pr in spawned):
            break
        time.sleep(0.2)
    assert all(pr.poll() is not None for pr in spawned)


@pytest.mark.slow
@pytest.mark.timeout(240)
def test_run_chain_retries_bind_race(tiny, monkeypatch):
    """Steal one probed port before the children spawn: attempt 1 dies
    with address-in-use, the retry on fresh ports succeeds."""
    _, stages = _stages(tiny, 2)
    xs = _inputs(24, 2)
    real_free_ports = tnode._free_ports
    thief: list = []

    def stealing_free_ports(n):
        ports = real_free_ports(n)
        if not thief:
            thief.append(socket.create_server(("127.0.0.1", ports[0])))
        return ports

    monkeypatch.setattr(tnode, "_free_ports", stealing_free_ports)
    try:
        outs = tnode.run_chain(stages, tiny[3], xs, device="cpu",
                               spawn_retries=3)
        assert len(outs) == 2
    finally:
        for s in thief:
            s.close()


@pytest.mark.slow
@pytest.mark.timeout(240)
def test_three_process_replicated_chain_matches_single_program(tiny):
    """Stage 1 as two OS-process replicas, against the JAX forward, with
    the per-replica stats."""
    jg, jp, _, p = tiny
    _, stages = _stages(tiny, 3)
    xs = _inputs(25, 5)
    stats: list = []
    outs = run_chain(stages, p, xs, replicas={1: 2}, stats_out=stats,
                     device="cpu")
    assert len(outs) == 5
    fwd = jax.jit(jg.apply)
    for x, y in zip(xs, outs):
        np.testing.assert_allclose(y, np.asarray(fwd(jp, x)), rtol=TOL,
                                   atol=TOL)
    per_rep = {s["replica"]: s["processed"] for s in stats
               if s.get("stage") == 1}
    assert sorted(per_rep) == [0, 1] and sum(per_rep.values()) == 5
