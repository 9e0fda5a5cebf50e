"""Port parity: the shared-memory transport tier
(``defer_tpu_torch.transport.shm``), mirroring ``tests/test_shm.py``: ring
semantics, same-host negotiation and per-hop fallback, segment lifecycle,
and the JAX package's rings feeding the port's and back.

Everything runs in the test process (``device="cpu"``) over socketpairs
and thread-per-node chains; the one real multi-process chain of this tier
in tier-1 is ``tests/test_torch_node_chain.py::test_run_chain_spawns_processes``
(both hops report shm).  Tolerance: byte-identical everywhere — a ring
moves the frame's bytes unchanged, and the same programs run on the same
inputs.
"""

import errno
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from defer_tpu.transport import channel as jchannel
from defer_tpu.transport import shm as jshm
from defer_tpu_torch import models, partition
from defer_tpu_torch.obs import REGISTRY
from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode
from defer_tpu_torch.transport import shm as S
from defer_tpu_torch.transport.channel import AsyncReceiver, ChannelError
from defer_tpu_torch.transport.framed import (K_CTRL, K_END, K_TENSOR,
                                              K_TENSOR_SEQ, PROTOCOL_VERSION,
                                              recv_frame, send_ctrl)
from defer_tpu_torch.transport.shm import (SEG_PREFIX, ShmRing, _boot_id,
                                           answer_tier_probe, grant_shm,
                                           offer_shm, sweep_orphan_segments)

torch.set_num_threads(1)


def _counter(name: str) -> float:
    return REGISTRY.counter(name).value


def _hist_count(name: str) -> int:
    return int(REGISTRY.histogram(name).summary().get("count", 0))


def _segments(pids=None) -> set:
    """This process's segment names (or those of ``pids``): tests in other
    worker processes create and remove their own meanwhile."""
    prefixes = tuple(f"{SEG_PREFIX}{p}_" for p in (pids or [os.getpid()]))
    try:
        return {n for n in os.listdir("/dev/shm") if n.startswith(prefixes)}
    except OSError:
        return set()


def _negotiate(*, depth: int = 4, slot_bytes: int = 256,
               accept: bool = True, offer=offer_shm, answer=None,
               receiver_cls=AsyncReceiver):
    """socketpair negotiation: (sock_a, sock_b, tier, sender, receiver).
    ``offer``/``answer``/``receiver_cls`` pick each side's package."""
    answer = answer or answer_tier_probe
    a, b = socket.socketpair()
    inner = receiver_cls(b, depth=8)
    state = {}

    def peer():
        kind, msg = inner.get(5.0)
        assert kind == K_CTRL and msg["cmd"] == "tier_probe"
        state["tier"], state["chan"] = answer(b, msg, accept=accept,
                                              inner=inner)

    t = threading.Thread(target=peer, daemon=True)
    t.start()
    tier, tx = offer(a, depth=depth, slot_bytes=slot_bytes)
    t.join(5.0)
    return a, b, tier, tx, state.get("chan")


def _close(a, b, tx, rx):
    tx.close(timeout=5.0)
    assert rx.get(5.0) == (K_END, None)
    rx.release_gauge()
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# ring semantics
# ---------------------------------------------------------------------------

def test_ring_roundtrip_order_seq_ctrl_end():
    a, b, tier, tx, rx = _negotiate()
    assert tier == "shm" and tx is not None and rx is not None
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    tx.send_ctrl({"cmd": "trace", "trace_id": "t"})
    tx.send(arr)
    tx.send(arr * 2, seq=7)
    assert rx.get(5.0) == (K_CTRL, {"cmd": "trace", "trace_id": "t"})
    kind, v = rx.get(5.0)
    assert kind == K_TENSOR and v.dtype == np.float32
    np.testing.assert_array_equal(v, arr)
    kind, (seq, v) = rx.get(5.0)
    assert kind == K_TENSOR_SEQ and seq == 7
    np.testing.assert_array_equal(v, arr * 2)
    _close(a, b, tx, rx)


def test_ring_result_survives_slot_reuse():
    """A received frame is owned by the receiver: slot recycling over
    ``depth`` further frames does not overwrite it."""
    a, b, tier, tx, rx = _negotiate(depth=2)
    first = np.arange(8, dtype=np.float32)
    tx.send(first)
    kind, kept = rx.get(5.0)
    for i in range(6):
        tx.send(np.full(8, 100.0 + i, np.float32))
        rx.get(5.0)
    np.testing.assert_array_equal(kept, first)
    _close(a, b, tx, rx)


def test_ring_backpressure_is_bounded():
    a, b, tier, tx, rx = _negotiate(depth=2)
    sent = []

    def produce():
        for i in range(6):
            tx.send(np.full(4, i, np.float32))
            sent.append(i)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    t.join(0.5)
    assert t.is_alive() and len(sent) <= 2  # parked on the full ring
    got = [int(rx.get(5.0)[1][0]) for _ in range(6)]
    t.join(5.0)
    assert not t.is_alive()
    assert got == list(range(6))  # in order, nothing dropped
    _close(a, b, tx, rx)


def test_ring_grows_past_slot_capacity():
    """A frame fatter than a slot swaps in a bigger segment, announced
    ahead of the frames that need it, and no segment name leaks."""
    a, b, tier, tx, rx = _negotiate(slot_bytes=128)
    before = _segments()
    small = np.arange(8, dtype=np.float32)
    big = np.arange(4096, dtype=np.float32)
    got = []

    def consume():
        for _ in range(3):
            got.append(rx.get(10.0)[1])

    # a grow drains the ring first, so the consumer runs alongside
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    tx.send(small)
    tx.send(big)        # > 128 bytes: grow
    tx.send(big * 2)
    t.join(15.0)
    assert not t.is_alive()
    np.testing.assert_array_equal(got[0], small)
    np.testing.assert_array_equal(got[1], big)
    np.testing.assert_array_equal(got[2], big * 2)
    assert tx._ring.slot_bytes == 1 << 14
    _close(a, b, tx, rx)
    assert _segments() <= before  # grown ring and old ring reaped


@pytest.mark.timeout(60)
def test_ring_counts_hold_under_thread_switching():
    """The producer, the consumer and the ack thread share the slot
    count: with a tiny switch interval and a 2-slot ring, 400 frames
    arrive in order and every slot comes back."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        a, b, tier, tx, rx = _negotiate(depth=2, slot_bytes=64)
        got = []

        def consume():
            for _ in range(400):
                got.append(int(rx.get(10.0)[1][0]))

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        for i in range(400):
            tx.send(np.full(4, i, np.int32))
        t.join(30)
        assert not t.is_alive() and got == list(range(400))
        tx._drain(10.0)
        assert tx.qsize() == 0 and tx._free._value == 2
        _close(a, b, tx, rx)
    finally:
        sys.setswitchinterval(old)


def test_receiver_gone_wakes_parked_producer():
    a, b, tier, tx, rx = _negotiate(depth=1)
    tx.send(np.zeros(4, np.float32))
    err = []

    def produce():
        try:
            tx.send(np.ones(4, np.float32))  # parks on the full ring
        except ChannelError as e:
            err.append(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    t.join(0.3)
    assert t.is_alive()
    rx.release_gauge()  # the consumer's stream loop exited
    t.join(5.0)
    assert not t.is_alive() and err, "parked producer never woke"
    tx.detach()
    a.close()
    b.close()


def test_sender_death_fails_receiver_and_reaps_segment():
    a, b, tier, tx, rx = _negotiate()
    tx.send(np.zeros(4, np.float32))
    rx.get(5.0)
    seg = tx._ring.name
    # the sender's process is gone: its kernel sends the doorbell's EOF
    # (a bare close would not, while the ack thread blocks in recv)
    a.shutdown(socket.SHUT_RDWR)
    a.close()
    with pytest.raises(ConnectionError):
        rx.get(5.0)
    assert not os.path.exists(os.path.join("/dev/shm", seg))
    b.close()


@pytest.mark.parametrize("make", [
    lambda: torch.arange(24, dtype=torch.float32).reshape(2, 3, 4),
    # a permuted view: the copy into the slot lays it out contiguously
    lambda: torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    .permute(0, 2, 1),
    lambda: torch.arange(24, dtype=torch.float32).reshape(1, 2, 3, 4)
    .contiguous(memory_format=torch.channels_last),
    lambda: (torch.arange(24, dtype=torch.float32) / 7).to(torch.bfloat16),
    lambda: torch.arange(6, dtype=torch.int32)])
def test_tensor_frames_copy_into_the_slot(make):
    """A tensor (the node's direct copy into its slot) arrives with its
    logical values, dtype and shape: numpy, or ``torch.bfloat16``."""
    a, b, tier, tx, rx = _negotiate(slot_bytes=64)
    t = make()
    tx.send(t)
    kind, v = rx.get(5.0)
    assert kind == K_TENSOR
    if t.dtype == torch.bfloat16:
        assert isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
        assert torch.equal(v, t)
    else:
        np.testing.assert_array_equal(v, t.numpy())
    _close(a, b, tx, rx)


def test_claim_slot_tensor_commit_is_send():
    """The node's split of ``send``: claim a slot, copy into its tensor,
    commit — the receiver sees the same frame as from ``send``."""
    a, b, tier, tx, rx = _negotiate()
    y = torch.linspace(-1, 1, 12).reshape(3, 4)
    slot = tx.claim(y.numel() * y.element_size())
    tx.slot_tensor(slot, y).copy_(y)
    tx.commit(slot, y, seq=3)
    kind, (seq, v) = rx.get(5.0)
    assert kind == K_TENSOR_SEQ and seq == 3
    np.testing.assert_array_equal(v, y.numpy())
    _close(a, b, tx, rx)


def test_a_full_dev_shm_fails_at_creation(monkeypatch):
    """A ring whose pages cannot be reserved raises ``OSError`` when it is
    created (never a quiet tcp hop, never a bus error at the first
    write), and leaves no name behind."""
    def full(fd, off, n):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(S.os, "posix_fallocate", full)
    before = _segments()
    with pytest.raises(OSError, match="cannot reserve"):
        ShmRing(slots=2, slot_bytes=1 << 20)
    assert _segments() <= before


# ---------------------------------------------------------------------------
# negotiation: grant validation + fallback labeling
# ---------------------------------------------------------------------------

def _probe_msg() -> dict:
    ring = ShmRing(slots=2, slot_bytes=128)
    return {"cmd": "tier_probe", "want": "shm",
            "proto": PROTOCOL_VERSION, "boot_id": _boot_id(),
            "seg": ring.name, "slots": 2, "slot_bytes": ring.slot_bytes}


def test_grant_opens_offered_segment():
    msg = _probe_msg()
    seg = grant_shm(msg)
    assert seg is not None and seg.name == msg["seg"]
    seg.close()


@pytest.mark.parametrize("field,value", [
    ("proto", PROTOCOL_VERSION + 1), ("boot_id", "not-this-host"),
    ("seg", SEG_PREFIX + "999999_deadbeefdead"), ("seg", "not_ours"),
    ("want", "local")])
def test_grant_rejects_a_broken_claim(field, value):
    """Version mismatch, another host, an unresolvable segment, a name
    without the prefix, another rung."""
    msg = _probe_msg()
    msg[field] = value
    assert grant_shm(msg) is None


def test_refusal_degrades_and_counts_per_hop():
    a, b = socket.socketpair()

    def peer():
        kind, msg = recv_frame(b)
        assert kind == K_CTRL and msg["cmd"] == "tier_probe"
        send_ctrl(b, {"cmd": "tier_reply", "tier": "tcp"})

    t = threading.Thread(target=peer, daemon=True)
    t.start()
    before = _segments()
    g0 = _counter("transport.tier_fallback")
    h0 = _counter("transport.tier_fallback.stage7")
    tier, tx = offer_shm(a, hop="stage7")
    t.join(5.0)
    assert (tier, tx) == ("tcp", None)
    assert _counter("transport.tier_fallback") == g0 + 1
    assert _counter("transport.tier_fallback.stage7") == h0 + 1
    assert _segments() <= before  # the refused ring is unlinked
    a.close()
    b.close()


def test_answer_probe_refuses_when_not_accepting():
    a, b, tier, tx, rx = _negotiate(accept=False)
    assert (tier, tx, rx) == ("tcp", None, None)
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# across the packages: the same probe, doorbells and acks
# ---------------------------------------------------------------------------

FRAMES = [np.arange(12, dtype=np.float32).reshape(3, 4),
          np.arange(4096, dtype=np.float32) / 3,   # grows a 256-byte ring
          np.arange(6, dtype=np.int32)]


def _bf16_bits():
    return (torch.arange(10, dtype=torch.float32) / 7).to(torch.bfloat16)


def test_jax_sender_feeds_port_receiver():
    """A JAX ``ShmSender`` into a port ``ShmReceiver``: byte-identical
    frames, growth included; a bf16 frame (``ml_dtypes`` on the JAX side)
    arrives as a ``torch.bfloat16`` tensor with the same bits."""
    import ml_dtypes
    a, b, tier, tx, rx = _negotiate(offer=jshm.offer_shm)
    assert tier == "shm" and isinstance(rx, S.ShmReceiver)
    got = []

    def consume():
        for _ in range(len(FRAMES) + 1):
            got.append(rx.get(10.0))

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    for i, f in enumerate(FRAMES):
        tx.send(f, seq=i)
    bits = _bf16_bits()
    tx.send(bits.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    t.join(15.0)
    for i, f in enumerate(FRAMES):
        kind, (seq, v) = got[i]
        assert kind == K_TENSOR_SEQ and seq == i and v.dtype == f.dtype
        np.testing.assert_array_equal(v, f)
    kind, v = got[-1]
    assert v.dtype == torch.bfloat16 and torch.equal(v, bits)
    _close(a, b, tx, rx)


def test_port_sender_feeds_jax_receiver():
    """The reverse: a port ``ShmSender`` into a JAX ``ShmReceiver``; a
    ``torch.bfloat16`` tensor arrives as an ``ml_dtypes`` bfloat16 array
    with the same bits."""
    a, b, tier, tx, rx = _negotiate(answer=jshm.answer_tier_probe,
                                    receiver_cls=jchannel.AsyncReceiver)
    assert tier == "shm" and isinstance(rx, jshm.ShmReceiver)
    got = []

    def consume():
        for _ in range(len(FRAMES) + 1):
            got.append(rx.get(10.0))

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    for i, f in enumerate(FRAMES):
        tx.send(f, seq=i)
    bits = _bf16_bits()
    tx.send(bits)
    t.join(15.0)
    for i, f in enumerate(FRAMES):
        kind, (seq, v) = got[i]
        assert kind == K_TENSOR_SEQ and seq == i and v.dtype == f.dtype
        np.testing.assert_array_equal(v, f)
    kind, v = got[-1]
    assert str(v.dtype) == "bfloat16"
    np.testing.assert_array_equal(v.view(np.int16),
                                  bits.view(torch.int16).numpy())
    _close(a, b, tx, rx)


# ---------------------------------------------------------------------------
# in-process chains: byte identity, no codec work, fallback surfacing
# ---------------------------------------------------------------------------

def _run_chain_inproc(stages, params, xs, *, tier, accepts=None,
                      overlap=True):
    n = len(stages)
    nodes = [StageNode(None, "127.0.0.1:0", None, device="cpu", tier=tier,
                       overlap=overlap,
                       tier_accept=True if accepts is None else accepts[i])
             for i in range(n)]
    addrs = [f"127.0.0.1:{nd.address[1]}" for nd in nodes]
    threads = [threading.Thread(target=nd.serve, daemon=True)
               for nd in nodes]
    for t in threads:
        t.start()
    disp = ChainDispatcher(addrs[0], codec="raw", tier=tier)
    try:
        disp.deploy(stages, params, addrs, batch=xs[0].shape[0],
                    tiers=[tier] * n)
        outs = disp.stream(xs)
        stats = disp.stats(addrs)
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return outs, stats


@pytest.fixture(scope="module")
def chain3():
    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=3)
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
          for _ in range(5)]
    outs, stats = _run_chain_inproc(stages, params, xs, tier="tcp")
    return params, stages, xs, outs, stats


def test_shm_chain_byte_identical_zero_codec_work(chain3):
    """Every hop of a ``tier="shm"`` chain negotiates the ring, rows are
    byte-identical to the tcp chain's, no ``codec.*`` sample is recorded,
    each node host-syncs once per frame (into its slot), and no segment
    outlives the stream."""
    params, stages, xs, base, base_stats = chain3
    assert [s["tier"] for s in base_stats] == ["tcp"] * 3
    before = _segments()
    enc0, dec0 = _hist_count("codec.encode_s"), _hist_count("codec.decode_s")
    sf0 = _counter("transport.shm_frames")
    outs, stats = _run_chain_inproc(stages, params, xs, tier="shm")
    assert [s["tier"] for s in stats] == ["shm"] * 3
    assert [s["tier_in"] for s in stats] == ["shm"] * 3
    assert [s["tier_fallbacks"] for s in stats] == [0] * 3
    assert [s["host_sync_s"]["count"] for s in stats] == [len(xs)] * 3
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b)
    assert _hist_count("codec.encode_s") == enc0
    assert _hist_count("codec.decode_s") == dec0
    # 4 hops (disp->s0->s1->s2->result) x frames rode the rings
    assert _counter("transport.shm_frames") - sf0 == 4 * len(xs)
    assert _segments() <= before


def test_refused_shm_hop_degrades_with_labeled_fallback(chain3):
    params, stages, xs, base, _ = chain3
    before = _counter("transport.tier_fallback")
    lab0 = _counter("transport.tier_fallback.stage0")
    outs, stats = _run_chain_inproc(stages, params, xs, tier="shm",
                                    accepts=[True, False, True])
    assert _counter("transport.tier_fallback") == before + 1
    assert _counter("transport.tier_fallback.stage0") == lab0 + 1
    by_stage = {s["stage"]: s for s in stats}
    assert by_stage[0]["tier"] == "tcp" and by_stage[0]["tier_fallbacks"] == 1
    assert by_stage[1]["tier"] == "shm" and by_stage[1]["tier_fallbacks"] == 0
    assert by_stage[1]["tier_in"] == "tcp"  # it refused the offer
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b)


def test_serial_loop_refuses_every_offer(chain3):
    """The serial loop is the pure-wire baseline: it refuses the
    dispatcher's offer (one fallback on the ``chain`` hop) and offers
    nothing downstream, so an ``auto`` chain of serial nodes rides tcp."""
    params, stages, xs, base, _ = chain3
    before = _counter("transport.tier_fallback.chain")
    outs, stats = _run_chain_inproc(stages, params, xs, tier="auto",
                                    overlap=False)
    assert [s["tier_in"] for s in stats] == ["tcp", None, None]
    assert [s["tier"] for s in stats] == ["tcp"] * 3
    assert _counter("transport.tier_fallback.chain") == before + 1
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b)


def test_shm_hop_tiers_require_overlap(chain3):
    from defer_tpu_torch.runtime.node import run_chain
    params, stages, _, _, _ = chain3
    with pytest.raises(ValueError, match="shm.*overlap"):
        run_chain(stages, params, [], hop_tiers=["shm", "shm"],
                  overlap=False, device="cpu")


@pytest.mark.timeout(240)
def test_first_stage_grants_the_dispatchers_offer_on_a_tcp_hop():
    """Artifacts on the command line, ``hop_tiers=["tcp"]``: stage 0's own
    outbound policy is tcp, yet it grants the dispatcher's offer on the
    ``auto`` edge (shm), as it does under an in-band deploy.  The JAX
    package's file-mode chain refuses that offer (ROADMAP §C)."""
    from defer_tpu_torch.runtime.node import run_chain
    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=2)
    xs = [np.random.default_rng(9).standard_normal((1, 32, 32, 3))
          .astype(np.float32) for _ in range(2)]
    stats = []
    outs = run_chain(stages, params, xs, hop_tiers=["tcp"], device="cpu",
                     stats_out=stats)
    assert [(s["tier_in"], s["tier"], s["tier_fallbacks"]) for s in stats] \
        == [("shm", "tcp", 0), (None, "shm", 0)]
    with torch.inference_mode():
        for x, y in zip(xs, outs):
            np.testing.assert_array_equal(
                y, g.apply(params, torch.from_numpy(x)).numpy())


# ---------------------------------------------------------------------------
# segment lifecycle: the orphan sweep
# ---------------------------------------------------------------------------

def test_sweep_reaps_dead_pid_segments_only(tmp_path):
    """The sweep unlinks segments of dead creator pids and leaves its own
    pid's, live pids' and foreign names alone (on a directory of its own,
    so sweeps of other test processes cannot race it)."""
    dead = f"{SEG_PREFIX}999999_deadbeef0001"
    alive = f"{SEG_PREFIX}{os.getpid()}_feedfeed0001"
    parent = f"{SEG_PREFIX}{os.getppid()}_feedfeed0002"
    foreign = "psm_12345"
    for name in (dead, alive, parent, foreign):
        (tmp_path / name).write_bytes(b"x")
    assert sweep_orphan_segments(str(tmp_path)) == [dead]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [alive, parent, foreign])
    assert sweep_orphan_segments(str(tmp_path / "missing")) == []


@pytest.mark.slow
def test_real_process_kill9_poisons_cleanly_no_orphans(monkeypatch):
    """kill -9 one stage mid-stream on an all-shm chain of node processes:
    the chain fails (no hang), every child is terminated, and after the
    sweep no segment survives."""
    from defer_tpu_torch.runtime.node import run_chain

    monkeypatch.setattr(ChainDispatcher, "timeout_s", 30.0)
    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=3)
    rng = np.random.default_rng(13)
    spawned: list = []
    before = _segments()

    def inputs():
        for i in range(40):
            if i == 2:
                spawned[1].kill()  # SIGKILL: no atexit, no unlink
            yield rng.standard_normal((1, 32, 32, 3)).astype(np.float32)

    pids = lambda: [os.getpid()] + [pr.pid for pr in spawned]  # noqa: E731
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        run_chain(stages, params, inputs(), hop_tiers=["shm", "shm"],
                  tier="shm", on_spawn=spawned.extend, spawn_retries=1,
                  device="cpu")
    assert time.monotonic() - t0 < 150, "kill-9 teardown hung"
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if all(pr.poll() is not None for pr in spawned):
            break
        time.sleep(0.2)
    assert all(pr.poll() is not None for pr in spawned)
    sweep_orphan_segments()
    assert _segments(pids()) <= before, _segments(pids()) - before
