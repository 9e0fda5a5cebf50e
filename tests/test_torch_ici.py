"""Port parity: the device-resident transport tier
(``defer_tpu_torch.transport.ici``) and the tier ladder, mirroring
``tests/test_ici.py``: live-tensor handoff, same-mesh negotiation and the
ladder's rung order, host-sync observability, bfloat16 on every tier, and
the chain's tier, device and overlap validation.

Everything runs in the test process on the CPU (``device="cpu"``), where
the ici tier hands CPU tensors over by reference; the CUDA half (a
device-resident hop on the card: no host sync, rows equal to the tcp
hop's) is ``tests/test_torch_cuda.py::test_ici_hop_on_card``.  The
cross-device move cannot run on one card or the CPU: its bookkeeping is
tested here with a stand-in tensor.  Tolerance: byte-identical (the same
programs on the same inputs).
"""

import os
import socket
import threading

import numpy as np
import pytest
import torch

from defer_tpu.transport import ici as jici
from defer_tpu_torch import models, partition
from defer_tpu_torch.graph import GraphBuilder, ops
from defer_tpu_torch.obs import REGISTRY
from defer_tpu_torch.runtime.node import (ChainDispatcher, StageNode,
                                          _normalize_hop_tiers, run_chain)
from defer_tpu_torch.transport import ici as I
from defer_tpu_torch.transport.framed import (K_CTRL, K_TENSOR, K_TENSOR_SEQ,
                                              PROTOCOL_VERSION, recv_frame,
                                              send_ctrl)
from defer_tpu_torch.transport.ici import IciPipe, IciSender, grant_ici
from defer_tpu_torch.transport.shm import answer_tier_probe, offer_tier_ladder

torch.set_num_threads(1)


def _counter(name: str) -> float:
    return REGISTRY.counter(name).value


def _hist_count(name: str) -> int:
    return int(REGISTRY.histogram(name).summary().get("count", 0))


# ---------------------------------------------------------------------------
# pipe semantics: live tensors, device placement
# ---------------------------------------------------------------------------

def test_pipe_same_device_passes_live_tensor_by_reference():
    p = IciPipe(depth=4)
    x = torch.arange(8, dtype=torch.float32)
    p.sender.dest_device = torch.device("cpu")
    p.sender.send(x)
    p.sender.send(x * 2, seq=5)
    p.sender.send_end()
    kind, got = p.receiver.get(1.0)
    assert kind == K_TENSOR and got is x  # by reference: no copy
    kind, (seq, got2) = p.receiver.get(1.0)
    assert kind == K_TENSOR_SEQ and seq == 5
    assert torch.equal(got2, torch.arange(8) * 2.0)
    assert p.sender.d2d == 0 and p.sender.device_pairs == set()


class _CardTensor:
    """A stand-in for a tensor on card ``index``: what ``IciSender.send``
    reads (``device``) and calls (``to``)."""

    def __init__(self, index, value):
        self.device = torch.device("cuda", index)
        self.value = value

    def to(self, device, non_blocking=False):
        assert non_blocking
        return _CardTensor(device.index, self.value)


def test_pipe_cross_device_send_pays_exactly_one_move(monkeypatch):
    """A hop between cards moves the tensor once (``ici_d2d``, the
    (src, dst) pair) after the producer's event, and hands the consumer
    the moved tensor with the event recorded after the move; a same-card
    frame and a host frame are passed as they are."""
    monkeypatch.setattr(torch, "Tensor", _CardTensor)
    events = []
    monkeypatch.setattr(I, "_record",
                        lambda t: (events.append(t.device.index) or
                                   f"ev{len(events)}", "stream"))
    moves = []

    def move(t, dest, event):
        moves.append((t.device.index, dest.index, event))
        return t.to(dest, non_blocking=True)

    monkeypatch.setattr(I, "_to_device", move)
    monkeypatch.setattr(I, "_adopt", lambda item: item)
    p = IciPipe(depth=4)
    p.sender.dest_device = torch.device("cuda", 1)
    before = _counter("transport.ici_d2d")
    p.sender.send(_CardTensor(0, 7.0))
    kind, got = p.receiver.get(1.0)
    assert kind == K_TENSOR and got.tensor.device == torch.device("cuda", 1)
    assert got.tensor.value == 7.0 and got.event == "ev2"
    assert moves == [(0, 1, "ev1")]
    assert p.sender.d2d == 1 and p.sender.device_pairs == {(0, 1)}
    assert _counter("transport.ici_d2d") == before + 1
    p.sender.send(_CardTensor(1, 8.0))       # already on the card
    p.sender.send(np.ones(4, np.float32))    # a host frame
    assert p.receiver.get(1.0)[1].tensor.value == 8.0
    assert isinstance(p.receiver.get(1.0)[1], np.ndarray)
    assert p.sender.d2d == 1 and len(moves) == 1


def test_handoff_orders_the_consumer_after_the_producer(monkeypatch):
    """The consumer's stream waits on the producer's event, and records
    the tensor on its stream when the streams differ."""
    calls = []

    class Stream:
        def __init__(self, name):
            self.name = name

        def wait_event(self, ev):
            calls.append(("wait", self.name, ev))

        def __eq__(self, other):
            return self.name == other.name

    class T:
        device = torch.device("cuda", 0)

        def record_stream(self, s):
            calls.append(("record", s.name))

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: Stream("consumer"))
    t = T()
    assert I._adopt(I._Handoff(t, "ev", Stream("producer"))) is t
    assert calls == [("wait", "consumer", "ev"), ("record", "consumer")]
    calls.clear()
    I._adopt(I._Handoff(t, "ev", Stream("consumer")))
    assert calls == [("wait", "consumer", "ev")]  # same stream: no record


# ---------------------------------------------------------------------------
# grant validation: same process AND same mesh
# ---------------------------------------------------------------------------

def _probe(pipe: IciPipe, **over) -> dict:
    msg = {"cmd": "tier_probe", "want": "ici", "pid": os.getpid(),
           "proto": PROTOCOL_VERSION, "token": I._register(pipe),
           "backend": "torch", "platform": "cpu", "device_ids": [0]}
    msg.update(over)
    return msg


def test_grant_checks_in_order():
    assert grant_ici(_probe(IciPipe())) is not None
    assert grant_ici(_probe(IciPipe(), proto=PROTOCOL_VERSION + 1)) is None
    assert grant_ici(_probe(IciPipe(), pid=1)) is None
    assert grant_ici(_probe(IciPipe(), backend="cpu")) is None  # a JAX peer
    # the same-mesh proof: an unresolvable device index refuses
    assert grant_ici(_probe(IciPipe(), device_ids=[10 ** 6])) is None
    assert grant_ici(_probe(IciPipe(), device_ids=[])) is None
    assert grant_ici(_probe(IciPipe(), platform="warp")) is None
    # a host sender into a stage on the card: another platform
    assert grant_ici(_probe(IciPipe()), device=torch.device("cuda")) is None
    msg = _probe(IciPipe())
    assert grant_ici(msg, device=torch.device("cpu")) is not None
    assert grant_ici(msg) is None  # the token claims exactly once


def test_the_packages_refuse_each_others_ici():
    """A JAX ici probe is refused by the port's grant (another backend,
    another registry) and a port probe by the JAX package's."""
    import jax
    jmsg = {"cmd": "tier_probe", "want": "ici", "pid": os.getpid(),
            "proto": PROTOCOL_VERSION,
            "token": jici._register(jici.IciPipe()),
            "backend": jax.default_backend(),
            "platform": jax.devices()[0].platform,
            "device_ids": [jax.devices()[0].id]}
    assert grant_ici(jmsg) is None
    assert jici.grant_ici(_probe(IciPipe())) is None


# ---------------------------------------------------------------------------
# the ladder: ici > local > shm > tcp, one fallback
# ---------------------------------------------------------------------------

def _ladder_peer(conn, *, grants: dict):
    """Serve tier probes on ``conn``: grant a want iff grants[want]."""
    def run():
        while True:
            kind, msg = recv_frame(conn)
            if kind != K_CTRL:
                return
            if grants.get(msg.get("want")):
                answer_tier_probe(conn, msg, accept=True)
                return
            send_ctrl(conn, {"cmd": "tier_reply", "tier": "tcp"})

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_auto_ladder_prefers_ici_over_local():
    a, b = socket.socketpair()
    t = _ladder_peer(b, grants={"ici": True, "local": True})
    fb0 = _counter("transport.tier_fallback")
    tier, tx, fell = offer_tier_ladder(a, tier="auto", hop="t",
                                       device=torch.device("cpu"))
    t.join(timeout=5)
    assert tier == "ici" and isinstance(tx, IciSender) and not fell
    assert tx.dest_device is None  # the grantor named no device
    assert _counter("transport.tier_fallback") == fb0
    a.close(), b.close()


def test_refused_ici_degrades_to_local_not_tcp():
    a, b = socket.socketpair()
    t = _ladder_peer(b, grants={"ici": False, "local": True})
    fb0 = _counter("transport.tier_fallback")
    tier, tx, fell = offer_tier_ladder(a, tier="auto", hop="t")
    t.join(timeout=5)
    assert tier == "local" and tx is not None and not fell
    assert _counter("transport.tier_fallback") == fb0
    a.close(), b.close()


def test_all_rungs_refused_counts_exactly_one_fallback():
    a, b = socket.socketpair()
    wants = []

    def refuse_all():
        for _ in range(3):  # ici, local, shm
            kind, msg = recv_frame(b)
            assert kind == K_CTRL
            wants.append(msg["want"])
            send_ctrl(b, {"cmd": "tier_reply", "tier": "tcp"})

    t = threading.Thread(target=refuse_all, daemon=True)
    t.start()
    fb0 = _counter("transport.tier_fallback")
    hop0 = _counter("transport.tier_fallback.hopX")
    tier, tx, fell = offer_tier_ladder(a, tier="auto", hop="hopX")
    t.join(timeout=5)
    assert (tier, tx, fell) == ("tcp", None, True)
    assert wants == ["ici", "local", "shm"]
    assert _counter("transport.tier_fallback") == fb0 + 1
    assert _counter("transport.tier_fallback.hopX") == hop0 + 1
    a.close(), b.close()


@pytest.mark.parametrize("pin", ["shm", "local", "ici"])
def test_pinned_tiers_offer_only_their_rung(pin):
    a, b = socket.socketpair()
    wants = []

    def peer():
        while True:
            try:
                kind, msg = recv_frame(b)
            except (ConnectionError, OSError):
                return
            if kind != K_CTRL:
                return
            wants.append(msg.get("want"))
            send_ctrl(b, {"cmd": "tier_reply", "tier": "tcp"})

    t = threading.Thread(target=peer, daemon=True)
    t.start()
    tier, tx, fell = offer_tier_ladder(a, tier=pin, hop="t")
    assert (tier, tx, fell) == ("tcp", None, True)
    assert wants == [pin], f"pin {pin} leaked offers: {wants}"
    a.close(), b.close()
    t.join(timeout=5)


# ---------------------------------------------------------------------------
# in-process chains: device-resident end to end
# ---------------------------------------------------------------------------

def _run_chain_inproc(stages, params, xs, *, tier, accepts=None):
    n = len(stages)
    nodes = [StageNode(None, "127.0.0.1:0", None, device="cpu", tier=tier,
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
    return outs, stats, disp


@pytest.fixture(scope="module")
def tiny():
    g = models.resnet_tiny()
    return g, g.init(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def chain3(tiny):
    g, params = tiny
    stages = partition(g, num_stages=3)
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
          for _ in range(5)]
    outs, stats, _ = _run_chain_inproc(stages, params, xs, tier="tcp")
    return params, stages, xs, outs, stats


def test_tcp_pin_suppresses_every_offer(chain3):
    _, _, xs, _, stats = chain3
    assert [s["tier"] for s in stats] == ["tcp"] * 3
    assert [s["tier_in"] for s in stats] == [None] * 3  # never probed
    assert [s["ici_d2d"] for s in stats] == [0] * 3


def test_ici_chain_device_resident_end_to_end(chain3):
    """Every hop (the dispatcher's edges too) negotiates ici under
    ``auto``, rows are byte-identical to the tcp chain's, no codec and no
    host_sync sample lands on any node, 4 hops x frames go through the
    pipes, and the one host copy per frame is at the result edge."""
    params, stages, xs, base, _ = chain3
    enc0, dec0 = _hist_count("codec.encode_s"), _hist_count("codec.decode_s")
    hs0 = _hist_count("node.host_sync_s")
    chs0 = _hist_count("chain.host_sync_s")
    if0 = _counter("transport.ici_frames")
    outs, stats, disp = _run_chain_inproc(stages, params, xs, tier="auto")
    assert [s["tier"] for s in stats] == ["ici"] * 3
    assert [s["tier_in"] for s in stats] == ["ici"] * 3
    assert (disp.tier_out, disp.tier_in) == ("ici", "ici")
    assert [s["device"] for s in stats] == ["cpu"] * 3
    for a, b in zip(base, outs):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(a, b)
    assert _hist_count("codec.encode_s") == enc0
    assert _hist_count("codec.decode_s") == dec0
    assert _hist_count("node.host_sync_s") == hs0
    assert [s["host_sync_s"]["count"] for s in stats] == [0] * 3
    assert [(s["ici_d2d"], s["ici_device_pairs"]) for s in stats] \
        == [(0, [])] * 3
    assert _counter("transport.ici_frames") - if0 == 4 * len(xs)
    assert _hist_count("chain.host_sync_s") - chs0 == len(xs)


def test_local_chain_pays_host_sync_ici_removes(chain3):
    params, stages, xs, _, _ = chain3
    outs, stats, _ = _run_chain_inproc(stages, params, xs, tier="local")
    assert [s["tier"] for s in stats] == ["local"] * 3
    assert [s["host_sync_s"]["count"] for s in stats] == [len(xs)] * 3


def test_refused_ici_chain_degrades_with_labeled_fallback(chain3):
    params, stages, xs, base, _ = chain3
    before = _counter("transport.tier_fallback")
    outs, stats, _ = _run_chain_inproc(stages, params, xs, tier="ici",
                                       accepts=[True, False, True])
    assert _counter("transport.tier_fallback") == before + 1
    by_stage = {s["stage"]: s for s in stats}
    assert by_stage[0]["tier"] == "tcp" and by_stage[0]["tier_fallbacks"] == 1
    assert by_stage[1]["tier"] == "ici"
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b)


def test_handed_over_tensor_is_unchanged_after_the_consumer_ran(tiny):
    """Stage programs are functional: the tensor an ici hop hands over is
    the producer's output itself, and the consuming program leaves it as
    it was."""
    from defer_tpu_torch.utils.export import (export_stage_bytes,
                                              load_stage_program)
    g, params = tiny
    s0, s1 = partition(g, num_stages=2)
    p0 = load_stage_program(export_stage_bytes(s0, params), device="cpu")
    p1 = load_stage_program(export_stage_bytes(s1, params), device="cpu")
    pipe = IciPipe()
    y = p0(np.random.default_rng(0).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    keep = y.clone()
    pipe.sender.send(y)
    _, got = pipe.receiver.get(1.0)
    assert got is y
    p1(got)
    assert torch.equal(y, keep)


def test_extension_dtype_roundtrips_every_tier():
    """bfloat16 activations cross tcp frames, shm descriptors, local and
    ici pipes as themselves: byte-identical on every tier."""
    b = GraphBuilder("bf16chain")
    x = b.input((32,))
    x = b.add(ops.Dense(32), x, name="d0")
    x = b.add(ops.Cast("bfloat16"), x, name="half")
    b.add(ops.Dense(16), x, name="head")
    g = b.build()
    params = g.init(torch.Generator().manual_seed(1))
    stages = partition(g, ["d0", "half"])  # hop 1->2 carries bf16
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((1, 32)).astype(np.float32) for _ in range(3)]
    base, _, _ = _run_chain_inproc(stages, params, xs, tier="tcp")
    for tier, want in (("shm", "shm"), ("local", "local"), ("auto", "ici")):
        outs, stats, _ = _run_chain_inproc(stages, params, xs, tier=tier)
        assert stats[1]["tier"] == want
        for a, bb in zip(base, outs):
            assert isinstance(bb, torch.Tensor) and bb.dtype == torch.bfloat16
            assert torch.equal(a, bb)


# ---------------------------------------------------------------------------
# guard rails
# ---------------------------------------------------------------------------

def test_ici_hop_tiers_validation():
    assert _normalize_hop_tiers(["ici", "auto"], 3, "tcp") == ["ici", "auto"]
    assert _normalize_hop_tiers(None, 3, "shm") == ["shm", "shm"]
    with pytest.raises(ValueError, match="ici"):
        _normalize_hop_tiers(["warp"], 2, "tcp")
    with pytest.raises(ValueError, match="one entry per inter-stage hop"):
        _normalize_hop_tiers(["ici"], 3, "tcp")


def test_ici_hop_tiers_require_overlap(tiny):
    g, params = tiny
    stages = partition(g, num_stages=3)
    with pytest.raises(ValueError, match="overlap"):
        run_chain(stages, params, [], overlap=False,
                  hop_tiers=["ici", "tcp"], device="cpu")


@pytest.mark.parametrize("t", ["ici", "local"])
def test_chain_level_ici_tier_rejected_loudly(tiny, t):
    """``tier`` also claims the dispatcher's edges, which cross processes
    in a spawned chain: ici/local there are refused with a pointer at
    ``hop_tiers``."""
    g, params = tiny
    stages = partition(g, num_stages=3)
    with pytest.raises(ValueError, match="hop_tiers"):
        run_chain(stages, params, [], tier=t, device="cpu")


def test_device_pin_validation(tiny, tmp_path):
    g, params = tiny
    stages = partition(g, num_stages=3)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="out of range"):
        StageNode(None, "127.0.0.1:0", None, device=have + 7)
    with pytest.raises(ValueError, match="out of range"):
        run_chain(stages, params, [], device_map={9: 0}, device="cpu")
    with pytest.raises(ValueError, match="devices=2"):
        run_chain(stages, params, [], devices=2, device_map={0: 5},
                  device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        run_chain(stages, params, [], device_map={0: -1}, device="cpu")
    with pytest.raises(ValueError, match="fusion"):
        run_chain(stages, params, [], device_map={2: 1},
                  hop_tiers=["device", "ici"], device="cpu")
    with pytest.raises(ValueError, match="this process sees 0"):
        run_chain(stages, params, [], devices=1, device="cpu")
    # set_device re-places a loaded program, and checks the pin first
    from defer_tpu_torch.utils.export import export_stage
    path = str(tmp_path / "s0.zip")
    export_stage(stages[0], params, path)
    node = StageNode(path, "127.0.0.1:0", None, device="cpu")
    try:
        with pytest.raises(ValueError, match="out of range"):
            node.set_device(have + 7)
        node.set_device("cpu")
        assert node.device == torch.device("cpu")
        assert node.prog.device == torch.device("cpu")
    finally:
        node._srv.close()


def test_stage_delays_on_a_co_stage_raise(tiny):
    """A bench delay rides a process's own node: a stage that boards
    another's process behind an ici or local hop cannot take one (the
    JAX package drops it silently; ROADMAP §C)."""
    g, params = tiny
    stages = partition(g, num_stages=3)
    with pytest.raises(ValueError, match="co-stage"):
        run_chain(stages, params, [], hop_tiers=["ici", "tcp"],
                  stage_delays=[0.0, 0.1, 0.0], device="cpu")
