"""Port parity: the colocated transport tier (``defer_tpu_torch.transport
.local``) and ``device``-tier fusion, mirroring ``tests/test_colocate.py``:
local-pipe semantics, negotiation and fallback, fused stages, and the
port's chain on every tier against the JAX chain.

Stage nodes serve on threads of the test process (``device="cpu"``).
Weights are JAX's seeded ``init`` carried over with ``params_from_jax``;
inputs come from numpy seeds.  Tolerances: a chain on any tier against the
port's tcp chain, byte-identical (the same programs on the same inputs; a
colocated hop moves the same bytes); the port's chain against the JAX
chain, rtol and atol 2e-4 (``tests/test_torch_node_chain.py``'s bound:
convolutions sum in another order than XLA's).
"""

import os
import socket
import threading

import numpy as np
import pytest
import torch

import jax

from defer_tpu import partition as jax_partition
from defer_tpu.models import resnet_tiny as jax_resnet_tiny
from defer_tpu.runtime import node as jnode
from defer_tpu.transport import local as jlocal
from defer_tpu_torch import models, params_from_jax, partition
from defer_tpu_torch.obs import REGISTRY
from defer_tpu_torch.obs.events import recorder
from defer_tpu_torch.partition import fuse_stages
from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode
from defer_tpu_torch.transport import local as L
from defer_tpu_torch.transport.channel import ChannelError
from defer_tpu_torch.transport.framed import (K_CTRL, K_END, K_TENSOR,
                                              K_TENSOR_SEQ, PROTOCOL_VERSION,
                                              configure_socket, recv_frame,
                                              send_ctrl)
from defer_tpu_torch.transport.local import (LocalPipe, grant_local,
                                             offer_local)

torch.set_num_threads(1)

TOL = 2e-4


def _counter(name: str) -> float:
    return REGISTRY.counter(name).value


def _hist_count(name: str) -> int:
    return int(REGISTRY.histogram(name).summary().get("count", 0))


# ---------------------------------------------------------------------------
# LocalPipe semantics
# ---------------------------------------------------------------------------

def test_pipe_roundtrip_order_seq_ctrl_end():
    p = LocalPipe(depth=8)
    a = np.arange(6, dtype=np.float32)
    p.sender.send_ctrl({"cmd": "trace", "trace_id": "t"})
    p.sender.send(a)
    p.sender.send(a * 2, seq=7)
    p.sender.send_end()
    assert p.receiver.get(1.0) == (K_CTRL, {"cmd": "trace",
                                            "trace_id": "t"})
    kind, v = p.receiver.get(1.0)
    assert kind == K_TENSOR and v is a  # by reference: no copy
    kind, (seq, v) = p.receiver.get(1.0)
    assert kind == K_TENSOR_SEQ and seq == 7
    np.testing.assert_array_equal(v, a * 2)
    assert p.receiver.get(1.0) == (K_END, None)


def test_pipe_backpressure_is_bounded():
    """A slow consumer parks the producer after ``depth`` frames."""
    p = LocalPipe(depth=2)
    sent = []

    def produce():
        for i in range(6):
            p.sender.send(i)
            sent.append(i)
        p.sender.send_end()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    t.join(timeout=0.5)
    assert t.is_alive() and len(sent) <= 3  # parked on the full queue
    got = []
    while True:
        kind, v = p.receiver.get(2.0)
        if kind == K_END:
            break
        got.append(v)
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert got == list(range(6))  # in order, nothing dropped


def test_pipe_sender_death_fails_receiver():
    p = LocalPipe()
    p.sender.send(1)
    p.sender.detach()  # abandoned without an END: a cut connection
    assert p.receiver.get(1.0) == (K_TENSOR, 1)
    with pytest.raises(ConnectionError):
        p.receiver.get(1.0)
    with pytest.raises(ConnectionError):
        p.receiver.get_nowait()


def test_pipe_clean_end_then_detach_is_noop():
    p = LocalPipe()
    p.sender.close()
    p.sender.detach()
    assert p.receiver.get(1.0) == (K_END, None)


def test_pipe_receiver_death_wakes_parked_sender():
    p = LocalPipe(depth=1)
    p.sender.send(0)
    err = []

    def produce():
        try:
            p.sender.send(1)  # parks on the full queue
        except ChannelError as e:
            err.append(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive()
    p.receiver.release_gauge()  # the consumer's stream loop exited
    t.join(timeout=5.0)
    assert not t.is_alive() and err, "parked producer never woke"


def test_pipe_gauge_reconciles():
    p = LocalPipe(depth=4)
    p.sender.send(0)
    p.receiver.bind_gauge("test.torch_colo_gauge")
    g = REGISTRY.gauge("test.torch_colo_gauge")
    base = g.value
    p.sender.send(1)
    assert g.value == base + 1
    p.receiver.get(1.0)
    assert g.value == base
    p.receiver.release_gauge()  # returns the remaining occupancy
    assert g.value == base - 1


@pytest.mark.timeout(60)
def test_pipe_gauge_holds_under_thread_switching():
    """A gauge bound while the producer is mid-stream counts each frame
    once: with a tiny switch interval, it returns to its base once the
    consumer has taken every frame."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        p = LocalPipe(depth=4)
        g = REGISTRY.gauge("test.torch_colo_stress")
        base = g.value

        def produce():
            for i in range(2000):
                p.sender.send(i)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        got = [p.receiver.get(5.0)[1] for _ in range(50)]
        p.receiver.bind_gauge("test.torch_colo_stress")
        got += [p.receiver.get(5.0)[1] for _ in range(1950)]
        t.join(10)
        assert not t.is_alive() and got == list(range(2000))
        assert g.value == base
    finally:
        sys.setswitchinterval(old)


# ---------------------------------------------------------------------------
# negotiation: grant validation + fallback
# ---------------------------------------------------------------------------

def _probe_msg(pipe: LocalPipe) -> dict:
    return {"cmd": "tier_probe", "want": "local", "pid": os.getpid(),
            "proto": PROTOCOL_VERSION, "token": L._register(pipe)}


@pytest.mark.parametrize("field,value", [
    ("pid", "another process"), ("proto", PROTOCOL_VERSION + 1),
    ("token", "not-a-registered-token"), ("want", "shm")])
def test_grant_rejects_a_broken_claim(field, value):
    """Distinct pid, version mismatch, unknown token, another rung."""
    msg = _probe_msg(LocalPipe())
    msg[field] = os.getpid() + 1 if value == "another process" else value
    assert grant_local(msg) is None


def test_grant_claims_exactly_once():
    pipe = LocalPipe()
    msg = _probe_msg(pipe)
    assert grant_local(msg) is pipe
    assert grant_local(msg) is None  # a token is single-use


def test_registries_of_the_two_packages_are_separate():
    """A JAX package probe never resolves in the port's registry, nor a
    port probe in the JAX package's: a pipe is never spliced across the
    packages (their hops fall to shm)."""
    jmsg = {"cmd": "tier_probe", "want": "local", "pid": os.getpid(),
            "proto": PROTOCOL_VERSION,
            "token": jlocal._register(jlocal.LocalPipe())}
    assert grant_local(jmsg) is None
    assert jlocal.grant_local(_probe_msg(LocalPipe())) is None


def test_offer_refused_degrades_and_counts():
    """A refused offer comes back ("tcp", None) with one fallback (the
    global counter, its labeled twin and a ``tier_fallback`` event), and
    the socket stays usable for the wire path."""
    a, b = socket.socketpair()

    def peer():
        kind, msg = recv_frame(b)
        assert kind == K_CTRL and msg["cmd"] == "tier_probe"
        send_ctrl(b, {"cmd": "tier_reply", "tier": "tcp"})

    t = threading.Thread(target=peer, daemon=True)
    t.start()
    before = _counter("transport.tier_fallback")
    hop0 = _counter("transport.tier_fallback.colo7")
    cur = recorder().cursor()
    tier, pipe = offer_local(a, hop="colo7")
    t.join(timeout=5.0)
    assert (tier, pipe) == ("tcp", None)
    assert _counter("transport.tier_fallback") == before + 1
    assert _counter("transport.tier_fallback.colo7") == hop0 + 1
    _, evs = recorder().events_since(cur)
    assert [e["data"] for e in evs if e["kind"] == "tier_fallback"] \
        == [{"hop": "colo7"}]
    a.close()
    b.close()


def test_offer_granted_over_socketpair():
    a, b = socket.socketpair()
    got = {}

    def peer():
        kind, msg = recv_frame(b)
        got["pipe"] = grant_local(msg)
        send_ctrl(b, {"cmd": "tier_reply", "tier": "local"})

    t = threading.Thread(target=peer, daemon=True)
    t.start()
    tier, pipe = offer_local(a)
    t.join(timeout=5.0)
    assert tier == "local" and pipe is not None
    assert got["pipe"] is pipe  # both ends hold the same pipe
    arr = np.ones(3, np.float32)
    pipe.sender.send(arr)
    kind, v = got["pipe"].receiver.get(1.0)
    assert kind == K_TENSOR and v is arr
    a.close()
    b.close()


def test_configure_socket_skips_non_sockets():
    sentinel = object()
    assert configure_socket(sentinel) is sentinel
    pipe = LocalPipe()
    assert configure_socket(pipe.sender) is pipe.sender
    assert configure_socket(pipe.receiver) is pipe.receiver


# ---------------------------------------------------------------------------
# in-process chains: byte identity across tiers, parity with JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jg = jax_resnet_tiny()
    jp = jg.init(jax.random.key(0))
    g = models.resnet_tiny()
    p = params_from_jax(g, jax.tree.map(np.asarray, jp))
    return jg, jp, g, p


def _run_chain_inproc(stages, params, xs, *, tier, node_tiers=None,
                      accepts=None):
    """Thread-per-node chain on the CPU; returns (outs, stats, disp)."""
    n = len(stages)
    tiers = node_tiers or [tier] * n
    nodes = [StageNode(None, "127.0.0.1:0", None, device="cpu",
                       tier=tiers[i],
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
                    tiers=tiers)
        outs = disp.stream(xs)
        stats = disp.stats(addrs)
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return outs, stats, disp


@pytest.fixture(scope="module")
def chain3(tiny):
    jg, jp, g, p = tiny
    jstages = jax_partition(jg, num_stages=3)
    stages = partition(g, [s.output_name for s in jstages[:-1]])
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
          for _ in range(5)]
    outs, stats, _ = _run_chain_inproc(stages, p, xs, tier="tcp")
    return p, stages, jstages, xs, outs, stats


def test_local_chain_byte_identical_no_codec_work(chain3):
    """All-local chain: every hop negotiates local, rows byte-identical to
    the tcp chain's, no ``codec.*`` sample recorded, and 4 hops x frames
    through the pipes."""
    p, stages, _, xs, base, base_stats = chain3
    assert [s["tier"] for s in base_stats] == ["tcp"] * 3
    enc0, dec0 = _hist_count("codec.encode_s"), _hist_count("codec.decode_s")
    lf0 = _counter("transport.local_frames")
    outs, stats, disp = _run_chain_inproc(stages, p, xs, tier="local")
    assert [s["tier"] for s in stats] == ["local"] * 3
    assert [s["tier_in"] for s in stats] == ["local"] * 3
    assert (disp.tier_out, disp.tier_in) == ("local", "local")
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b)
    assert _hist_count("codec.encode_s") == enc0
    assert _hist_count("codec.decode_s") == dec0
    assert _counter("transport.local_frames") - lf0 == 4 * len(xs)


def test_mixed_tier_chain_byte_identical(chain3):
    p, stages, _, xs, base, _ = chain3
    outs, stats, _ = _run_chain_inproc(stages, p, xs, tier="tcp",
                                       node_tiers=["local", "tcp", "local"])
    # s0->s1 local; s1->s2 stays tcp; s2->result refused by the tcp
    # dispatcher (tier_accept False) -> degrades to tcp
    assert [s["tier"] for s in stats] == ["local", "tcp", "tcp"]
    assert [s["tier_fallbacks"] for s in stats] == [0, 0, 1]
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b)


def test_claimed_colocation_degrades_to_tcp(chain3):
    """A hop that claims colocation but is refused degrades to tcp, the
    stream stays byte-identical, one fallback is counted, and the node
    emits a ``tier`` event naming the outcome."""
    p, stages, _, xs, base, _ = chain3
    before = _counter("transport.tier_fallback")
    cur = recorder().cursor()
    outs, stats, _ = _run_chain_inproc(stages, p, xs, tier="local",
                                       accepts=[True, False, True])
    assert _counter("transport.tier_fallback") == before + 1
    by_stage = {s["stage"]: s for s in stats}
    assert by_stage[0]["tier"] == "tcp"    # its offer to stage 1: refused
    assert by_stage[0]["tier_fallbacks"] == 1
    assert by_stage[1]["tier"] == "local"  # stage 2 still granted
    _, evs = recorder().events_since(cur)
    tier_evs = [e["data"] for e in evs if e["kind"] == "tier"
                and e["data"]["hop"] == "stage0"]
    assert tier_evs == [{"hop": "stage0", "tier": "tcp", "wanted": "local",
                         "fallback": True}]
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b)


def test_fused_chain_byte_identical(chain3):
    """A ``device`` hop fuses two stages into one program: the hop (its
    frames) ceases to exist, the rows do not change."""
    p, stages, _, xs, base, _ = chain3
    fused, groups = fuse_stages(stages, ["device", "local"])
    assert groups == [[0, 1], [2]] and len(fused) == 2
    assert fused[0].node_names == stages[0].node_names + stages[1].node_names
    outs, stats, _ = _run_chain_inproc(fused, p, xs, tier="auto")
    assert [s["stage"] for s in stats] == [0, 1]
    assert [s["processed"] for s in stats] == [len(xs)] * 2
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b)


def test_fuse_stages_validates():
    g = models.resnet_tiny()
    stages = partition(g, num_stages=3)
    with pytest.raises(ValueError, match="hop tiers"):
        fuse_stages(stages, ["device"])  # wrong arity
    same, groups = fuse_stages(stages, ["tcp", "local"])
    assert len(same) == 3 and groups == [[0], [1], [2]]
    one, groups = fuse_stages(stages, ["device", "device"])
    assert len(one) == 1 and groups == [[0, 1, 2]]
    assert one[0].output_name == g.output_name


def test_fused_bert_group_exports_as_one_program_with_flash_per_block():
    """A fused BERT group exports as one ``torch.export`` program that
    still carries the ``defer_tpu_torch::flash_attention`` operator once
    per block."""
    from defer_tpu_torch.utils.export import (export_stage_bytes,
                                              load_stage_program)
    g = models.bert_tiny()
    p = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=2)
    (fused,), _ = fuse_stages(stages, ["device"])
    prog = load_stage_program(export_stage_bytes(fused, p, batch=2),
                              device="cpu")
    flash = [n for n in prog.graph.nodes if n.op == "call_function"
             and "flash_attention" in str(n.target)]
    blocks = sum(name.startswith("block_") for name in g.topo_order)
    assert len(flash) == blocks >= 2


def _jax_inproc(stages, params, xs):
    """The JAX package's in-process tcp chain on the same inputs."""
    nodes = [jnode.StageNode(None, "127.0.0.1:0", None) for _ in stages]
    addrs = [f"127.0.0.1:{nd.address[1]}" for nd in nodes]
    threads = [threading.Thread(target=nd.serve, daemon=True)
               for nd in nodes]
    for t in threads:
        t.start()
    disp = jnode.ChainDispatcher(addrs[0], codec="raw")
    try:
        disp.deploy(stages, params, addrs, batch=xs[0].shape[0])
        outs = disp.stream(xs)
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=60)
    return [np.asarray(y) for y in outs]


@pytest.fixture(scope="module")
def jax_rows(tiny, chain3):
    _, stages, jstages, xs, _, _ = chain3
    return _jax_inproc(jstages, tiny[1], xs)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("tier", ["local", "shm", "ici", "device"])
def test_tier_chain_rows_equal_jax_chain_rows(chain3, jax_rows, tier):
    """The port's chain on each tier against the JAX chain (tcp) on the
    same weights and inputs, within 2e-4, and byte-identical to the
    port's tcp chain; ``device`` fuses the three stages into one."""
    p, stages, _, xs, base, _ = chain3
    if tier == "device":
        stages, _ = fuse_stages(stages, ["device", "device"])
    outs, stats, _ = _run_chain_inproc(
        stages, p, xs, tier="auto" if tier == "device" else tier)
    assert len(stats) == len(stages)
    for y, b, jy in zip(outs, base, jax_rows):
        np.testing.assert_array_equal(y, b)
        np.testing.assert_allclose(y, jy, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# co-stages: one OS process for a run of local/ici hops
# ---------------------------------------------------------------------------

@pytest.mark.timeout(240)
def test_run_chain_colocates_ici_and_local_hops(chain3):
    """``hop_tiers=["ici", "local"]`` runs the three stages as one node
    process with two ``--co-stage`` threads: the hops report ici and
    local, the ici node records no host sync, the dispatcher's edges
    (another process) take shm, and the rows equal the tcp chain's."""
    from defer_tpu_torch.runtime.node import run_chain
    p, stages, _, xs, base, _ = chain3
    spawned, stats = [], []
    outs = run_chain(stages, p, xs, hop_tiers=["ici", "local"],
                     in_band=True, device="cpu", stats_out=stats,
                     on_spawn=spawned.extend)
    assert len(spawned) == 1
    assert [s["tier"] for s in stats] == ["ici", "local", "shm"]
    assert [s["tier_in"] for s in stats] == ["shm", "ici", "local"]
    assert [s["host_sync_s"]["count"] for s in stats] == [0, 5, 5]
    assert all(s["tier_fallbacks"] == 0 for s in stats)
    for a, b in zip(base, outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec,want", [
    ("listen=127.0.0.1:5;next=a:1,b:2;accept=1;device=2",
     {"listen": "127.0.0.1:5", "next": "a:1,b:2", "accept": "1",
      "device": 2}),
    ("listen=:7;tier=ici", {"listen": ":7", "tier": "ici"}),
    ("next=a:1", "needs listen=host:port"),
    ("listen=:1;oops", "is not key=value"),
    ("listen=:1;color=red", "unknown keys"),
    ("listen=:1;accept=2", "accept must be 0|1"),
    ("listen=:1;device=cuda", "device must be an integer")])
def test_co_stage_grammar(spec, want):
    from defer_tpu_torch.cli import _parse_co_stage
    if isinstance(want, dict):
        assert _parse_co_stage(spec) == want
    else:
        with pytest.raises(SystemExit, match=want):
            _parse_co_stage(spec)


def test_chain_cli_rejects_a_bad_device_map():
    from defer_tpu_torch import cli
    with pytest.raises(SystemExit, match="stageK=J"):
        cli.main(["chain", "--device", "cpu", "--device-map", "0=1"])
    with pytest.raises(SystemExit):
        cli.main(["chain", "--device", "cpu", "--tier", "ici"])
