"""Port parity: the stage-node chain (``defer_tpu_torch.runtime.node``)
against the JAX package's, mirroring ``tests/test_node_chain.py`` and
``tests/test_channel.py:193-233``.

Stage nodes serve on threads of the test process (``device="cpu"``) and
are deployed in-band by a ``ChainDispatcher``; a few tests spawn real
processes through ``spawn_nodes``, ``run_chain`` and the ``chain``
command.  Weights are JAX's seeded ``init``
carried over with ``params_from_jax``; inputs come from numpy seeds.  A
mixed chain runs a JAX node beside a port node, each direction under the
other package's dispatcher: the frames on the wire are byte-identical in
both packages.

Tolerances, with their reasons:

* port chain rows against the JAX chain and the JAX forward: rtol 2e-4
  (atol 2e-4), the JAX chain tests' own bound; convolutions sum in
  another order than XLA's;
* a port chain against the port's own forward, lzb against raw, and the
  overlapped loop against the serial one under bf8: equal (the same ops
  on the same device; lzb is lossless; bf8 is deterministic).

Every socket test binds ``127.0.0.1:0`` and joins its threads with a
bound.
"""

import threading

import numpy as np
import pytest
import torch

import jax

from defer_tpu import partition as jax_partition
from defer_tpu.models import resnet_tiny as jax_resnet_tiny
from defer_tpu.runtime import node as jnode
from defer_tpu.utils import export as jexport
from defer_tpu_torch import models, params_from_jax, partition
from defer_tpu_torch.obs import REGISTRY, enable_tracing, tracer
from defer_tpu_torch.runtime import node as tnode
from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode, run_chain
from defer_tpu_torch.utils import export as texport

torch.set_num_threads(1)

TOL = 2e-4
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


def _inputs(seed, m, batch=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch,) + IN_SHAPE).astype(np.float32)
            for _ in range(m)]


def _forward(tiny, xs, params=None):
    _, _, g, p = tiny
    with torch.inference_mode():
        return [g.apply(params or p, torch.from_numpy(x)).numpy()
                for x in xs]


def _boot(n, **kw):
    nodes = [StageNode(None, "127.0.0.1:0", None, device="cpu", **kw)
             for _ in range(n)]
    addrs = [f"127.0.0.1:{nd.address[1]}" for nd in nodes]
    counts = {}

    def serve(i):
        counts[i] = nodes[i].serve()

    threads = [threading.Thread(target=serve, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    return nodes, addrs, threads, counts


def _join(threads):
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def _run_inproc(stages, params, xs, *, codec="raw", overlap=True):
    nodes, addrs, threads, _ = _boot(len(stages), overlap=overlap,
                                     inflight=2)
    disp = ChainDispatcher(addrs[0], codec=codec)
    try:
        disp.deploy(stages, params, addrs, batch=xs[0].shape[0])
        outs = disp.stream(xs)
    finally:
        disp.close()
    _join(threads)
    return outs


@pytest.mark.timeout(240)
def test_in_band_deploy_stream_stats_and_reweight(tiny):
    """Deploy in-band, stream, re-push weights over a fresh control
    connection mid-stream and stream again: rows equal the port's forward
    on each weight set and agree with the JAX chain's rows."""
    jg, jp, g, p = tiny
    jstages, stages = _stages(tiny, 2)
    nodes, addrs, threads, counts = _boot(2)
    disp = ChainDispatcher(addrs[0], codec="raw")
    disp.deploy(stages, p, addrs, batch=1)
    xs = _inputs(5, 3)
    out1 = disp.stream(xs)
    st = disp.stats(addrs)
    assert [s["stage"] for s in st] == [0, 1]
    assert all(s["processed"] == 3 and s["reweights"] == 0 for s in st)
    assert all(s["device"] == "cpu" and s["tier"] == "tcp" for s in st)
    assert all(s["infer_latency_s"]["count"] == 3 for s in st)
    assert set(st[0]["kernel_launches"]) == {"quant_int8",
                                             "flash_attention"}
    jst_keys = {"stage", "name", "replica", "branch", "join", "fan_in",
                "processed", "reweights", "codec", "tier", "tier_in",
                "tier_fallbacks", "device", "ici_d2d", "ici_device_pairs",
                "next", "tx_frames", "tx_bytes", "rx_frames", "rx_bytes",
                "infer_latency_s", "host_sync_s", "dispatch_s", "queue_s",
                "device_s", "recompiles", "mem_bytes", "profiling", "rx_s",
                "tx_s", "encode_latency_s", "decode_latency_s", "overlap",
                "rx_queue_depth", "tx_queue_depth", "rx_depth", "tx_depth",
                "rx_watermark", "tx_watermark", "inflight", "flops", "mfu",
                "achieved_flops_s", "failovers", "replay_depth",
                "merge_duplicates", "events"}
    assert jst_keys <= set(st[0])
    # run-time compilations are the process's: the deploy's two artifact
    # loads at least (the nodes share this process); no peak and no card
    # on the CPU, so neither MFU nor memory is a number
    assert st[0]["fan_in"] == 1 and st[0]["recompiles"] >= 2
    assert st[0]["recompiles"] == REGISTRY.counter("compiles").value
    assert st[0]["mfu"] is None and st[0]["mem_bytes"] is None
    assert st[0]["flops"] > 0 and st[0]["achieved_flops_s"] > 0
    p2 = {k: {n: v * 0.5 for n, v in d.items()} for k, d in p.items()}
    disp.reweight(stages, p2, addrs)
    out2 = disp.stream(xs)
    st2 = disp.stats(addrs)
    assert all(s["processed"] == 6 and s["reweights"] == 1 for s in st2)
    assert disp.quiesce(addrs) == [6, 6]
    disp.close()
    _join(threads)
    assert counts == {0: 6, 1: 6}
    for y, want in zip(out1, _forward(tiny, xs)):
        np.testing.assert_array_equal(y, want)
    for y, want in zip(out2, _forward(tiny, xs, p2)):
        np.testing.assert_array_equal(y, want)
    fwd = jax.jit(jg.apply)
    for x, y in zip(xs, out1):
        np.testing.assert_allclose(y, np.asarray(fwd(jp, x)), rtol=TOL,
                                   atol=TOL)


def _jax_inproc(stages, params, xs, *, codec="raw"):
    nodes = [jnode.StageNode(None, "127.0.0.1:0", None)
             for _ in range(len(stages))]
    addrs = [f"127.0.0.1:{nd.address[1]}" for nd in nodes]
    threads = [threading.Thread(target=nd.serve, daemon=True)
               for nd in nodes]
    for t in threads:
        t.start()
    disp = jnode.ChainDispatcher(addrs[0], codec=codec)
    try:
        disp.deploy(stages, params, addrs, batch=xs[0].shape[0])
        outs = disp.stream(xs)
    finally:
        disp.close()
    _join(threads)
    return outs


@pytest.mark.timeout(240)
def test_persistent_nodes_serve_segments_until_shutdown(tiny):
    """``persist=True`` nodes (``tests/test_replay.py``'s quiesce scenario):
    two stream segments, each ended by ``end_stream``, quiesce at the same
    stream position, the flight recorder answers ``events_since``, and
    ``shutdown_nodes`` returns each node's total."""
    from defer_tpu_torch.obs.events import recorder
    from defer_tpu_torch.transport.framed import (K_CTRL, connect_retry,
                                                  recv_expect, send_ctrl,
                                                  send_end)

    jstages, stages = _stages(tiny, 2)
    _, _, _, p = tiny
    nodes, addrs, threads, counts = _boot(2, persist=True)
    disp = ChainDispatcher(addrs[0], codec="raw")
    xs = _inputs(3, 3)
    try:
        disp.deploy(stages, p, addrs, batch=1)
        first = disp.stream(xs)
        assert disp.quiesce(addrs, timeout_s=30.0) == [3, 3]
        disp.end_stream()
        second = disp.stream(xs[:2])
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)
        assert disp.quiesce(addrs) == [5, 5]
        s = connect_retry("127.0.0.1", nodes[0].address[1])
        send_ctrl(s, {"cmd": "events_since", "cursor": 0})
        reply = recv_expect(s, K_CTRL)
        send_end(s)
        s.close()
        assert reply["cmd"] == "events_reply"
        assert reply["cursor"] == recorder().cursor()
        assert any(e["kind"] == "quiesce" for e in reply["events"])
    finally:
        disp.end_stream()
        disp.shutdown_nodes(addrs)
        disp.close()
    _join(threads)
    assert counts == {0: 5, 1: 5}


@pytest.mark.timeout(240)
def test_port_chain_rows_equal_jax_chain_rows(tiny):
    """Three stages, frames of two: the port chain's rows against the JAX
    chain's on the same weights and inputs."""
    jg, jp, g, p = tiny
    jstages, stages = _stages(tiny, 3)
    xs = _inputs(1, 4, batch=2)
    outs = _run_inproc(stages, p, xs)
    jouts = _jax_inproc(jstages, jp, xs)
    assert len(outs) == len(jouts) == 4
    for y, jy in zip(outs, jouts):
        assert y.shape == (2, 10) and y.dtype == np.float32
        np.testing.assert_allclose(y, np.asarray(jy), rtol=TOL, atol=TOL)


@pytest.mark.timeout(240)
def test_chain_with_lossless_codec_is_bit_transparent(tiny):
    jstages, stages = _stages(tiny, 2)
    _, _, _, p = tiny
    xs = _inputs(2, 3)
    raw = _run_inproc(stages, p, xs, codec="raw")
    lzb = _run_inproc(stages, p, xs, codec="lzb")
    for a, b in zip(raw, lzb):
        np.testing.assert_array_equal(a, b)


@pytest.mark.timeout(240)
def test_overlapped_chain_byte_identical_to_serial(tiny):
    """The overlap is a scheduling change only: under the deterministic
    bf8 codec the overlapped chain gives the serial chain's bytes, and the
    channel gauges are registered."""
    jstages, stages = _stages(tiny, 2)
    _, _, _, p = tiny
    xs = _inputs(11, 6)
    fast = _run_inproc(stages, p, xs, overlap=True, codec="bf8")
    slow = _run_inproc(stages, p, xs, overlap=False, codec="bf8")
    assert len(fast) == len(slow) == 6
    for y1, y2 in zip(fast, slow):
        np.testing.assert_array_equal(y1, y2)
    snap = REGISTRY.snapshot()
    for name in ("node.rx_queue_depth", "node.tx_queue_depth",
                 "node.inflight", "chain.tx_queue_depth",
                 "chain.rx_queue_depth"):
        assert name in snap, f"gauge {name} missing from the registry"


@pytest.mark.timeout(240)
def test_trace_spans_cascade_with_one_trace_id(tiny):
    """A traced stream: every stage adopts the dispatcher's context, its
    spans come back through ``collect_trace`` under one trace id, parented
    under the stream's root span, with the four phases per frame."""
    jstages, stages = _stages(tiny, 2)
    _, _, _, p = tiny
    tr = tracer()
    tr.clear()
    tr.start_trace()
    nodes, addrs, threads, _ = _boot(2)
    disp = ChainDispatcher(addrs[0], codec="raw")
    enable_tracing()
    try:
        disp.deploy(stages, p, addrs, batch=1)
        disp.stream(_inputs(3, 3))
        n = disp.collect_trace(addrs)
    finally:
        disp.close()
        tr.enabled = False
    _join(threads)
    spans = tr.drain()
    assert n > 0
    root = [s for s in spans if s["name"] == "chain.stream"]
    assert len(root) == 1
    assert {s["trace"] for s in spans} == {root[0]["trace"]}
    for k in (0, 1):
        for phase in ("infer", "dispatch", "queue", "host_sync"):
            got = [s for s in spans if s["name"] == f"stage{k}.{phase}"]
            assert len(got) == 3, (k, phase)
        assert all(s["parent"] == root[0]["span"] for s in spans
                   if s["name"] == f"stage{k}.infer")


@pytest.mark.timeout(240)
def test_waterfall_sampling_records_one_in_n_frames(tiny):
    """``trace_sample_every=2``: every frame carries its wire seq, and only
    the even seqs record per-frame spans, in every stage."""
    jstages, stages = _stages(tiny, 2)
    _, _, _, p = tiny
    tr = tracer()
    tr.clear()
    tr.start_trace()
    nodes, addrs, threads, _ = _boot(2)
    disp = ChainDispatcher(addrs[0], codec="raw", trace_sample_every=2)
    enable_tracing()
    try:
        disp.deploy(stages, p, addrs, batch=1)
        outs = disp.stream(_inputs(4, 5))
        disp.collect_trace(addrs)
    finally:
        disp.close()
        tr.enabled = False
    _join(threads)
    spans = tr.drain()
    assert len(outs) == 5
    for k in (0, 1):
        seqs = sorted(s["args"]["seq"] for s in spans
                      if s["name"] == f"stage{k}.infer")
        assert seqs == [0, 2, 4], (k, seqs)


def _mixed_jax_first(tiny, tmp_path, tier):
    """JAX node 0 (on its own artifact) -> port node 1 under the port's
    dispatcher, every hop's tier policy ``tier``; (rows, hop tiers, the
    fallbacks counted on the three hops)."""
    jg, jp, g, p = tiny
    jstages, stages = _stages(tiny, 2)
    jpath = str(tmp_path / f"j0{tier}.zip")
    tpath = str(tmp_path / f"t1{tier}.zip")
    jexport.export_stage(jstages[0], jp, jpath, batch=1)
    texport.export_stage(stages[1], p, tpath, batch=1)
    res = f"127.0.0.1:{tnode._free_ports(1)[0]}"
    tn = StageNode(tpath, "127.0.0.1:0", res, device="cpu", tier=tier)
    jn = jnode.StageNode(jpath, "127.0.0.1:0",
                         f"127.0.0.1:{tn.address[1]}", tier=tier)
    disp = ChainDispatcher(f"127.0.0.1:{jn.address[1]}", listen=res,
                           tier=tier)
    threads = [threading.Thread(target=n.serve, daemon=True)
               for n in (jn, tn)]
    for t in threads:
        t.start()
    try:
        outs = disp.stream(_inputs(7, 4))
    finally:
        disp.close()
    _join(threads)
    tiers = [disp.tier_out, jn.tier_in, jn.tier_out, tn.tier_in,
             tn.tier_out, disp.tier_in]
    return outs, tiers, (disp.tier_fallbacks, jn.tier_fallbacks,
                         tn.tier_fallbacks)


@pytest.mark.timeout(240)
def test_mixed_chain_jax_node_feeds_port_node(tiny, tmp_path):
    """A JAX StageNode on its own artifact feeds a port node, under the
    port's dispatcher.  With every policy ``auto`` each hop between the
    packages negotiates shm (their ici and local registries are separate,
    so those rungs are refused and the shared-memory ring is granted) with
    no fallback counted, the port node's result edge to the port's
    dispatcher in the same process takes ici, and the rows are
    byte-identical to the same chain over tcp."""
    jg, jp, g, p = tiny
    tcp, tcp_tiers, _ = _mixed_jax_first(tiny, tmp_path, "tcp")
    outs, tiers, fallbacks = _mixed_jax_first(tiny, tmp_path, "auto")
    assert tcp_tiers == ["tcp", None, "tcp", None, "tcp", None]
    assert tiers == ["shm"] * 4 + ["ici"] * 2
    assert fallbacks == (0, 0, 0)
    for a, b in zip(tcp, outs):
        np.testing.assert_array_equal(a, b)
    fwd = jax.jit(jg.apply)
    for x, y in zip(_inputs(7, 4), outs):
        np.testing.assert_allclose(y, np.asarray(fwd(jp, x)), rtol=TOL,
                                   atol=TOL)


def _mixed_port_first(tiny, tmp_path, tier):
    """Port node 0 -> JAX node 1 under the JAX package's dispatcher, lzb
    hops, every hop's tier policy ``tier``; (rows, hop tiers, stats of
    the port node, fallbacks)."""
    jg, jp, g, p = tiny
    jstages, stages = _stages(tiny, 2)
    tpath = str(tmp_path / f"t0{tier}.zip")
    jpath = str(tmp_path / f"j1{tier}.zip")
    texport.export_stage(stages[0], p, tpath, batch=1)
    jexport.export_stage(jstages[1], jp, jpath, batch=1)
    res = f"127.0.0.1:{tnode._free_ports(1)[0]}"
    jn = jnode.StageNode(jpath, "127.0.0.1:0", res, tier=tier)
    tn = StageNode(tpath, "127.0.0.1:0", f"127.0.0.1:{jn.address[1]}",
                   device="cpu", codec="lzb", tier=tier)
    disp = jnode.ChainDispatcher(f"127.0.0.1:{tn.address[1]}", listen=res,
                                 codec="lzb", tier=tier)
    threads = [threading.Thread(target=n.serve, daemon=True)
               for n in (tn, jn)]
    for t in threads:
        t.start()
    try:
        outs = [np.asarray(y) for y in disp.stream(_inputs(8, 4))]
        st = disp.stats([f"127.0.0.1:{tn.address[1]}"])
    finally:
        disp.close()
    _join(threads)
    tiers = [disp.tier_out, tn.tier_in, tn.tier_out, jn.tier_in,
             jn.tier_out, disp.tier_in]
    return outs, tiers, st[0], (disp.tier_fallbacks, tn.tier_fallbacks,
                                jn.tier_fallbacks)


@pytest.mark.timeout(240)
def test_mixed_chain_port_node_feeds_jax_node(tiny, tmp_path):
    """The reverse: a port node on its own artifact feeds a JAX node,
    under the JAX package's dispatcher.  Over ``auto`` both hops between
    the packages negotiate shm (a JAX ring into the port node, the port's
    ring into the JAX node) with no fallback, the JAX node's result edge
    to its own dispatcher takes the JAX package's ici, and the rows are
    byte-identical to the tcp chain's."""
    jg, jp, g, p = tiny
    tcp, tcp_tiers, _, _ = _mixed_port_first(tiny, tmp_path, "tcp")
    outs, tiers, st, fallbacks = _mixed_port_first(tiny, tmp_path, "auto")
    assert tcp_tiers == ["tcp", None, "tcp", None, "tcp", None]
    assert tiers == ["shm"] * 4 + ["ici"] * 2
    assert fallbacks == (0, 0, 0)
    assert st["processed"] == 4 and st["tier"] == "shm"
    for a, b in zip(tcp, outs):
        np.testing.assert_array_equal(a, b)
    fwd = jax.jit(jg.apply)
    for x, y in zip(_inputs(8, 4), outs):
        np.testing.assert_allclose(y, np.asarray(fwd(jp, x)),
                                   rtol=TOL, atol=TOL)


@pytest.mark.timeout(240)
def test_run_chain_spawns_processes(tiny):
    """Two OS processes on the CPU, deployed in-band under the default
    tier (``auto``): rows equal the port's forward (the same ops) and
    agree with JAX's; every node's stats came back before teardown, and
    every hop — the dispatcher's edges included — negotiated shm."""
    jg, jp, g, p = tiny
    jstages, stages = _stages(tiny, 2)
    xs = _inputs(9, 4)
    stats = []
    outs = run_chain(stages, p, xs, in_band=True, codec="lzb",
                     device="cpu", stats_out=stats)
    assert len(outs) == 4
    for y, want in zip(outs, _forward(tiny, xs)):
        np.testing.assert_array_equal(y, want)
    assert [s["stage"] for s in stats] == [0, 1]
    assert all(s["processed"] == 4 and s["device"] == "cpu"
               and s["codec"] == "lzb" for s in stats)
    assert all(s["kernel_launches"]["flash_attention"] == 0 for s in stats)
    assert [(s["tier"], s["tier_in"], s["tier_fallbacks"]) for s in stats] \
        == [("shm", "shm", 0)] * 2


@pytest.mark.timeout(120)
def test_spawn_nodes_names_a_node_that_dies_at_boot(tmp_path):
    """The chains' one spawn path: a node that dies before it binds fails
    the spawn with its own log tail (here an unknown hop codec, refused
    at boot)."""
    bad = lambda k, addrs, result: ["--codec", "no_such_codec"]  # noqa: E731
    with pytest.raises(RuntimeError, match="stage0 exited rc=1 during boot"
                                           "(.|\n)*no_such_codec"):
        with tnode.spawn_nodes(1, log_dir=str(tmp_path), device="cpu",
                               argv_for=bad):
            pass


@pytest.mark.timeout(180)
def test_spawn_nodes_retries_a_lost_port_race(tmp_path, monkeypatch):
    """A node whose probed port was taken before it bound dies with
    address-in-use; the spawn retries on fresh ports, and leaving the
    block on an error kills every node."""
    import socket

    held = socket.create_server(("127.0.0.1", 0))
    taken = held.getsockname()[1]
    real, calls = tnode._free_ports, []

    def rigged(n):
        calls.append(n)
        ports = real(n)
        return [taken] + ports[1:] if len(calls) == 1 else ports

    monkeypatch.setattr(tnode, "_free_ports", rigged)
    try:
        with pytest.raises(RuntimeError, match="leave the block"):
            with tnode.spawn_nodes(1, log_dir=str(tmp_path),
                                   device="cpu") as nodes:
                assert calls == [2, 2]
                assert nodes.addrs[0] != f"127.0.0.1:{taken}"
                procs = nodes.procs
                assert procs[0].poll() is None
                raise RuntimeError("leave the block")
        assert procs[0].poll() is not None
    finally:
        held.close()


def test_node_without_cuda_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA"):
        StageNode(None, "127.0.0.1:0", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_chain([], {}, [], device="cuda")
    from defer_tpu_torch import cli
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["node", "--listen", "127.0.0.1:0"])
    node = StageNode(None, "127.0.0.1:0", None, device="cpu")
    node._srv.close()


@pytest.mark.parametrize("kw,exc,match", [
    ({"replicas": {0: 2, 1: 2}}, ValueError,
     "stages 0 and 1 are both replicated"),
    ({"failover": True}, ValueError,
     "failover requires at least one replicated stage"),
    ({"plan": object(), "stats_out": [], "replicas": {0: 2, 1: 2}},
     ValueError, "stages 0 and 1 are both replicated"),
    ({"journal_dir": "/nonexistent/journal", "failover": True}, ValueError,
     "failover requires at least one replicated stage")])
def test_run_chain_refuses_what_is_not_ported(tiny, kw, exc, match):
    """Replicas and failover run, and refuse what the JAX package refuses
    (adjacent replicated stages, failover with nothing replicated) with
    its messages, before any node is spawned; ``plan=`` and
    ``journal_dir=`` are taken (the observability plane is ported) and
    change none of those refusals, and a refused call starts no
    journal."""
    from defer_tpu_torch.obs import active_journal
    _, stages = _stages(tiny, 2)
    with pytest.raises(exc, match=match):
        run_chain(stages, tiny[3], [], device="cpu", **kw)
    assert active_journal() is None


@pytest.mark.timeout(240)
@pytest.mark.parametrize("kw,want", [
    ({"hop_tiers": ["shm"]}, 2), ({"hop_tiers": ["device"]}, 1),
    ({"tier": "shm"}, 2),
    ({"devices": 2}, "devices=2 needs 2 visible CUDA devices"),
    ({"device_map": {0: 1}}, "devices=2 needs 2 visible CUDA devices")])
def test_run_chain_takes_the_colocated_tiers(tiny, kw, want):
    """Calls of the colocated tiers: a shm hop and a chain-wide
    shm pin run as node processes whose every hop (the dispatcher's
    edges too) reports the shm rung, a ``device`` hop fuses the two
    stages into one node, and asking for more cards than this host has
    raises ``ValueError`` naming the count."""
    _, stages = _stages(tiny, 2)
    xs = _inputs(12, 2)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            run_chain(stages, tiny[3], xs, device="cpu", **kw)
        return
    stats = []
    outs = run_chain(stages, tiny[3], xs, device="cpu", in_band=True,
                     stats_out=stats, **kw)
    assert [(s["tier"], s["tier_in"], s["tier_fallbacks"]) for s in stats] \
        == [("shm", "shm", 0)] * want
    for y, ref in zip(outs, _forward(tiny, xs)):
        np.testing.assert_array_equal(y, ref)


@pytest.mark.parametrize("make,check", [
    (lambda: ChainDispatcher("127.0.0.1:1,127.0.0.1:2"),
     lambda d: d._first_hops == [("127.0.0.1", 1), ("127.0.0.1", 2)]
     and d.result_fan_in == 1),
    (lambda: ChainDispatcher("127.0.0.1:1", result_fan_in=2),
     lambda d: d._first_hops == [("127.0.0.1", 1)]
     and d.result_fan_in == 2)])
def test_nodes_and_dispatcher_refuse_what_is_not_ported(make, check):
    """A dispatcher takes a replicated first stage (a comma list it fans
    out to) and a replicated last stage (``result_fan_in``); a node still
    refuses an unknown tier."""
    d = make()
    try:
        assert check(d)
    finally:
        d._res_srv.close()
    with pytest.raises(ValueError, match="tier must be"):
        StageNode(None, "127.0.0.1:0", None, device="cpu", tier="udp")


@pytest.mark.parametrize("make,check", [
    (lambda: StageNode(None, "127.0.0.1:0", None, device="cpu", tier="ici"),
     lambda nd: nd.tier == "ici" and nd.tier_accept),
    (lambda: StageNode(None, "127.0.0.1:0", None, device="cpu",
                       tier_accept=True),
     lambda nd: nd.tier == "tcp" and nd.tier_accept),
    (lambda: ChainDispatcher("127.0.0.1:1", tier="local"),
     lambda d: d.tier == "local" and d.tier_accept)])
def test_nodes_and_dispatcher_take_the_colocated_tiers(make, check):
    """Tier constructions: a node pinned to the ici rung, a
    node that grants offers (the default), a dispatcher whose first
    edge offers the local rung (which grants result-edge offers too)."""
    obj = make()
    try:
        assert check(obj)
    finally:
        (obj._srv if isinstance(obj, StageNode) else obj._res_srv).close()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("msg", [
    {"cmd": "deploy", "fan_in": 2}, {"cmd": "deploy", "replica": 0},
    {"cmd": "deploy", "fan": "broadcast"}, {"cmd": "deploy", "branch": 1},
    {"cmd": "deploy", "join": 2},
    {"cmd": "clock_probe"}, {"cmd": "obs_subscribe"},
    {"cmd": "profile_start"}])
def test_node_refuses_unported_commands(tiny, msg):
    """No command a JAX node answers is refused any more: the commands of
    the live observability plane get the JAX node's answer (a clock
    reading, a push, a started profiling window).  A deploy's replica
    roles (``fan_in``, ``replica``) and branch roles (``fan``,
    ``branch``, ``join``) load the artifact, take the role and are
    ACKed."""
    import socket

    from defer_tpu_torch.transport.framed import K_ACK, K_CTRL, recv_frame
    node = StageNode(None, "127.0.0.1:0", None, device="cpu")
    try:
        if msg["cmd"] != "deploy":
            want = {"clock_probe": "clock_probe_reply",
                    "obs_subscribe": "obs_push",
                    "profile_start": "profile_started"}[msg["cmd"]]
            a, b = socket.socketpair()
            try:
                assert node._handle_ctrl(a, dict(msg, interval_ms=20))
                kind, reply = recv_frame(b)
                assert kind == K_CTRL and reply["cmd"] == want
            finally:
                if node._profile is not None:
                    node._profile.stop()
                a.close()
                b.close()
                for r in node._reporters:
                    r.join(timeout=10)
            return
        _, stages = _stages(tiny, 2)
        blob = texport.export_stage_bytes(stages[1], tiny[3], batch=1)
        a, b = socket.socketpair()
        try:
            assert node._handle_ctrl(
                a, dict(msg, next="127.0.0.1:1"),
                recv=lambda: (tnode.K_BYTES, blob))
            assert recv_frame(b)[0] == K_ACK
        finally:
            a.close()
            b.close()
        assert node.manifest["index"] == 1
        assert (node.fan_in, node.replica, node.fan_mode, node.branch,
                node.join_in) == (msg.get("fan_in", 1), msg.get("replica"),
                                  msg.get("fan", "rr"), msg.get("branch"),
                                  msg.get("join", 0))
        assert node._span_label() == ("stage1.r0" if "replica" in msg
                                      else "stage1.b1" if "branch" in msg
                                      else "stage1")
    finally:
        node._srv.close()


@pytest.mark.timeout(120)
def test_node_deploy_takes_a_tier(tiny):
    """A deploy carrying ``tier: shm`` loads the
    artifact, sets the node's outbound policy and is ACKed."""
    import socket

    from defer_tpu_torch.transport.framed import K_ACK, recv_frame
    _, stages = _stages(tiny, 2)
    blob = texport.export_stage_bytes(stages[1], tiny[3], batch=1)
    node = StageNode(None, "127.0.0.1:0", None, device="cpu")
    a, b = socket.socketpair()
    try:
        assert node._handle_ctrl(
            a, {"cmd": "deploy", "tier": "shm", "next": "127.0.0.1:1"},
            recv=lambda: (tnode.K_BYTES, blob))
        assert recv_frame(b)[0] == K_ACK
        assert node.tier == "shm" and node.manifest["index"] == 1
        assert node.next_hop == ("127.0.0.1", 1)
    finally:
        a.close(), b.close()
        node._srv.close()


@pytest.mark.timeout(120)
def test_cli_node_and_chain_parsers(monkeypatch):
    from defer_tpu import cli as jcli
    from defer_tpu_torch import cli
    with pytest.raises(SystemExit):
        cli.main(["chain", "--codec", "sleep1"])
    with pytest.raises(SystemExit):
        cli.main(["node", "--device", "cpu"])  # --listen is required
    with pytest.raises(SystemExit, match="unknown model"):
        cli.main(["chain", "--model", "no_such_model", "--device", "cpu"])
    # the replica flags parse as the JAX package's do
    got = {}
    monkeypatch.setattr(cli, "cmd_node", lambda a: got.setdefault("node", a))
    monkeypatch.setattr(cli, "cmd_chain",
                        lambda a: got.setdefault("chain", a))
    cli.main(["node", "--listen", ":0", "--fan-in", "2", "--replica", "1",
              "--failover"])
    cli.main(["chain", "--replicas", "stage1=2, 3=3", "--failover"])
    a, c = got["node"], got["chain"]
    assert (a.fan_in, a.replica, a.failover) == (2, 1, True)
    assert c.failover and c.replicas == "stage1=2, 3=3"
    assert cli._parse_replicas(c.replicas) == \
        jcli._parse_replicas(c.replicas) == {1: 2, 3: 3}
    for bad in ("stage1", "stagex=2"):
        with pytest.raises(SystemExit, match="--replicas: .* is not stageK=N"):
            cli._parse_replicas(bad)


@pytest.mark.timeout(240)
def test_cli_chain_command_runs_and_checks_the_forward(capsys):
    """``python -m defer_tpu_torch chain`` end to end, in-process: two node
    processes on the CPU, one JSON row, the rows equal to the forward."""
    import json

    from defer_tpu_torch import cli
    cli.main(["chain", "--model", "resnet_tiny", "--stages", "2",
              "--count", "3", "--batch", "2", "--in-band", "--codec",
              "lzb", "--device", "cpu"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["metric"] == "resnet_tiny_2proc_chain"
    assert row["stages"] == 2 and row["device"] == "cpu"
    # the chain command's default tier is auto: both hops take shm
    assert row["hop_tiers"] == ["shm"] and row["result_tier"] == "shm"
    assert row["max_abs_err_vs_single_program"] == 0.0
    assert row["value"] > 0


@pytest.mark.timeout(240)
def test_deploy_chain_persist_redeploys_the_same_nodes(tiny):
    """``deploy_chain(persist=True)``: the node processes survive the END
    of a stream segment, take a second in-band deploy (another hop codec)
    and serve a new segment on the same ports; rows equal across the two
    codecs and within the file's TOL of the JAX forward, every node counts
    both segments, and leaving the block shuts every node down (exit 0)."""
    jg, jp, g, p = tiny
    _, stages = _stages(tiny, 3)
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal((2,) + IN_SHAPE).astype(np.float32)
          for _ in range(4)]
    with tnode.deploy_chain(stages, p, batch=2, codec="lzb", in_band=True,
                            tier="tcp", device="cpu", persist=True) as ch:
        d = ch.dispatcher
        lzb = np.stack(d.stream(xs))
        d.end_stream()
        d.codec = "raw"
        d.deploy(stages, p, ch.addrs, batch=2, codecs=["raw"] * 3,
                 tiers=["tcp"] * 3)
        raw = np.stack(d.stream(xs))
        st = d.stats(ch.addrs)
        procs = ch.procs
    assert [pr.returncode for pr in procs] == [0, 0, 0]
    np.testing.assert_array_equal(lzb, raw)
    assert [(s["codec"], s["processed"]) for s in st] == [("raw", 8)] * 3
    fwd = jax.jit(jg.apply)
    for x, y in zip(xs, raw):
        np.testing.assert_allclose(y, np.asarray(fwd(jp, x)), rtol=TOL,
                                   atol=TOL)
