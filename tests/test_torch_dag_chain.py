"""Port parity: branched (DAG) chains — ``runtime/node.py``'s fork, branch
and join roles, ``ChainDispatcher.deploy_topology``, ``run_dag_chain``
and ``chain --dag`` — mirroring ``tests/test_dag_chain.py`` scenario for
scenario (its monitor and cluster cases are in ``test_torch_obs_live.py``).

Contracts, with their tolerances:

* a deployment's rows are BYTE-IDENTICAL to the serial composition of the
  deployment's own stage programs (the same programs on the same frames;
  the transport only moves them);
* against the JAX package's forward on the same weights (carried across
  as numpy): within 1e-5 of max |output| (f32; matmuls and convolutions
  sum in another order than XLA's);
* mixed deployments (a JAX fork and join around port branch nodes, and a
  port fork and join around JAX branch nodes) are byte-identical to the
  all-port deployment.  Their weights and inputs are small integers, so
  every program is exact in both packages whatever its summation order,
  and byte identity tests the wiring across packages, not float rounding
  (float parity is the 1e-5 bound above).

Every socket test binds ``127.0.0.1:0``, joins its threads with a bound
and carries its own time limit.
"""

import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from defer_tpu.graph import ops as jops
from defer_tpu.graph.ir import GraphBuilder as JGraphBuilder
from defer_tpu.runtime import node as jnode
from defer_tpu.runtime import topology as jtopology
from defer_tpu.utils import export as jexport
import defer_tpu.models as jmodels
from defer_tpu_torch import models, params_from_jax
from defer_tpu_torch.graph import ops
from defer_tpu_torch.graph.analysis import branch_regions
from defer_tpu_torch.graph.ir import GraphBuilder
from defer_tpu_torch.plan import StageCostModel, solve_dag
from defer_tpu_torch.runtime.node import (ChainDispatcher, StageNode,
                                          dag_vertex_argv, run_dag_chain)
from defer_tpu_torch.runtime.topology import ChainTopology
from defer_tpu_torch.transport.framed import (K_ACK, K_BYTES, recv_expect,
                                              send_ctrl, send_end,
                                              send_frame)
from defer_tpu_torch.utils.export import (export_stage_bytes,
                                          load_stage_program)

torch.set_num_threads(1)

REL = 1e-5


def two_branch_graph(builder=GraphBuilder, o=ops):
    """input -> stem -> {b0: 2 Dense, b1: 1 Dense, residual} -> Add ->
    head: one region with an empty branch, small enough for fast
    exports (``tests/test_dag_chain.py``'s graph)."""
    b = builder("twobranch")
    x = b.input((8,))
    x = b.add(o.Dense(8), x, name="stem")
    p = b.add(o.Dense(8), x, name="b0n0")
    p = b.add(o.Dense(8), p, name="b0n1")
    q = b.add(o.Dense(8), x, name="b1n0")
    x = b.add(o.Add(), [x, p, q], name="join")
    x = b.add(o.Dense(4), x, name="head")
    return b.build()


TWO_HEAVY = {"b0n0": 1e-3, "b0n1": 1e-3, "b1n0": 2e-3}


def solved_topology(graph, *, heavy, budget):
    costs = {n: heavy.get(n, 1e-6) for n in graph.topo_order}
    cm = StageCostModel(graph, gen="v5e", link_bw_s=1e12, node_costs=costs)
    plan = solve_dag(graph, cm, num_nodes=budget)
    assert plan.parallel_regions, plan.to_json()
    return ChainTopology.from_json(plan.topology_json())


def _addr(node) -> str:
    return f"127.0.0.1:{node.address[1]}"


def _serve_all(nodes):
    errs: list = []

    def run(n):
        try:
            n.serve()
        except BaseException as e:  # noqa: BLE001 — asserted by callers
            errs.append((n, e))

    threads = [threading.Thread(target=run, args=(n,), daemon=True)
               for n in nodes]
    for t in threads:
        t.start()
    return threads, errs


def deploy_inproc(graph, topo, params, xs, *, batch=1, streams=1):
    """Thread-per-vertex deployment of port nodes on the CPU; returns
    (outs of the last stream, stats rows, the serial composition of the
    programs the nodes loaded on the same inputs)."""
    stages = topo.stage_specs(graph)
    nodes = [StageNode(None, "127.0.0.1:0", None, device="cpu")
             for _ in topo.vertices]
    addrs = [_addr(n) for n in nodes]
    threads, errs = _serve_all(nodes)
    disp = ChainDispatcher(addrs[0], codec="raw", timeout_s=120)
    try:
        disp.deploy_topology(topo, stages, params, addrs, batch=batch)
        for _ in range(streams):
            outs = disp.stream(xs)
        stats = disp.stats(addrs)
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert errs == []
    return outs, stats, _compose(topo, [n.prog for n in nodes], xs)


def serial_reference(graph, topo, params, xs, *, batch=1):
    """Serial composition of the deployment's stage programs, exported
    afresh: the byte-identity contract."""
    return _compose(topo, [load_stage_program(
        export_stage_bytes(s, params, batch=batch), device="cpu")
        for s in topo.stage_specs(graph)], xs)


def _compose(topo, progs, xs) -> list:
    graph_input = topo.entry.inputs[0]
    outs = []
    for x in xs:
        vals = {}
        for v, p in zip(topo.vertices, progs):
            ins = [x if name == graph_input else vals[name]
                   for name in v.inputs]
            vals[v.output] = p(*ins)
        outs.append(vals[topo.exit.output].numpy())
    return outs


def _assert_near_jax(jg, jp, xs, outs):
    fwd = jax.jit(jg.apply)
    for x, y in zip(xs, outs):
        want = np.asarray(fwd(jp, x))
        assert np.abs(np.asarray(y) - want).max() <= \
            REL * np.abs(want).max()


@pytest.fixture(scope="module")
def twobranch():
    jg = two_branch_graph(JGraphBuilder, jops)
    jp = jg.init(jax.random.key(0))
    g = two_branch_graph()
    p = params_from_jax(g, jax.tree.map(np.asarray, jp))
    return jg, jp, g, p, solved_topology(g, heavy=TWO_HEAVY, budget=5)


@pytest.mark.timeout(120)
def test_branched_chain_byte_identity_two_branch(twobranch):
    jg, jp, g, p, topo = twobranch
    assert any(v.fan == "broadcast" for v in topo.vertices)
    join = next(v for v in topo.vertices if v.join >= 2)
    assert join.join == 3          # two real branches + the residual skip
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((1, 8)).astype(np.float32) for _ in range(8)]
    outs, stats, ref = deploy_inproc(g, topo, p, xs)
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)
    _assert_near_jax(jg, jp, xs, outs)
    # every branch vertex saw every frame (broadcast, not round-robin);
    # path 0 is the residual skip (a direct fork->join channel, no
    # vertex), the two real branches ride paths 1 and 2
    per_branch = {s["branch"]: s["processed"] for s in stats
                  if s.get("branch") is not None}
    assert per_branch == {1: len(xs), 2: len(xs)}
    assert [s["join"] for s in stats] == [0, 0, 0, 3]
    assert stats[-1]["processed"] == len(xs)
    assert [s["tier"] for s in stats] == ["tcp"] * 4


@pytest.mark.timeout(120)
def test_branched_chain_multi_stream_and_order(twobranch):
    """Several stream() calls ride one deployment (the fork's shared
    sequence stamp keeps advancing), outputs strictly in input order."""
    _, _, g, p, topo = twobranch
    # distinguishable frames: an ordering mistake changes the outputs
    xs = [np.full((1, 8), i, np.float32) for i in range(6)]
    outs, stats, ref = deploy_inproc(g, topo, p, xs, streams=3)
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)
    assert all(s["processed"] == 3 * len(xs) for s in stats)


@pytest.mark.timeout(300)
def test_branched_chain_byte_identity_moe_branched_tiny():
    """The expert-parallel MoE: both 4-expert regions fanned out (11
    vertices), byte-identical to the serial composition; every expert
    vertex processed every frame."""
    jg = jmodels.moe_branched_tiny(seq_len=8)
    jp = jg.init(jax.random.key(0))
    g = models.moe_branched_tiny(seq_len=8)
    p = params_from_jax(g, jax.tree.map(np.asarray, jp))
    heavy = {n: 1e-3 for n in g.topo_order
             if n.startswith("block_") or "_e" in n}
    topo = solved_topology(g, heavy=heavy, budget=12)
    assert len(topo) == 11
    assert sum(1 for v in topo.vertices if v.join >= 2) == 2
    rng = np.random.default_rng(0)
    xs = [rng.integers(0, 100, (1, 8)).astype(np.int32) for _ in range(4)]
    outs, stats, ref = deploy_inproc(g, topo, p, xs)
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)
    _assert_near_jax(jg, jp, xs, outs)
    branch_rows = [s for s in stats if s.get("branch") is not None]
    assert len(branch_rows) == 8   # 4 experts x 2 layers
    assert all(s["processed"] == len(xs) for s in branch_rows)
    assert sorted(s["join"] for s in stats if s["join"]) == [5, 5]


@pytest.mark.timeout(300)
def test_branched_chain_byte_identity_inception_tiny():
    """The multi-branch vision scenario: 5 vertices around the mixed_3
    reduction region, byte-identical to the serial composition and within
    1e-5 of the JAX forward."""
    jg = jmodels.inception_tiny()
    jp = jg.init(jax.random.key(0))
    g = models.inception_tiny()
    p = params_from_jax(g, jax.tree.map(np.asarray, jp))
    region = next(r for r in branch_regions(g) if r.join == "mixed_3")
    heavy = {n: 1e-3 for b in region.branches[:2] for n in b.nodes}
    topo = solved_topology(g, heavy=heavy, budget=5)
    assert len(topo) == 5
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((1, 75, 75, 3)).astype(np.float32)
          for _ in range(3)]
    outs, stats, ref = deploy_inproc(g, topo, p, xs)
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)
    _assert_near_jax(jg, jp, xs, outs)
    join = next(s for s in stats if s["join"])
    assert join["join"] == next(v.join for v in topo if v.join)
    assert all(s["processed"] == len(xs) for s in stats)


# ---------------------------------------------------------------------------
# mixed-package DAGs
# ---------------------------------------------------------------------------

def _integer_params(jg, seed: int) -> dict:
    """JAX-layout numpy weights of small integers (see the module
    docstring: every program is then exact in both packages)."""
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(np.asarray, jg.init(jax.random.key(seed)))
    return jax.tree.map(
        lambda a: rng.integers(-2, 3, a.shape).astype(a.dtype), jp)


def _deploy_raw(addr: str, msg: dict, blob: bytes) -> None:
    """One vertex's in-band deploy, as either package's dispatcher sends
    it (the frames are the same in both)."""
    host, _, port = addr.rpartition(":")
    s = socket.create_connection((host, int(port)), timeout=60)
    try:
        send_ctrl(s, msg)
        send_frame(s, blob)
        recv_expect(s, K_ACK)
        send_end(s)
    finally:
        s.close()


def _mixed_run(jg, jp_np, g, p, topo, jtopo, xs, pkg_of, dispatcher):
    """Deploy ``topo`` with vertex k served by a node of package
    ``pkg_of[k]`` (its own artifact), stream ``xs`` through a dispatcher
    of package ``dispatcher``; returns (outs, stats)."""
    stages = topo.stage_specs(g)
    jstages = jtopo.stage_specs(jg)
    jp = jax.tree.map(jax.numpy.asarray, jp_np)
    nodes = [StageNode(None, "127.0.0.1:0", None, device="cpu")
             if pk == "port" else jnode.StageNode(None, "127.0.0.1:0", None)
             for pk in pkg_of]
    addrs = [_addr(n) for n in nodes]
    threads, errs = _serve_all(nodes)
    disp = (ChainDispatcher(addrs[0], timeout_s=120) if dispatcher == "port"
            else jnode.ChainDispatcher(addrs[0], timeout_s=120))
    result = f"{disp.result_address[0]}:{disp.result_address[1]}"
    try:
        for v, pk, addr in zip(topo.vertices, pkg_of, addrs):
            msg = {"cmd": "deploy", "codec": "raw",
                   "next": (",".join(addrs[n] for n in v.next) if v.next
                            else result)}
            if v.fan == "broadcast":
                msg["fan"] = "broadcast"
            if v.join >= 2:
                msg["join"] = v.join
            if v.branch is not None:
                msg["branch"] = v.branch
            blob = (export_stage_bytes(stages[v.vid], p, batch=2)
                    if pk == "port" else
                    jexport.export_stage_bytes(jstages[v.vid], jp, batch=2))
            _deploy_raw(addr, msg, blob)
        outs = [np.asarray(y) for y in disp.stream(xs)]
        stats = disp.stats(addrs)
    finally:
        disp.close()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert errs == []
    return outs, stats


@pytest.mark.timeout(240)
@pytest.mark.parametrize("case", ["jax_fork_and_join", "port_fork_and_join"])
def test_mixed_package_dag_byte_identical_to_all_port(case):
    """A JAX fork into port branch nodes and a JAX join (dispatched by the
    port), and a port fork into JAX branch nodes and a port join
    (dispatched by the JAX package): the two packages' broadcast senders,
    path labels and joins interoperate, and the rows are byte-identical
    to the all-port deployment's."""
    jg = two_branch_graph(JGraphBuilder, jops)
    g = two_branch_graph()
    jp_np = _integer_params(jg, 3)
    p = params_from_jax(g, jp_np)
    topo = solved_topology(g, heavy=TWO_HEAVY, budget=5)
    jtopo = jtopology.ChainTopology.from_json(topo.to_json())
    rng = np.random.default_rng(4)
    xs = [rng.integers(-3, 4, (2, 8)).astype(np.float32) for _ in range(7)]
    ends = "jax" if case == "jax_fork_and_join" else "port"
    mids = "port" if ends == "jax" else "jax"
    pkg_of = [ends if v.branch is None else mids for v in topo.vertices]
    assert pkg_of.count(mids) == 2 and pkg_of.count(ends) == 2
    outs, stats = _mixed_run(jg, jp_np, g, p, topo, jtopo, xs, pkg_of,
                             dispatcher=mids)
    ref, ref_stats = _mixed_run(jg, jp_np, g, p, topo, jtopo, xs,
                                ["port"] * len(topo), dispatcher="port")
    assert len(outs) == len(xs)
    for a, b in zip(ref, outs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(serial_reference(g, topo, p, xs, batch=2), ref):
        np.testing.assert_array_equal(a, b)
    for st in (stats, ref_stats):
        assert [s["branch"] for s in st] == [v.branch for v in topo]
        assert [s["join"] for s in st] == [v.join for v in topo]
        assert all(s["processed"] == len(xs) for s in st)


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

def _kill_node(node) -> None:
    """A node's death as its peers see it: the listener stops and its
    data connections reach EOF both ways."""
    node._srv.shutdown(socket.SHUT_RDWR)
    for ch in (node._live_rx, node._live_tx):
        sock = getattr(ch, "_sock", None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


@pytest.mark.timeout(120)
def test_join_that_loses_a_path_fails_the_stream(twobranch):
    """A branch node dies mid-stream: the join fails (its reader for that
    path poisons the (path, seq) buffer), the failure cascades to the
    dispatcher, and the stream raises well before the dispatcher's own
    timeout — it never completes short."""
    _, _, g, p, topo = twobranch
    stages = topo.stage_specs(g)
    nodes = [StageNode(None, "127.0.0.1:0", None, device="cpu",
                       infer_delay_s=0.02) for _ in topo.vertices]
    addrs = [_addr(n) for n in nodes]
    threads, errs = _serve_all(nodes)
    disp = ChainDispatcher(addrs[0], window=4, timeout_s=60)
    victim = nodes[1]
    got: list = []

    def frames():
        rng = np.random.default_rng(0)
        for i in range(40):
            if i == 10:
                _kill_node(victim)
            yield rng.standard_normal((1, 8)).astype(np.float32)

    t0 = time.monotonic()
    try:
        disp.deploy_topology(topo, stages, p, addrs)
        with pytest.raises((ConnectionError, OSError, TimeoutError)):
            got = disp.stream(frames())
    finally:
        disp.close()
        for n in nodes:
            try:
                _kill_node(n)
            except OSError:
                pass
    assert time.monotonic() - t0 < 45
    assert got == []
    for t in threads:
        t.join(timeout=30)
    assert any(n is nodes[-1] for n, _ in errs)   # the join failed


@pytest.mark.timeout(60)
def test_deploy_topology_names_the_vertex_that_did_not_answer(twobranch):
    """A vertex whose node never answers fails the deploy naming its label
    and address; a length mismatch raises before any connection."""
    _, _, g, p, topo = twobranch
    stages = topo.stage_specs(g)
    live = [StageNode(None, "127.0.0.1:0", None, device="cpu")
            for _ in range(2)]
    threads, _ = _serve_all(live)
    dead = socket.create_server(("127.0.0.1", 0))
    dead_addr = f"127.0.0.1:{dead.getsockname()[1]}"
    dead.close()
    addrs = [_addr(live[0]), _addr(live[1]), dead_addr, dead_addr]
    disp = ChainDispatcher(addrs[0], timeout_s=1.0)
    try:
        with pytest.raises(ConnectionError,
                           match=f"vertex stage2.b2 at {dead_addr}"):
            disp.deploy_topology(topo, stages, p, addrs)
        with pytest.raises(ValueError, match="4 topology vertices"):
            disp.deploy_topology(topo, stages, p, addrs[:3])
    finally:
        disp._res_srv.close()
        for n in live:
            _kill_node(n)
    for t in threads:
        t.join(timeout=10)


def test_run_dag_chain_rejects_replicas_and_tiers(twobranch):
    """The branch fans and the replica and colocation machinery own
    different sequence namespaces: composing them fails before any
    process spawns."""
    _, _, g, p, topo = twobranch
    with pytest.raises(ValueError, match="replicas"):
        run_dag_chain(g, p, [], topology=topo, replicas={1: 2},
                      device="cpu")
    with pytest.raises(ValueError, match="hop_tiers"):
        run_dag_chain(g, p, [], topology=topo, hop_tiers={"stem": "local"},
                      device="cpu")


def test_node_role_flags_validated():
    """The role flags raise the JAX package's messages; a colocated tier
    pinned on a branch node raises (branch hops ride tcp)."""
    for kw, match in (({"join_in": 1}, "join_in"),
                      ({"fan_mode": "multicast"}, "fan_mode"),
                      ({"join_in": 2, "fan_in": 2}, "replica fan-in"),
                      ({"branch": 1, "tier": "ici"}, "branch node")):
        with pytest.raises(ValueError, match=match):
            StageNode(None, "127.0.0.1:0", None, device="cpu", **kw)
        with pytest.raises(ValueError, match=match.split()[0]):
            jnode.StageNode(None, "127.0.0.1:0", None, **kw)


@pytest.mark.parametrize("msg,match", [
    ({"fan": "multicast"}, "fan must be rr|broadcast"),
    ({"join": 1}, "join must be >= 2"),
    ({"join": 2, "fan_in": 2}, "both a branch join and a replica fan-in")])
def test_deploy_refuses_bad_roles(msg, match):
    """A deploy message naming an impossible role raises before loading
    anything (the control connection is cut, never ACKed)."""
    node = StageNode(None, "127.0.0.1:0", None, device="cpu")
    try:
        with pytest.raises(ValueError, match=match):
            node._handle_ctrl(None, dict(msg, cmd="deploy"),
                              recv=lambda: (K_BYTES, b""))
        assert node.prog is None and node.join_in == 0
    finally:
        node._srv.close()


def test_dag_vertex_argv_carries_the_roles(twobranch):
    """Each vertex's node argv: the fork broadcasts to the join and both
    branches, each branch labels its path, the join merges three paths,
    every hop pinned to tcp; the flags parse as the node command's."""
    from defer_tpu_torch import cli
    _, _, _, _, topo = twobranch
    addrs = [f"127.0.0.1:{7000 + k}" for k in range(len(topo))]
    argvs = [dag_vertex_argv(v, f"v{v.vid}.zip", addrs=addrs,
                             result_addr="127.0.0.1:6999", device="cpu")
             for v in topo.vertices]
    for argv in argvs:
        assert argv[1:4] == ["-m", "defer_tpu_torch", "node"]
        assert argv[argv.index("--tier") + 1] == "tcp"
    assert "--fan" in argvs[0] and argvs[0][argvs[0].index("--next") + 1] \
        == ",".join(addrs[n] for n in topo.entry.next)
    assert argvs[1][argvs[1].index("--branch") + 1] == "1"
    assert argvs[-1][argvs[-1].index("--join") + 1] == "3"
    assert argvs[-1][argvs[-1].index("--next") + 1] == "127.0.0.1:6999"
    got = {}

    def keep(a):
        got["node"] = a

    import unittest.mock as mock
    with mock.patch.object(cli, "cmd_node", keep):
        cli.main(argvs[-1][3:])
    a = got["node"]
    assert (a.join, a.fan, a.branch, a.device) == (3, "rr", None, "cpu")
    with mock.patch.object(cli, "cmd_node", keep):
        cli.main(argvs[0][3:])
    assert got["node"].fan == "broadcast"


def test_cli_chain_dag_guard_rails():
    from defer_tpu_torch.cli import main
    with pytest.raises(SystemExit, match="replicas"):
        main(["chain", "--model", "moe_branched_tiny", "--dag",
              "--replicas", "stage1=2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="wire-framed"):
        main(["chain", "--model", "moe_branched_tiny", "--dag",
              "--hop-tiers", "local", "--device", "cpu"])
    with pytest.raises(SystemExit, match="linear planner"):
        main(["chain", "--model", "moe_branched_tiny", "--dag",
              "--cuts", "block_0", "--device", "cpu"])


@pytest.mark.timeout(240)
def test_run_dag_chain_real_processes(twobranch, tmp_path):
    """``run_dag_chain`` spawns the branched topology as real OS ``node``
    processes on the CPU (the ``chain --dag`` path): byte-identical to
    the serial composition of its own stage programs, every branch vertex
    every frame, and the timings it reports."""
    _, _, g, p, topo = twobranch
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((1, 8)).astype(np.float32) for _ in range(5)]
    stats: list = []
    timings: dict = {}
    outs = run_dag_chain(g, p, xs, topology=topo, stats_out=stats,
                         device="cpu", timings_out=timings,
                         artifact_dir=str(tmp_path))
    for a, b in zip(serial_reference(g, topo, p, xs), outs):
        np.testing.assert_array_equal(a, b)
    per_branch = {s["branch"]: s["processed"] for s in stats
                  if s.get("branch") is not None}
    assert per_branch == {1: len(xs), 2: len(xs)}
    assert stats[-1]["join"] == 3
    assert 0 < timings["first_result_s"] <= timings["stream_s"]
    assert timings["boot_s"] > 0
    # the artifacts and one log per vertex stay in the caller's directory
    assert sorted(f.name for f in tmp_path.glob("vertex_*.zip")) == [
        f"vertex_{k}.zip" for k in range(len(topo))]
