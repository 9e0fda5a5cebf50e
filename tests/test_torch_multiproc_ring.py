"""Port parity: the ring across ``torch.distributed`` processes.

One spawn of ``scripts/torch_ring_procs.py`` (four gloo CPU processes, a
deadline of 120 s) runs its ``ring`` cases; the tests read its results
(``tests/test_torch_multiproc_decode.py`` spawns the ``decode`` cases).  The
workers map the seeded ``resnet_tiny`` / ``bert_tiny`` weights and numpy
inputs that this process builds and hands them, so the same values go
through:

* the ring across processes: ``resnet_tiny`` in 8 stages over 4 processes
  x 2 positions (``multihost_pipeline_mesh(8, local_devices=["cpu"] *
  2)``), ``bert_tiny`` in 4 stages (one a process, the plain flash path),
  ``resnet_tiny`` in 2 stages on (data 2, stage 2), each data line's ring
  on a sub-group ({0, 1} and {2, 3}); both wires;
* the port's one-process ring on the same inputs: rows bit-equal (the
  same ops on the same rows, the int8 payload quantized in the same
  blocks: one thread everywhere, so the convolutions sum alike);
* the JAX ``SpmdPipeline`` on the conftest's CPU mesh, the port's weights
  carried over with ``params_to_jax``: ``tests/test_torch_pipeline.py``'s
  bounds (buffer within 1e-5 of max |logit|, int8 within one quant step,
  max |logit| / 127);
* the collectives over a stage axis across processes, against
  ``lax.psum``/``ppermute``/``all_gather``/``all_to_all`` under
  ``shard_map`` on the same integer-valued f32 (exact in any order).
"""

import socket
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

import defer_tpu.models as jax_models
from defer_tpu import SpmdPipeline as JaxSpmdPipeline
from defer_tpu import pipeline_mesh as jax_pipeline_mesh
from defer_tpu.partition.partitioner import partition as jax_partition
from defer_tpu.utils.compat import shard_map
from defer_tpu_torch import SpmdPipeline, models, partition, params_to_jax
from defer_tpu_torch.parallel import distributed as D
from defer_tpu_torch.parallel import mesh as M
from defer_tpu_torch.runtime.spmd import ring_block

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import torch_ring_procs as R  # noqa: E402

torch.set_num_threads(1)

PROCS = 4
CFG = R.PRESETS["cpu"]
MB, CHUNK, FRAMES = CFG["microbatch"], CFG["chunk"], CFG["frames"]
#: case -> (graph factory, stages, data lines, positions a process)
CASES = {"resnet": ("resnet_tiny", 8, 1, 2), "bert": ("bert_tiny", 4, 1, 1),
         "dp": ("resnet_tiny", 2, 2, 1)}
PIPES = [(c, w) for c in CASES for w in R.WIRES]


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    return R.spawn(PROCS, "cpu", "cpu", tmp_path_factory.mktemp("ring"),
                   R.make_inputs("cpu", ("ring",)), cases=("ring",),
                   deadline_s=120.0, timeout_s=60.0)


def _graph(name):
    g = getattr(models, name)()
    return g, g.init(torch.Generator().manual_seed(R.SEED))


def _inputs(case, g):
    rng = np.random.default_rng(R.SEED)
    if case == "bert":
        vocab = g.nodes["embeddings"].op.vocab
        return rng.integers(0, vocab, (FRAMES, MB) + g.input_spec.shape
                            ).astype(np.float32)
    return rng.standard_normal((FRAMES, MB, CFG["image"], CFG["image"],
                                3)).astype(np.float32)


def test_the_workers_inputs_are_this_process_seeded_ones():
    """What the spawn hands the workers is what the references below
    build: the same seeded weights and inputs."""
    given = R.make_inputs("cpu", ("ring",))
    for case, name in (("resnet", "resnet_tiny"), ("bert", "bert_tiny")):
        g, p = _graph(name)
        np.testing.assert_array_equal(
            given["bert_ids" if case == "bert" else "resnet_x"],
            _inputs(case, g))
        mine = given[f"{case}_params"]
        assert mine.keys() == p.keys()
        for k in p:
            for a, b in zip(torch.utils._pytree.tree_leaves(mine[k]),
                            torch.utils._pytree.tree_leaves(p[k])):
                assert torch.equal(a, b), k


@pytest.fixture(scope="module")
def refs():
    """Per (case, wire): the port's one-process ring and the JAX
    ``SpmdPipeline`` on the same inputs and weights."""
    out = {}
    for case, (name, n, dp, _) in CASES.items():
        g, p = _graph(name)
        x = _inputs(case, g)
        jg = getattr(jax_models, name)()
        jp = params_to_jax(g, p)
        for w in R.WIRES:
            one = SpmdPipeline(partition(g, num_stages=n), p, device="cpu",
                               microbatch=MB, chunk=CHUNK, wire=w,
                               data_parallel=dp).run(x)
            jout = JaxSpmdPipeline(jax_partition(jg, num_stages=n), jp,
                                   mesh=jax_pipeline_mesh(n, dp),
                                   microbatch=MB, chunk=CHUNK, wire=w).run(x)
            out[case, w] = (one, np.asarray(jout))
    return out


@pytest.mark.parametrize("case,wire", PIPES)
def test_rows_bit_equal_to_one_process_ring(ring, refs, case, wire):
    one, _ = refs[case, wire]
    for r in ring:
        np.testing.assert_array_equal(r[f"{case}_{wire}_rows"], one)


@pytest.mark.parametrize("case,wire", PIPES)
def test_rows_within_bounds_of_jax_spmd(ring, refs, case, wire):
    _, jout = refs[case, wire]
    got = ring[0][f"{case}_{wire}_rows"]
    assert got.shape == jout.shape
    scale = np.abs(jout).max()
    bound = 1e-5 * scale if wire == "buffer" else scale / 127
    assert np.abs(got - jout).max() <= bound


@pytest.mark.parametrize("what", ["run", "stream"])
def test_defer_equals_spmd_pipeline(ring, what):
    for r in ring:
        np.testing.assert_array_equal(r[f"defer_{what}_rows"],
                                      r["resnet_int8_rows"])


def test_reweight_and_stage_latencies_per_process(ring):
    """``reweight`` installs each process's stages of the seed-1 weights
    (rows bit-equal to a one-process ring built on them);
    ``stage_latencies`` times this process's two stages."""
    g, _ = _graph("resnet_tiny")
    p1 = g.init(torch.Generator().manual_seed(R.SEED + 1))
    want = SpmdPipeline(partition(g, num_stages=8), p1, device="cpu",
                        microbatch=MB, chunk=CHUNK).run(_inputs("resnet", g))
    for r in ring:
        np.testing.assert_array_equal(r["reweight_rows"], want)
        lats = r["meta"]["stage_latencies"]
        assert len(lats) == 2 and all(t > 0 for t in lats)


@pytest.mark.parametrize("case,wire", PIPES)
def test_one_quantizer_launch_per_process_step(ring, case, wire):
    """Per process and int8 step one quantizer call over its slots, none
    on the buffer wire; BERT's flash calls are the process's blocks a
    step (one block a stage here), the blocks of all four a step summed."""
    blocks = 0
    if case == "bert":
        g, _ = _graph("bert_tiny")
        blocks = sum(n.startswith("block_") for n in g.topo_order)
    flash = 0
    for r in ring:
        meta = r["meta"][f"{case}_{wire}"]
        steps = meta["steps"]
        # the padded chunks, then the drain's full chunks
        fed = CHUNK * -(-FRAMES // CHUNK)
        assert steps == CHUNK * -(-(fed + CASES[case][1] - 1) // CHUNK)
        assert meta["launches"]["quant_int8"] == (steps if wire == "int8"
                                                  else 0)
        flash += meta["launches"]["flash_attention"]
    assert flash == blocks * ring[0]["meta"][f"{case}_{wire}"]["steps"]


@pytest.mark.parametrize("case,wire", PIPES)
def test_boundary_bytes_and_transport(ring, case, wire):
    """One send a step per process (its last slot to the next stage's
    process); its bytes are the rows of its data line times ``buf_elems``
    times the itemsize, or under int8 one byte a value plus an f32 scale
    per 256.  gloo names the transport; no graph is captured."""
    _, n, dp, per = CASES[case]
    for r in ring:
        meta = r["meta"][f"{case}_{wire}"]
        buf = meta["buf_elems"]
        rows = MB // dp
        want = (rows * (buf + 4 * (buf // 256)) if wire == "int8"
                else rows * buf * 4)
        assert meta["boundary_sends"] == meta["steps"]
        assert meta["boundary_bytes"] == want * meta["steps"]
        assert meta["transport"] == "gloo" and meta["captures"] == 0
        assert meta["ring"] == [per, rows, buf]


@pytest.mark.parametrize("case", list(CASES))
def test_each_process_holds_its_block(ring, case):
    """Host-major: process i holds consecutive stages; (data 2, stage 2)
    over four processes gives data line 0 to processes 0 and 1.  Only a
    process holding stage 0 stages input rows on its device: its data
    line's."""
    _, n, dp, per = CASES[case]
    for i, r in enumerate(ring):
        meta = r["meta"][f"{case}_int8"]
        stages = meta["local_stages"]
        first = (i * per) % n
        assert stages == list(range(first, first + per))
        assert meta["staged_rows"] == (MB // dp if first == 0 else 0)


def _jax_line(fn, x: np.ndarray) -> np.ndarray:
    """``fn`` under shard_map over ``len(x)`` CPU devices, one block a
    rank."""
    n = len(x)
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("i",))
    f = shard_map(lambda a: fn(a[0])[None], mesh=mesh, in_specs=P("i"),
                  out_specs=P("i"), check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


def _jax_op(op, n):
    ring = [(i, (i + 1) % n) for i in range(n)]
    return {"psum": lambda a: lax.psum(a, "i"),
            "ppermute": lambda a: lax.ppermute(a, "i", ring),
            "ppermute_partial": lambda a: lax.ppermute(a, "i", [(0, 1)]),
            "all_gather": lambda a: lax.all_gather(a, "i", axis=0),
            "all_gather_tiled": lambda a: lax.all_gather(a, "i", axis=0,
                                                         tiled=True),
            "all_to_all": lambda a: lax.all_to_all(
                a, "i", split_axis=0, concat_axis=1, tiled=True)}[op]


def _port_op(op, xs):
    n = len(xs)
    ring = [(i, (i + 1) % n) for i in range(n)]
    return {"psum": lambda: M.psum(xs),
            "ppermute": lambda: M.ppermute(xs, ring),
            "ppermute_partial": lambda: M.ppermute(xs, [(0, 1)]),
            "all_gather": lambda: M.all_gather(xs, 0),
            "all_gather_tiled": lambda: M.all_gather(xs, 0, True),
            "all_to_all": lambda: M.all_to_all(xs, 0, 1)}[op]()


#: the collectives' meshes: every process on one stage line (8 stages, 2
#: a process), and two lines of 2 stages each on 2 processes (sub-groups)
COLL_MESHES = {"line": (8, 1), "sub": (2, 2)}


@pytest.mark.parametrize("op", R.COLLECTIVES)
@pytest.mark.parametrize("which", list(COLL_MESHES))
def test_collectives_across_processes_match_jax(ring, which, op):
    n, dp = COLL_MESHES[which]
    x = np.random.default_rng(R.SEED + 1).integers(
        -8, 8, (dp, n, 8, 8)).astype(np.float32)
    for d in range(dp):
        want = _jax_line(_jax_op(op, n), x[d])
        one_card = np.stack([y.numpy() for y in _port_op(
            op, [torch.from_numpy(a.copy()) for a in x[d]])])
        np.testing.assert_array_equal(one_card, want)
        for r in ring:
            for pos, got in zip(r[f"{which}_positions"], r[f"{which}_{op}"]):
                if pos[0] == d:
                    np.testing.assert_array_equal(got, want[pos[1]])


@pytest.mark.parametrize("name", list(R.GUARDS))
def test_guard_names_its_queue(ring, name):
    for r in ring:
        assert R.GUARDS[name] in r["meta"]["guards"][name], name


def test_ranks_sharing_a_card_are_refused_naming_gloo(ring):
    """The NCCL check of a ring's placement, run over a gloo group named
    NCCL to it whose four ranks' rings name one card: every rank raises
    naming gloo and the card's ranks."""
    for r in ring:
        msg = r["meta"]["nccl_refused"]
        assert 'backend="gloo"' in msg and "[0, 1, 2, 3]" in msg, msg


# ---------------------------------------------------------------------------
# the pieces, in this process
# ---------------------------------------------------------------------------


def test_one_process_mesh_is_any_ranks():
    """A mesh held by one process is that process's whatever its rank;
    of a mesh over several, a process holds its own positions, and one
    holding none is refused."""
    mesh = M.pipeline_mesh(2, 2, devices=["cpu"] * 4)
    mine, dev = M.mesh_placement(mesh, "x")
    assert mine.all() and dev == torch.device("cpu")
    far = M.pipeline_mesh(2, devices=["cpu"] * 2)
    far.processes = np.array([[1, 2]])
    with pytest.raises(ValueError, match="holds no position"):
        M.mesh_placement(far, "x")
    mine, dev = M.mesh_placement(M.Mesh(np.array(["cpu", "cpu"], object),
                                        ("stage",), processes=[0, 1]), "x")
    assert mine.tolist() == [True, False] and dev == torch.device("cpu")


def test_ring_block_needs_consecutive_stages_of_consecutive_lines():
    mesh = M.pipeline_mesh(3, 2, devices=["cpu"] * 6)
    mesh.processes = np.array([[0, 0, 1], [1, 2, 2]])
    lines, stages, owners = ring_block(mesh, mesh.processes == 0)
    assert (lines, stages) == (range(0, 1), range(0, 2))
    assert owners.tolist() == [[0, 0, 1], [1, 2, 2]]
    with pytest.raises(ValueError, match="consecutive"):
        ring_block(mesh, mesh.processes == 1)


def test_shared_cards_names_each_card_and_its_ranks():
    assert D.shared_cards(["h/a", "h/b", "g/a"]) == {}
    assert D.shared_cards(["h/a", "h/b", "h/a", "h/a"]) == {"h/a": [0, 2, 3]}


def _swapped(devices):
    """Each rank's view of every rank's card (``card_key(devices[r])``,
    its ring's device), swapped through one store by a thread a rank."""
    store = torch.distributed.HashStore()
    views = [None] * len(devices)

    def rank(r):
        views[r] = D.swap_card_keys(store, r, len(devices),
                                    D.card_key(devices[r]))

    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(len(devices))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return views


def test_ranks_on_distinct_cards_are_not_refused(monkeypatch):
    """The port calls no ``set_device``, so every rank's current device is
    card 0: ranks whose rings name cards 0 and 1 (a launcher mapping
    ranks to cards only through the mesh's ``local_devices``) are not
    refused, whatever ``LOCAL_RANK`` says; rings that name no index share
    the current card and are."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(uuid=f"GPU-{i}"))
    monkeypatch.setenv("LOCAL_RANK", "0")
    for view in _swapped([torch.device("cuda", 0), "cuda:1"]):
        assert D.shared_cards(view) == {}
    for view in _swapped(["cuda", torch.device("cuda")]):
        assert list(D.shared_cards(view).values()) == [[0, 1]]
    assert D.card_key("cuda:1").endswith("/GPU-1")
    assert D.card_key().endswith("/GPU-0")  # the current card


def test_a_failing_worker_fails_the_spawn_with_its_stderr(tmp_path):
    with pytest.raises(RuntimeError, match="invalid choice"):
        R.spawn(2, "cpu", "no_such_preset", tmp_path, {})


def test_a_port_taken_before_the_workers_bind_is_retried(tmp_path,
                                                        monkeypatch):
    """The first probe's ports are held by a listener when the workers
    start: worker 0's group store cannot bind (EADDRINUSE), every worker
    is killed and the spawn runs again on fresh ports, returning every
    worker's results (here with no cases: the group forms, and each
    worker writes its scalars)."""
    held = socket.create_server(("127.0.0.1", 0))
    taken = held.getsockname()[1]
    handed: list = []
    probe = R.free_port

    def port():
        handed.append(taken if len(handed) < 2 else probe())
        return handed[-1]

    monkeypatch.setattr(R, "free_port", port)
    try:
        res = R.spawn(2, "cpu", "cpu", tmp_path, {}, cases=(),
                      deadline_s=60.0)
    finally:
        held.close()
    assert len(handed) == 4 and handed[:2] == [taken, taken]
    assert [r["meta"]["worker"] for r in res] == [0, 1]
    assert all(r["meta"]["port"] == handed[2] != taken for r in res)


def test_the_deadline_kills_every_worker(tmp_path):
    """Workers still running at the deadline are killed and the spawn
    fails (the two wait for each other in the ring's first receive at the
    latest)."""
    with pytest.raises(RuntimeError, match="still running after"):
        R.spawn(2, "cpu", "cpu", tmp_path, R.make_inputs("cpu", ("ring",)),
                cases=("ring",), deadline_s=1.0)
