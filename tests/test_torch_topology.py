"""Port parity: the chain topology (``defer_tpu_torch.runtime.topology``),
the DAG partitioner (``partition.stage_specs_for_vertices`` with
``JoinStageSpec``), ``LayerGraph.apply(seeds=)`` and join-stage artifacts,
held to the JAX package on the same graphs and inputs.

* Topology documents: both packages' ``solve_dag`` on the same graph and
  pinned costs give EQUAL ``defer_tpu.topology.v1`` documents (the solver
  is Python float arithmetic in the same order), and each package's
  ``from_json`` reads the other's and writes it back unchanged.
* Validation and mutation raise the JAX package's messages.
* ``apply(seeds=)``, ``JoinStageSpec.fn`` and a join artifact's program
  agree with the JAX package within 1e-5 of max |output| (f32; the
  matmuls sum in another order than XLA's).
"""

import io
import json
import zipfile

import jax
import numpy as np
import pytest
import torch

import defer_tpu.models as jmodels
from defer_tpu import partition as jpartition
from defer_tpu.graph import ops as jops
from defer_tpu.graph.analysis import branch_regions as jbranch_regions
from defer_tpu.graph.ir import GraphBuilder as JGraphBuilder
from defer_tpu.partition.partitioner import (
    stage_specs_for_vertices as jstage_specs)
from defer_tpu.plan import StageCostModel as JCostModel
from defer_tpu.plan import solve_dag as jsolve_dag
from defer_tpu.runtime import topology as jtopology
from defer_tpu.utils import export as jexport
from defer_tpu_torch import models as tmodels
from defer_tpu_torch import params_from_jax
from defer_tpu_torch import partition as tpartition
from defer_tpu_torch.graph import ops as tops
from defer_tpu_torch.graph.ir import GraphBuilder as TGraphBuilder
from defer_tpu_torch.partition import (JoinStageSpec, StageModule,
                                       stage_specs_for_vertices)
from defer_tpu_torch.plan import StageCostModel as TCostModel
from defer_tpu_torch.plan import solve_dag as tsolve_dag
from defer_tpu_torch.runtime import topology as ttopology
from defer_tpu_torch.runtime.topology import (TOPOLOGY_FORMAT, ChainTopology,
                                              TopoVertex)
from defer_tpu_torch.utils import export as texport

REL = 1e-5


def two_branch(builder, ops):
    """input -> stem -> {b0: 2 Dense, b1: 1 Dense, residual} -> Add ->
    head: one region with an empty branch (``tests/test_dag_chain.py``'s
    graph), in either package."""
    b = builder("twobranch")
    x = b.input((8,))
    x = b.add(ops.Dense(8), x, name="stem")
    p = b.add(ops.Dense(8), x, name="b0n0")
    p = b.add(ops.Dense(8), p, name="b0n1")
    q = b.add(ops.Dense(8), x, name="b1n0")
    x = b.add(ops.Add(), [x, p, q], name="join")
    x = b.add(ops.Dense(4), x, name="head")
    return b.build()


def _heavy(name: str, g) -> dict:
    """The pinned prices each scenario solves with (as the JAX DAG chain
    tests price them)."""
    if name == "twobranch":
        return {"b0n0": 1e-3, "b0n1": 1e-3, "b1n0": 2e-3}
    if name == "moe_branched_tiny":
        return {n: 1e-3 for n in g.topo_order
                if n.startswith("block_") or "_e" in n}
    region = next(r for r in jbranch_regions(g) if r.join == "mixed_3")
    return {n: 1e-3 for b in region.branches[:2] for n in b.nodes}


BUDGET = {"twobranch": 5, "moe_branched_tiny": 12, "inception_tiny": 5}


def _graphs(name: str):
    if name == "twobranch":
        return two_branch(JGraphBuilder, jops), two_branch(TGraphBuilder,
                                                           tops)
    return getattr(jmodels, name)(), getattr(tmodels, name)()


def _docs(name: str):
    """Both packages' solved plans for ``name``: (JAX plan JSON, port plan
    JSON, JAX graph, port graph)."""
    jg, tg = _graphs(name)
    heavy = _heavy(name, jg)
    jcm = JCostModel(jg, gen="v5e", link_bw_s=1e12,
                     node_costs={n: heavy.get(n, 1e-6) for n in jg.topo_order})
    tcm = TCostModel(tg, gen="v5e", link_bw_s=1e12,
                     node_costs={n: heavy.get(n, 1e-6) for n in tg.topo_order})
    jplan = jsolve_dag(jg, jcm, num_nodes=BUDGET[name])
    tplan = tsolve_dag(tg, tcm, num_nodes=BUDGET[name])
    return jplan, tplan, jg, tg


@pytest.mark.parametrize("name", ["twobranch", "moe_branched_tiny",
                                  "inception_tiny"])
def test_topology_documents_equal_across_packages(name):
    """The solved topologies are equal documents, and each package's
    ``from_json`` reads the other's (bare, inside a plan, inside a whole
    ``plan --dag --json`` document) and writes it back unchanged."""
    jplan, tplan, jg, tg = _docs(name)
    jdoc, tdoc = jplan.topology_json(), tplan.topology_json()
    assert json.dumps(tdoc, sort_keys=True) == json.dumps(jdoc,
                                                          sort_keys=True)
    assert tdoc["format"] == TOPOLOGY_FORMAT == jtopology.TOPOLOGY_FORMAT
    for wrap in (lambda d: d, lambda d: {"topology": d},
                 lambda d: {"plan": {"topology": d}}):
        assert ChainTopology.from_json(wrap(jdoc)).to_json() == jdoc
        assert jtopology.ChainTopology.from_json(
            wrap(tdoc)).to_json() == tdoc
    topo = ChainTopology.from_json(tplan.to_json())
    jtopo = jtopology.ChainTopology.from_json(jplan.to_json())
    assert [v.label for v in topo] == [v.label for v in jtopo]
    assert repr(topo) == repr(jtopo)
    assert len(topo) == {"twobranch": 4, "moe_branched_tiny": 11,
                         "inception_tiny": 5}[name]
    # the DAG partitioner gives the JAX package's stages, vertex by vertex
    specs = topo.stage_specs(tg)
    jspecs = jtopo.stage_specs(jg)
    for s, js in zip(specs, jspecs):
        assert type(s).__name__ == type(js).__name__
        assert s.node_names == js.node_names and s.name == js.name
        assert s.output_name == js.output_name
        assert tuple(s.out_spec.shape) == tuple(js.out_spec.shape)
        if isinstance(s, JoinStageSpec):
            assert s.input_names == js.input_names
            assert s.num_inputs == js.num_inputs == len(s.in_specs)
            assert repr(s) == repr(js)
        else:
            assert s.input_name == js.input_name


def _v(vid, nxt, **kw):
    base = dict(vid=vid, nodes=(f"n{vid}",), inputs=("x",),
                output=f"n{vid}", next=tuple(nxt))
    base.update(kw)
    return base


#: malformed vertex lists, each refused with the JAX package's message
BAD = {
    "empty": [],
    "ids": [_v(1, ())],
    "two_exits": [_v(0, ()), _v(1, ())],
    "fan_mismatch": [_v(0, (1, 2)), _v(1, (2,)), _v(2, ())],
    "bad_fan": [_v(0, (1,), fan="multicast"), _v(1, ())],
    "backward_edge": [_v(0, (1,)), _v(1, (0,)), _v(2, ())],
    "two_entries": [_v(0, (2,)), _v(1, (2,)), _v(2, (), join=2,
                                                  inputs=("a", "b"))],
    "join_inputs": [_v(0, (1, 2), fan="broadcast"), _v(1, (2,), branch=1),
                    _v(2, (), join=2)],
    "join_labels": [_v(0, (1, 2), fan="broadcast"), _v(1, (2,), branch=1),
                    _v(2, (), join=2, inputs=("a", "b"))],
    "unlabeled_into_join": [_v(0, (1,)), _v(1, (2,)),
                            _v(2, (), join=2, inputs=("a", "b"))],
    "indegree_without_join": [_v(0, (1, 2), fan="broadcast"),
                              _v(1, (2,), branch=0), _v(2, ())],
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validate_refuses_like_jax(case):
    def err(pk):
        with pytest.raises(ValueError) as ei:
            pk.ChainTopology([pk.TopoVertex(**d) for d in BAD[case]])
        return str(ei.value)

    assert err(ttopology) == err(jtopology)


def test_from_json_refuses_another_format():
    with pytest.raises(ValueError, match="not a defer_tpu.topology.v1"):
        ChainTopology.from_json({"format": "defer_tpu.stage.v1",
                                 "vertices": []})


def test_update_move_boundary_and_diff_like_jax():
    """A vertex edit, a rolled-back invalid edit, a boundary move and the
    diff between two topologies give the JAX package's results."""
    jplan, tplan, _, _ = _docs("twobranch")

    def run(pk, doc):
        topo = pk.ChainTopology.from_json(doc)
        before = topo.copy()
        topo.update(1, codec="lzb")
        with pytest.raises(ValueError) as ei:
            topo.update(0, fan="unicast")   # 3 downstreams, no broadcast
        assert topo.vertices[0].fan == "broadcast"    # rolled back
        with pytest.raises(ValueError):
            topo.update(9, codec="raw")
        with pytest.raises(ValueError, match="no downstream"):
            topo.move_boundary(len(topo) - 1, nodes=(), output="x",
                               downstream_nodes=(), downstream_inputs=())
        return (str(ei.value), before.diff(topo), topo.to_json())

    assert run(ttopology, tplan.topology_json()) == run(
        jtopology, jplan.topology_json())


def test_linear_topology_of_a_partition_like_jax():
    """``ChainTopology.linear`` of the same cuts: equal documents, every
    vertex a unicast relay, labels ``stageK``."""
    jg = jmodels.resnet_tiny()
    tg = tmodels.resnet_tiny()
    jstages = jpartition(jg, num_stages=3)
    tstages = tpartition(tg, [s.output_name for s in jstages[:-1]])
    codecs = ["raw", "lzb", "raw"]
    t = ChainTopology.linear(tstages, codecs=codecs)
    j = jtopology.ChainTopology.linear(jstages, codecs=codecs)
    assert t.to_json() == j.to_json()
    assert [v.label for v in t] == ["stage0", "stage1", "stage2"]
    assert t.entry.vid == 0 and t.exit.vid == 2
    assert t.upstreams(2)[0].vid == 1


@pytest.mark.parametrize("vid,mutate,match", [
    (3, lambda v: dict(v, nodes=v["nodes"] + ["nope"]), "unknown node"),
    (1, lambda v: dict(v, nodes=["b0n1"]), "neither the vertex slice"),
    (3, lambda v: dict(v, output="join"), "must be the slice's final node"),
])
def test_stage_specs_refuse_like_jax(vid, mutate, match):
    """A vertex whose slice is not closed, names an unknown node or does
    not end at its output is refused with the JAX package's message."""
    jplan, tplan, jg, tg = _docs("twobranch")
    doc = tplan.topology_json()
    vs = doc["vertices"]
    vs[vid] = mutate(dict(vs[vid]))

    def err(pk, g, specs):
        topo = pk.ChainTopology.from_json(doc)
        with pytest.raises(ValueError, match=match) as ei:
            specs(g, topo.vertices)
        return str(ei.value)

    assert err(ttopology, tg, stage_specs_for_vertices) == err(
        jtopology, jg, jstage_specs)


@pytest.fixture(scope="module")
def twobranch():
    """The two-branch graph in both packages, with the JAX package's
    weights carried across as numpy."""
    jg, tg = _graphs("twobranch")
    jp = jg.init(jax.random.key(0))
    tp = params_from_jax(tg, jax.tree.map(np.asarray, jp))
    return jg, jp, tg, tp


def test_apply_with_seeds_matches_jax(twobranch):
    """``apply(seeds=)`` resumes from several boundary tensors at once:
    the join's slice from {stem, b0n1, b1n0}, equal within REL of the JAX
    package's on the same seeds, and equal to the whole forward."""
    jg, jp, tg, tp = twobranch
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    names = ("join", "head")
    seeds = {"stem": x, "b0n1": x * 2, "b1n0": x - 1}
    got = tg.apply(tp, seeds={k: torch.from_numpy(v)
                              for k, v in seeds.items()},
                   node_names=names).numpy()
    want = np.asarray(jg.apply(jp, seeds=seeds, node_names=names))
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    with pytest.raises(TypeError, match="seeds"):
        tg.apply(tp)
    # seeded with the forward's own boundaries, the slice gives the forward
    xt = torch.from_numpy(x)
    stem = tg.apply(tp, xt, upto="stem")
    b0 = tg.apply(tp, stem, start="stem", upto="b0n1",
                  node_names=("b0n0", "b0n1"))
    b1 = tg.apply(tp, stem, start="stem", upto="b1n0", node_names=("b1n0",))
    y = tg.apply(tp, seeds={"stem": stem, "b0n1": b0, "b1n0": b1},
                 node_names=names)
    assert torch.equal(y, tg.apply(tp, xt))


def test_join_stage_fn_module_and_artifact_match_jax(twobranch):
    """The solved join vertex as a ``JoinStageSpec``: its ``fn``, a
    ``StageModule`` holding it and its exported artifact (a program of 3
    inputs) agree with the JAX package's join stage on the same inputs;
    the manifest carries the JAX package's join keys; the wrong input
    count raises everywhere."""
    jg, jp, tg, tp = twobranch
    jplan, tplan, _, _ = _docs("twobranch")
    join = ChainTopology.from_json(tplan.topology_json()).stage_specs(tg)[-1]
    jjoin = jtopology.ChainTopology.from_json(
        jplan.topology_json()).stage_specs(jg)[-1]
    assert isinstance(join, JoinStageSpec) and join.num_inputs == 3
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((2, 8)).astype(np.float32) for _ in range(3)]
    want = np.asarray(jjoin.fn(jjoin.select_params(jp), *xs))
    scale = np.abs(want).max()
    ts = [torch.from_numpy(x) for x in xs]
    got = join.fn(join.select_params(tp), *ts).numpy()
    assert np.abs(got - want).max() <= REL * scale
    mod = StageModule(join, tp, torch.device("cpu"))
    assert np.abs(mod(*ts).numpy() - want).max() <= REL * scale
    blob = texport.export_stage_bytes(join, tp, batch=2)
    prog = texport.load_stage_program(blob, device="cpu")
    out = prog(*xs)
    assert torch.equal(out, join.fn(join.select_params(tp), *ts))
    m = prog.manifest
    with zipfile.ZipFile(io.BytesIO(
            jexport.export_stage_bytes(jjoin, jp, batch=2))) as z:
        jm = json.loads(z.read("manifest.json"))
    for key, val in {"num_inputs": 3, "in_shapes": [[8], [8], [8]],
                     "in_dtypes": ["float32"] * 3,
                     "input": "stem,b0n1,b1n0", "output": "head",
                     "in_shape": [8], "batch": 2}.items():
        assert m[key] == val == jm[key], key
    with pytest.raises(ValueError, match="takes 3 inputs"):
        prog(xs[0])
    with pytest.raises(ValueError, match="takes 3 inputs"):
        join.fn(join.select_params(tp), ts[0])
