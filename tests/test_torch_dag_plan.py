"""Port parity: the branch analysis and the DAG planner (``plan/dag.py``).

The scenarios of ``tests/test_dag_plan.py`` (all but its three
``ChainTopology`` tests: deploying a stage graph comes with ROADMAP item
A10c) run the same graph and cost inputs through the JAX package and the
port: branch regions, segment and stage-graph cuts, the linear shortage
message, and every ``solve_dag``/``brute_force_dag`` plan must be equal,
its JSON byte for byte (``json.dumps(..., sort_keys=True)``); a DAG plan's
JSON loads through either package's ``dag_plan_from_json``.
"""

import json
import types

import numpy as np
import pytest
import torch

import defer_tpu.plan as jplan
import defer_tpu.plan.dag as jdag
from defer_tpu.graph import analysis as janalysis
from defer_tpu.graph import ops as jops
from defer_tpu.graph.ir import GraphBuilder as JGraphBuilder
import defer_tpu.models as jmodels
import defer_tpu_torch.plan as tplan
import defer_tpu_torch.plan.dag as tdag
from defer_tpu_torch.graph import analysis as tanalysis
from defer_tpu_torch.graph import ops as tops
from defer_tpu_torch.graph.ir import GraphBuilder as TGraphBuilder
from defer_tpu_torch import models as tmodels

torch.set_num_threads(1)

J = types.SimpleNamespace(GraphBuilder=JGraphBuilder, ops=jops, plan=jplan,
                          dag=jdag, analysis=janalysis, models=jmodels)
T = types.SimpleNamespace(GraphBuilder=TGraphBuilder, ops=tops, plan=tplan,
                          dag=tdag, analysis=tanalysis, models=tmodels)


def _js(x) -> str:
    return json.dumps(x, sort_keys=True)


def both(scenario):
    want, got = scenario(J), scenario(T)
    assert _js(got) == _js(want)
    return got


def _regions(pk, g):
    return [{"fork": r.fork, "join": r.join, "width": r.width,
             "branch_nodes": list(r.branch_nodes),
             "branches": [{"nodes": list(b.nodes), "out": b.out,
                           "empty": b.empty} for b in r.branches]}
            for r in pk.analysis.branch_regions(g)]


def branchy(pk, widths, depths, *, residual=(), name="branchy"):
    b = pk.GraphBuilder(name)
    x = b.input((8,))
    x = b.add(pk.ops.Dense(8), x, name="stem")
    for i, (w, d) in enumerate(zip(widths, depths)):
        branches = []
        for p in range(w):
            y = x
            for k in range(d):
                y = b.add(pk.ops.Dense(8), y, name=f"r{i}b{p}n{k}")
            branches.append(y)
        skip = [x] if i in residual else []
        x = b.add(pk.ops.Add(), skip + branches, name=f"join{i}")
        x = b.add(pk.ops.Dense(8), x, name=f"trunk{i}")
    return b.build()


# -- branch-region analysis -------------------------------------------------


@pytest.mark.parametrize("model", ["inception_tiny", "moe_branched_tiny",
                                   "moe_tiny", "resnet_tiny"])
def test_branch_analysis_matches_zoo(model):
    """``branch_regions``, ``dag_cut_points``, every branch's
    ``segment_cut_points`` and ``linear_cut_shortage`` at a few stage
    counts, equal in both packages."""
    def scenario(pk):
        g = getattr(pk.models, model)()
        regions = pk.analysis.branch_regions(g)
        return {"regions": _regions(pk, g),
                "dag_cuts": pk.analysis.dag_cut_points(g),
                "segments": [pk.analysis.segment_cut_points(
                    g, b.nodes, r.fork) for r in regions
                    for b in r.branches],
                "shortage": [pk.analysis.linear_cut_shortage(g, n)
                             for n in (2, 7, 10, 40)]}
    r = both(scenario)
    if model == "inception_tiny":
        assert [x["join"] for x in r["regions"]] == \
            [f"mixed_{i}" for i in range(11)]


def test_branch_regions_inception():
    def scenario(pk):
        return _regions(pk, pk.models.inception_tiny())
    regions = both(scenario)
    widths = {r["join"]: r["width"] for r in regions}
    assert widths["mixed_0"] == 4 and widths["mixed_3"] == 3
    for r in regions:
        inner = r["branch_nodes"]
        assert len(inner) == len(set(inner))
        assert all(not b["empty"] for b in r["branches"])


def test_branch_regions_residual_skip():
    regions = both(lambda pk: _regions(pk, pk.models.moe_branched_tiny()))
    assert [(r["fork"], r["join"], r["width"]) for r in regions] == [
        ("block_0", "moe_0", 5), ("block_1", "moe_1", 5)]
    for r in regions:
        assert r["branches"][0]["empty"]
        assert r["branches"][0]["out"] == r["fork"]
        assert all(not b["empty"] for b in r["branches"][1:])


def test_branch_regions_rejects_shared_intermediate():
    def scenario(pk):
        b = pk.GraphBuilder("shared")
        x = b.input((8,))
        x = b.add(pk.ops.Dense(8), x, name="fork")
        mid = b.add(pk.ops.Dense(8), x, name="mid")
        p = b.add(pk.ops.Dense(8), mid, name="p")
        q = b.add(pk.ops.Add(), [mid, x], name="q")
        x = b.add(pk.ops.Concat(), [p, q], name="join")
        return {"shared": _regions(pk, b.build()),
                "branchy": _regions(pk, branchy(pk, [2], [2]))}
    r = both(scenario)
    assert r["shared"] == [] and r["branchy"][0]["width"] == 2


def test_branch_regions_rejects_duplicate_fork_input():
    def scenario(pk):
        b = pk.GraphBuilder("dupfork")
        x = b.input((8,))
        x = b.add(pk.ops.Dense(8), x, name="fork")
        p = b.add(pk.ops.Dense(8), x, name="p")
        x = b.add(pk.ops.Add(), [x, x, p], name="join")
        return _regions(pk, b.build())
    assert both(scenario) == []


def test_segment_and_dag_cut_points():
    def scenario(pk):
        g = branchy(pk, [2], [3])
        (r,) = pk.analysis.branch_regions(g)
        return {"segments": [[list(b.nodes),
                              pk.analysis.segment_cut_points(g, b.nodes,
                                                             r.fork)]
                             for b in r.branches],
                "dag": pk.analysis.dag_cut_points(g),
                "valid": pk.analysis.valid_cut_points(g)}
    r = both(scenario)
    for nodes, cuts in r["segments"]:
        assert cuts == nodes[:2]
    assert set(r["valid"]) < set(r["dag"])
    assert "r0b0n0" in r["dag"] and "r0b1n1" in r["dag"]


def test_linear_cut_shortage_names_merges():
    def scenario(pk):
        b = pk.GraphBuilder("chain3")
        x = b.input((8,))
        for i in range(3):
            x = b.add(pk.ops.Dense(8), x, name=f"d{i}")
        g = pk.models.moe_branched_tiny()
        return [pk.analysis.linear_cut_shortage(g, 7),
                pk.analysis.linear_cut_shortage(g, 10),
                pk.analysis.linear_cut_shortage(b.build(), 9)]
    ok, msg, plain = both(scenario)
    assert ok is None
    assert "moe_0" in msg and "moe_1" in msg and "--dag" in msg
    assert "9 stages" in plain and "--dag" not in plain


# -- solver vs brute force --------------------------------------------------


def _random_costs(g, rng):
    costs = {n: float(rng.uniform(1e-4, 2e-3)) for n in g.topo_order}
    return costs, float(rng.choice([1e7, 1e9, 1e11]))


def _key(plan):
    return [round(plan.bottleneck_s, 12), round(plan.critical_path_s, 12),
            plan.num_nodes]


@pytest.mark.parametrize("shape", [
    ([2], [1], ()), ([2], [2], ()), ([3], [1], (0,)),
    ([2, 2], [1, 2], (1,)), ([2, 3], [2, 1], ())])
def test_solve_dag_matches_brute_force(shape):
    widths, depths, residual = shape
    rng = np.random.default_rng(sum(widths) * 7 + sum(depths))
    for trial in range(3):
        costs, link = _random_costs(
            branchy(T, widths, depths, residual=residual), rng)

        def scenario(pk):
            g = branchy(pk, widths, depths, residual=residual)
            cm = pk.plan.StageCostModel(g, gen="v5e", link_bw_s=link,
                                        node_costs=costs)
            out = []
            for budget in (1, 2, 4, 6):
                got = pk.plan.solve_dag(g, cm, num_nodes=budget)
                want = pk.plan.brute_force_dag(g, cm, num_nodes=budget)
                out.append({"got": got.to_json(), "key": _key(got),
                            "want": _key(want)})
            return out
        for r in both(scenario):
            assert r["key"] == r["want"]


def test_solve_dag_prefers_branching_when_compute_bound():
    def scenario(pk):
        g = branchy(pk, [2], [1])
        costs = {n: 1e-6 for n in g.topo_order}
        costs["r0b0n0"] = costs["r0b1n0"] = 1e-2
        cm = pk.plan.StageCostModel(g, gen="v5e", link_bw_s=1e12,
                                    node_costs=costs)
        plan = pk.plan.solve_dag(g, cm, num_nodes=4)
        lin = pk.plan.best_linear_plan(g, cm, 4)
        return {"plan": plan.to_json(), "b": plan.bottleneck_s,
                "lin": lin.to_json(), "lb": lin.bottleneck_s}
    r = both(scenario)
    assert r["plan"]["parallel_regions"] == [
        {"fork": "stem", "join": "join0", "paths": 2}]
    assert r["b"] == pytest.approx(1e-2, rel=1e-3)
    assert r["b"] < r["lb"]


def test_solve_dag_degenerates_to_linear():
    def scenario(pk):
        g = pk.models.moe_tiny()
        plan = pk.plan.solve_dag(g, pk.plan.StageCostModel(g, gen="v5e"),
                                 num_nodes=3)
        bg = branchy(pk, [2], [2])
        one = pk.plan.solve_dag(bg, pk.plan.StageCostModel(bg, gen="v5e"),
                                num_nodes=1)
        return {"plan": plan.to_json(), "one": one.num_stages}
    r = both(scenario)
    assert r["plan"]["parallel_regions"] == []
    for v in r["plan"]["topology"]["vertices"]:
        assert v["fan"] == "unicast" and v["join"] == 0 \
            and v["branch"] is None
    assert r["one"] == 1


@pytest.mark.parametrize("model,nodes", [("inception_tiny", 6),
                                         ("moe_branched_tiny", 8)])
def test_solve_dag_prices_the_zoo(model, nodes):
    """The branched MoE and Inception priced on the analytic model (gen
    pinned): the same stage graph, topology document included."""
    def scenario(pk):
        g = getattr(pk.models, model)()
        cm = pk.plan.StageCostModel(g, gen="v5e", link_bw_s=1e9)
        return {"dag": pk.plan.solve_dag(g, cm, num_nodes=nodes).to_json(),
                "lin": pk.plan.best_linear_plan(g, cm, nodes).to_json()}
    r = both(scenario)
    assert r["dag"]["topology"]["format"] == "defer_tpu.topology.v1"
    assert r["dag"]["num_nodes"] <= nodes


def test_dag_plan_json_round_trip():
    def scenario(pk):
        g = branchy(pk, [2], [2], residual=(0,))
        costs = {n: 1e-3 for n in g.topo_order}
        cm = pk.plan.StageCostModel(g, gen="v5e", link_bw_s=1e12,
                                    node_costs=costs)
        return pk.plan.solve_dag(g, cm, num_nodes=5).to_json()
    doc = both(scenario)
    assert doc["parallel_regions"]
    for load in (jplan.dag_plan_from_json, tplan.dag_plan_from_json):
        back = load(doc)
        assert [v.label for v in back.vertices] == doc["labels"]
        assert _js(back.to_json()) == _js(doc)
        assert _js(load({"dag_plan": doc}).to_json()) == _js(doc)
    back = tplan.dag_plan_from_json(doc)
    assert round(back.bottleneck_s * 1e3, 6) == doc["bottleneck_ms"]
    assert round(back.critical_path_s * 1e3, 6) == doc["critical_path_ms"]
    topo = doc["topology"]["vertices"]
    assert sum(1 for v in topo if v["fan"] == "broadcast") == 1
    assert sum(1 for v in topo if v["join"] >= 2) == 1


# -- stage-graph hop tiers (loud-miss policy) -------------------------------


def _flat_model(pk, g):
    costs = {n: 1e-3 for n in g.topo_order}
    return pk.plan.StageCostModel(g, gen="v5e", link_bw_s=1e12,
                                  node_costs=costs)


def test_dag_hop_tiers_accept_branch_internal_cuts():
    def scenario(pk):
        g = branchy(pk, [2], [2])
        cm = _flat_model(pk, g)
        return pk.plan.solve_dag(g, cm, num_nodes=6,
                                 hop_tiers={"r0b0n0": "local"}).to_json()
    assert both(scenario)["num_stages"] >= 1
    g = branchy(T, [2], [2])
    cm = _flat_model(T, g)
    with pytest.raises(ValueError, match="not valid cut points"):
        cm.with_hop_tiers({"r0b0n0": "local"})
    with pytest.raises(ValueError, match="not valid cut points"):
        tplan.solve_dag(g, cm, num_nodes=6, hop_tiers={"nope": "local"})


def test_dag_hop_tiers_reject_fan_boundaries():
    g = branchy(T, [2], [2])
    cm = _flat_model(T, g)
    with pytest.raises(ValueError, match="wire-framed"):
        tplan.solve_dag(g, cm, num_nodes=6, hop_tiers={"stem": "local"})
    with pytest.raises(ValueError, match="wire-framed"):
        tplan.solve_dag(g, cm, num_nodes=6, hop_tiers={"r0b1n1": "device"})
    both(lambda pk: [pk.plan.solve_dag(
        branchy(pk, [2], [2]), _flat_model(pk, branchy(pk, [2], [2])),
        num_nodes=6, hop_tiers={h: "tcp"}).to_json()
        for h in ("stem", "r0b1n1")])


def test_cli_plan_dag_json(capsys):
    """``plan --dag --json`` prints the JAX package's document."""
    from defer_tpu.cli import main as jmain
    from defer_tpu_torch.cli import main as tmain
    argv = ["plan", "--model", "moe_branched_tiny", "--dag", "--nodes", "8",
            "--link-bw", "1e9", "--json"]
    docs = []
    for main in (jmain, tmain):
        main(list(argv))
        docs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    assert _js(docs[0]) == _js(docs[1])
    assert docs[1]["plan"]["topology"]["vertices"]
