"""The port's planner smokes on the CPU: ``scripts/torch_plan_smoke.py``,
``scripts/torch_dag_smoke.py`` and ``scripts/torch_capacity_smoke.py``,
each run ``--quick --device cpu`` as a subprocess.  Each must exit 0 and
print its JAX script's row (metric and keys); its clock-free fields are
held to the JAX package's planner on the same graphs and cost models, and
the ``slow`` pair test runs each JAX script beside its port and compares
every clock-free field."""

import numpy as np
import pytest

import defer_tpu.models as jm
from defer_tpu.graph import GraphBuilder as JaxGraphBuilder
from defer_tpu.graph import ops as jops
from defer_tpu.graph.analysis import auto_cut_points, branch_regions
from defer_tpu.plan import (StageCostModel, best_linear_plan,
                            calibrate_codecs, solve, solve_dag)
from defer_tpu.runtime.topology import ChainTopology

import torch_smoke_harness as H

#: the dag smoke's per-node cost off the simulated-device ops, its delay
#: and budgets (``scripts/dag_smoke.py``)
DAG_TINY = 1e-6
DAG_DELAY_S = 40.0 / 1e3


def _skewed():
    b = JaxGraphBuilder("skewed")
    x = b.input((64,))
    x = b.add(jops.Dense(16384), x, name="fat")
    x = b.add(jops.Dense(64), x, name="back")
    b.add(jops.Dense(64), x, name="head")
    return b.build()


@pytest.mark.timeout(240)
def test_plan_smoke_quick_cpu():
    row, _ = H.run("plan", timeout=200)
    H.check_row("plan", row)
    skew = row["models"]["skewed"]
    # the JAX planner on the skewed chain with the smoke's constants
    g = _skewed()
    cm = StageCostModel(g, batch=8, link_bw_s=1e8,
                        codecs=calibrate_codecs(("raw", "lzb", "bf8",
                                                 "bf16")))
    assert skew["plan_cuts"] == solve(g, 2, cm).cuts == ["back"]
    assert skew["quantile_cuts"] == auto_cut_points(g, 2) == ["fat"]
    assert row["value"] is None and row["link_bw"] == 1e8
    assert set(row["models"]) == {"resnet_tiny", "vgg_tiny", "gpt_tiny",
                                  "skewed"}
    for name in ("resnet_tiny", "vgg_tiny", "gpt_tiny"):
        m = row["models"][name]
        assert m["predicted_plan_ms"] <= m["predicted_quantile_ms"] * (
            1 + 1e-9), (name, m)


def _dag_case(g, heavy, budget):
    costs = {n: heavy.get(n, DAG_TINY) for n in g.topo_order}
    cm = StageCostModel(g, gen="v5e", link_bw_s=1e12, node_costs=costs)
    return solve_dag(g, cm, num_nodes=budget), best_linear_plan(g, cm,
                                                                  budget)


def _two_branch(g):
    region = next(r for r in branch_regions(g) if r.join == "mixed_3")
    return {n: DAG_DELAY_S / len(b.nodes)
            for b in region.branches[:2] for n in b.nodes}


@pytest.mark.timeout(240)
def test_dag_smoke_quick_cpu():
    row, _ = H.run("dag", timeout=200)
    H.check_row("dag", row)
    assert row["delay_ms"] == 40.0 and row["model"] == "inception_tiny"
    # the JAX planner on the smoke's graphs and delay-bound cost maps
    g = jm.inception_tiny()
    dag, lin = _dag_case(g, _two_branch(g), 5)
    topo = ChainTopology.from_json(dag.topology_json())
    assert row["planned"] == {
        "dag_bottleneck_ms": round(dag.bottleneck_s * 1e3, 4),
        "dag_critical_path_ms": round(dag.critical_path_s * 1e3, 4),
        "linear_bottleneck_ms": round(lin.bottleneck_s * 1e3, 4),
        "linear_stages": lin.num_stages, "budget": 5,
        "dag_labels": [v.label for v in topo.vertices]}
    gb = jm.moe_branched_tiny()
    heavy = {n: DAG_DELAY_S for n in gb.topo_order
             if n.startswith("block_") or "_e" in n}
    for name, (d, ln), budget in (
            ("inception_tiny", (dag, lin), 5),
            ("moe_branched_tiny", _dag_case(gb, heavy, 12), 12)):
        assert row["planner"][name] == {
            "budget": budget,
            "dag_bottleneck_ms": round(d.bottleneck_s * 1e3, 4),
            "dag_critical_path_ms": round(d.critical_path_s * 1e3, 4),
            "linear_bottleneck_ms": round(ln.bottleneck_s * 1e3, 4),
            "predicted_speedup": round(ln.bottleneck_s / d.bottleneck_s,
                                       4)}, name
    gm = jm.moe_tiny()
    cm = StageCostModel(gm, gen="v5e")
    assert row["planner"]["moe_tiny"] == {
        "degenerate_linear": True,
        "bottleneck_ms": round(solve_dag(gm, cm, num_nodes=4).bottleneck_s
                               * 1e3, 4)}
    q = row["quick"]
    assert q["speedup"] >= 1.45 and q["max_abs_err_vs_single_program"] < 1e-4


# slow: the script's calibrated-error, default-error and 5% overhead bounds, kept as its JAX
# script has it, failed under the load of a -n 6 tier-1 run
@pytest.mark.slow
@pytest.mark.timeout(240)
def test_capacity_smoke_quick_cpu():
    row, _ = H.run("capacity", timeout=200)
    H.check_row("capacity", row)
    # the checks the JAX script makes of its own row, on the port's
    assert row["bottleneck"] == 1 and row["monitor_frames"] == 40
    assert row["drift"]["stage"] == 1 and row["drift"]["intervals"] == 2
    assert row["drift"]["rel_err"] > 0.5
    assert row["value"] < 0.15 and row["err_default"] > max(
        2 * row["value"], 0.5)
    assert row["overhead"] < 0.05
    cal = row["calibration"]
    assert cal["schema"] == "defer_tpu.calibration.v1"
    assert {k: v["method"] for k, v in cal["provenance"].items()} == {
        "codec.dsleep10+raw": "measured", "codec.esleep10+raw": "measured",
        "host_sync_bw_s": "measured", "ici_bw_s": "prior",
        "link_bw_s": "measured", "local_bw_s": "bench"}
    # stage 1's frames: [2, 16, 16, 8] float32 in, [2, 8, 8, 32] out
    assert np.isfinite(row["pred_calibrated_ms"]).all()


def test_capacity_default_prediction_equals_the_jax_package():
    """The capacity smoke's uncalibrated strawman, priced alike by both
    packages: its cost model on resnet_tiny's 3-stage cuts, compute spread
    from a fixed per-stage service, and the smoke's delay hops (each
    side's sleep inside stage 1), predicts the same per-stage service."""
    import torch

    from defer_tpu import partition as jpartition
    from defer_tpu.plan import predict_stage_service_s as jpredict
    from defer_tpu_torch import models as tm
    from defer_tpu_torch import partition as tpartition
    from defer_tpu_torch.plan import StageCostModel as TStageCostModel
    from defer_tpu_torch.plan import predict_stage_service_s as tpredict

    measured = {0: 1.25, 1: 5.5, 2: 4.75}
    hops = ["dsleep10+raw", "esleep10+raw"]

    def node_costs(graph, stages):
        order = graph.topo_order
        pos = {n: i for i, n in enumerate(order)}
        cuts = [s.output_name for s in stages[:-1]]
        bounds = [0] + [pos[c] + 1 for c in cuts] + [len(order)]
        out = {}
        for k in range(len(bounds) - 1):
            names = order[bounds[k]:bounds[k + 1]]
            for n in names:
                out[n] = measured[k] / 1e3 / len(names)
        return cuts, out

    jg = jm.resnet_tiny()
    tg = tm.resnet_tiny()
    jcuts, jcosts = node_costs(jg, jpartition(jg, num_stages=3))
    tcuts, tcosts = node_costs(tg, tpartition(tg, num_stages=3))
    assert tcuts == jcuts
    jcm = StageCostModel(jg, gen="v4", link_bw_s=1e9, batch=2,
                         node_costs=jcosts)
    tcm = TStageCostModel(tg, gen="v4", link_bw_s=1e9, batch=2,
                          node_costs=tcosts)
    want = jpredict(jg, jcuts, hops, jcm)
    got = tpredict(tg, tcuts, hops, tcm)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert max(range(3), key=lambda k: got[k]) == 1


@pytest.mark.slow
@pytest.mark.timeout(900)
@pytest.mark.parametrize("name", ["plan", "dag", "capacity"])
def test_pair_with_the_jax_script(name):
    jrow, _ = H.run(name, jax=True, timeout=400)
    prow, _ = H.run(name, timeout=400)
    H.check_row(name, jrow)
    H.check_row(name, prow)
    assert H.clock_free(name, prow) == H.clock_free(name, jrow)
