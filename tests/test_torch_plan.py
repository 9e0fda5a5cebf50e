"""Port parity: the planner (``plan/``), its CLI and the card's row.

Each scenario of ``tests/test_plan.py`` (all but the socket-buffer sizing,
which comes with the CLI's ``--sock-buf``) and the hop-tier scenarios of
``tests/test_colocate.py``, ``test_shm.py`` and ``test_ici.py`` runs the
same graph and cost inputs through the JAX package and the port.  The
planner is Python float arithmetic in the reference's order, so cuts,
codecs, replica counts, ``bottleneck_s`` and the plan JSON must be EQUAL
(``json.dumps(..., sort_keys=True)``), not merely close; the reference's
own assertions then hold on the port's result.  Every cost model pins
``gen`` (or passes its bandwidths), so the card's row never enters a
comparison.
"""

import json
import random
import types

import pytest
import torch

import defer_tpu.plan as jplan
from defer_tpu import GraphBuilder as JGraphBuilder
from defer_tpu import partition as jpartition
from defer_tpu.graph import analysis as janalysis
from defer_tpu.graph import ops as jops
import defer_tpu.models as jmodels
import defer_tpu_torch as dt
import defer_tpu_torch.plan as tplan
from defer_tpu_torch import partition as tpartition
from defer_tpu_torch.graph import analysis as tanalysis
from defer_tpu_torch.graph import ops as tops
from defer_tpu_torch.graph.ir import GraphBuilder as TGraphBuilder
from defer_tpu_torch import models as tmodels
from defer_tpu_torch.utils import hw

torch.set_num_threads(1)

J = types.SimpleNamespace(GraphBuilder=JGraphBuilder, ops=jops, plan=jplan,
                          analysis=janalysis, partition=jpartition,
                          models=jmodels, name="jax")
T = types.SimpleNamespace(GraphBuilder=TGraphBuilder, ops=tops, plan=tplan,
                          analysis=tanalysis, partition=tpartition,
                          models=tmodels, name="torch")


def _js(x) -> str:
    if hasattr(x, "to_json"):
        x = x.to_json()
    return json.dumps(x, sort_keys=True)


def both(scenario):
    """Run ``scenario(pk)`` for the JAX package and the port; their
    results must serialize identically.  Returns the port's."""
    want, got = scenario(J), scenario(T)
    assert _js(got) == _js(want)
    return got


def dense_chain(pk, widths, name="chain", in_width=8):
    b = pk.GraphBuilder(name)
    x = b.input((in_width,))
    for i, w in enumerate(widths):
        x = b.add(pk.ops.Dense(w), x, name=f"fc{i}")
    return b.build()


def random_spec(rng: random.Random, idx: int):
    """The layer choices of ``tests/test_plan.py::random_graph``, drawn in
    the same order from ``rng`` (so both packages build one graph)."""
    spec = {"name": f"rand{idx}", "in": rng.choice([2, 4, 8, 16]),
            "layers": []}
    n = rng.randint(3, 9)
    for _ in range(n):
        w = rng.choice([2, 4, 8, 32, 128])
        spec["layers"].append((w, rng.random() < 0.25))
    return spec


def build_spec(pk, spec):
    b = pk.GraphBuilder(spec["name"])
    x = b.input((spec["in"],))
    for i, (w, diamond) in enumerate(spec["layers"]):
        if diamond:
            l = b.add(pk.ops.Dense(w), x, name=f"l{i}")
            r = b.add(pk.ops.Dense(w), x, name=f"r{i}")
            x = b.add(pk.ops.Add(), [l, r], name=f"m{i}")
        else:
            x = b.add(pk.ops.Dense(w), x, name=f"d{i}")
    return b.build()


# -- the card's row ----------------------------------------------------------


def test_identify_chip_cpu_and_card_names():
    assert hw.identify_chip(torch.device("cpu")) == "unknown"
    assert hw.identify_chip("cpu") == "unknown"
    assert hw.card_generation("NVIDIA H100 80GB HBM3") == "h100"
    for other in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                  "NVIDIA A100-SXM4-80GB", "NVIDIA H200"):
        assert hw.card_generation(other) == "unknown"
    assert hw.peak_flops("h100") == 989e12
    assert hw.hbm_bandwidth("h100") == 3.35e12
    assert hw.ici_bandwidth("h100") == 450e9
    assert hw.peak_flops("unknown") == 0.0
    # the TPU rows are the reference's data, kept for the v5e fallback
    from defer_tpu.utils import hw as jhw
    for gen in ("v2", "v3", "v4", "v5e", "v5p", "v6e"):
        assert hw.peak_flops(gen) == jhw.peak_flops(gen)
        assert hw.hbm_bandwidth(gen) == jhw.hbm_bandwidth(gen)
        assert hw.ici_bandwidth(gen) == jhw.ici_bandwidth(gen)
    m = hw.analytic_pipeline_model([1e-3, 2e-3], 4096, 4.5e10)
    assert m == jhw.analytic_pipeline_model([1e-3, 2e-3], 4096, 4.5e10)


def test_cost_model_detects_no_card_on_the_cpu():
    """Off the card the port detects "unknown" and ranks against the v5e
    row, as the JAX package does on the CPU; an h100 model takes the
    card's data-sheet peaks."""
    g = tmodels.resnet_tiny()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cm = tplan.StageCostModel(g)
    assert cm.gen == "unknown"
    assert cm.peak_flops_s == hw.peak_flops("v5e")
    h = tplan.StageCostModel(g, gen="h100")
    assert (h.peak_flops_s, h.hbm_bw_s, h.link_bw_s, h.ici_bw_s) == (
        989e12, 3.35e12, 450e9, 450e9)


# -- solver optimality -------------------------------------------------------


def test_dp_matches_brute_force_property():
    """The DP equals exhaustive enumeration's bottleneck on every random
    small graph and stage count, bisect agrees — and every plan is the
    JAX package's, float for float."""
    rng = random.Random(7)
    checked = 0
    for t in range(14):
        spec = random_spec(rng, t)
        graphs = {pk.name: build_spec(pk, spec) for pk in (J, T)}
        C = len(tanalysis.valid_cut_points(graphs["torch"]))
        if C == 0:
            continue
        batch, link = rng.choice([1, 4]), rng.choice([1e5, 1e7, 1e9])
        for S in range(2, min(C + 1, 5) + 1):
            def scenario(pk):
                g = graphs[pk.name]
                cm = pk.plan.StageCostModel(g, batch=batch, gen="v4",
                                            link_bw_s=link)
                return [pk.plan.solve(g, S, cm).to_json(),
                        pk.plan.solve(g, S, cm, method="bisect").to_json(),
                        pk.plan.brute_force(g, S, cm).to_json()]
            p_dp, p_bi, p_bf = both(scenario)
            tol = 1e-12 + 1e-6 * p_bf["bottleneck_ms"]
            assert abs(p_dp["bottleneck_ms"] - p_bf["bottleneck_ms"]) <= tol
            assert abs(p_bi["bottleneck_ms"] - p_bf["bottleneck_ms"]) <= tol
            assert len(p_dp["cuts"]) == len(p_dp["hop_codecs"]) == S - 1
            checked += 1
    assert checked >= 20


def test_solver_beats_or_matches_quantile_on_same_model():
    def scenario(pk):
        g = dense_chain(pk, [16, 64, 16, 64, 16, 64, 16])
        cm = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e6)
        return [(pk.plan.solve(g, S, cm).to_json(),
                 pk.plan.evaluate_cuts(g, pk.analysis.auto_cut_points(g, S),
                                       cm).to_json()) for S in (2, 3, 4)]
    for plan, q in both(scenario):
        assert plan["bottleneck_ms"] <= q["bottleneck_ms"] * (1 + 1e-9)


def test_solver_avoids_fat_boundary():
    def scenario(pk):
        g = dense_chain(pk, [4096, 16, 16], in_width=16)
        cm = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e6)
        q = pk.analysis.auto_cut_points(g, 2)
        return {"q": q, "plan": pk.plan.solve(g, 2, cm).to_json(),
                "q_plan": pk.plan.evaluate_cuts(g, q, cm).to_json(),
                "auto": pk.analysis.auto_cut_points(
                    g, 2, objective="bottleneck", cost_model=cm),
                "part": [s.output_name for s in pk.partition(
                    g, num_stages=2, objective="bottleneck",
                    cost_model=cm)][:-1]}
    r = both(scenario)
    assert r["q"] == ["fc0"]
    assert r["plan"]["cuts"] == ["fc1"] == r["auto"] == r["part"]
    assert r["plan"]["bottleneck_ms"] < r["q_plan"]["bottleneck_ms"]


def test_solver_errors():
    g = dense_chain(T, [8, 8])
    cm = tplan.StageCostModel(g, gen="v4")
    with pytest.raises(ValueError, match="valid cut points"):
        tplan.solve(g, 50, cm)
    with pytest.raises(ValueError, match="num_stages"):
        tplan.solve(g, 0, cm)
    with pytest.raises(ValueError, match="objective"):
        tanalysis.auto_cut_points(g, 2, objective="nope")
    assert tplan.solve(g, 1, cm).cuts == []
    with pytest.raises(ValueError, match="nothing to balance"):
        tpartition(g, ["fc0"], cost_model=cm)


@pytest.mark.parametrize("model,stages", [
    ("resnet_tiny", 4), ("inception_tiny", 3), ("bert_tiny", 3),
    ("moe_branched_tiny", 2), ("mobilenet_tiny", 3)])
def test_auto_cut_points_bottleneck_matches_zoo(model, stages):
    """``objective="bottleneck"`` with the default (detected) cost model:
    off the card both packages detect "unknown" and fall back to the v5e
    row, so the cuts are the JAX package's."""
    def scenario(pk):
        g = getattr(pk.models, model)()
        return [s.output_name for s in pk.partition(
            g, num_stages=stages, objective="bottleneck")][:-1]
    assert len(both(scenario)) == stages - 1


# -- hybrid replication solver -----------------------------------------------


def test_replicated_dp_matches_brute_force_property():
    rng = random.Random(11)
    checked = 0
    for t in range(10):
        spec = random_spec(rng, t + 100)
        graphs = {pk.name: build_spec(pk, spec) for pk in (J, T)}
        C = len(tanalysis.valid_cut_points(graphs["torch"]))
        batch, link = rng.choice([1, 4]), rng.choice([1e5, 1e7, 1e9])

        def scenario(pk):
            g = graphs[pk.name]
            cm = pk.plan.StageCostModel(g, batch=batch, gen="v4",
                                        link_bw_s=link)
            out = []
            for N in (2, 3, 4, 5):
                out.append({
                    "rp": pk.plan.solve_replicated(g, cm, num_nodes=N)
                    .to_json(),
                    "bf": pk.plan.brute_force_replicated(g, cm, num_nodes=N)
                    .to_json(),
                    "cuts_only": min(pk.plan.solve(g, S, cm).bottleneck_s
                                     for S in range(1, min(N, C + 1) + 1)),
                    "N": N})
            return out
        for r in both(scenario):
            rp, bf, N = r["rp"], r["bf"], r["N"]
            tol = 1e-12 + 1e-6 * bf["bottleneck_ms"]
            assert abs(rp["bottleneck_ms"] - bf["bottleneck_ms"]) <= tol
            assert rp["num_nodes"] == sum(rp["replicas"]) <= N
            assert len(rp["replicas"]) == rp["num_stages"]
            assert not any(a > 1 and b > 1 for a, b in
                           zip(rp["replicas"], rp["replicas"][1:]))
            assert rp["bottleneck_ms"] <= r["cuts_only"] * 1e3 * (1 + 1e-9) \
                + 1e-9
            checked += 1
    assert checked >= 30


def test_replication_splits_indivisible_fat_stage():
    def scenario(pk):
        g = dense_chain(pk, [16, 16, 16], in_width=16)
        costs = {n: 1e-5 for n in g.topo_order}
        costs[g.topo_order[1]] = 1e-3
        free = {"raw": pk.plan.CodecSpec("raw", 1.0, 1e14, 1e14)}
        cm = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e13,
                                    codecs=free, node_costs=costs)
        return {"cuts_only": min(pk.plan.solve(g, S, cm).bottleneck_s
                                 for S in (1, 2, 3)),
                "rp": pk.plan.solve_replicated(g, cm, num_nodes=4).to_json()}
    r = both(scenario)
    rp = r["rp"]
    assert r["cuts_only"] >= 1e-3 * (1 - 1e-9)
    assert rp["bottleneck_ms"] / 1e3 < r["cuts_only"] / 1.9
    assert max(rp["replicas"]) > 1
    assert len(rp["stage_effective_ms"]) == rp["num_stages"]


def test_replicated_comm_model_fan_parallelism():
    def scenario(pk):
        spec = pk.plan.CodecSpec("x", ratio=2.0, encode_bytes_per_s=1e6,
                                 decode_bytes_per_s=2e6)
        g = dense_chain(pk, [256, 16], in_width=16)
        cm = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e6,
                                    codecs={"x": spec}, host_sync_bw_s=0)
        return {"raw": cm.cut_bytes("fc0"),
                "parts": list(cm.comm_parts("fc0", "x")),
                "rep": list(cm.best_codec_replicated("fc0", 2, 3)),
                "one": list(cm.best_codec_replicated("fc0", 1, 1)),
                "comm": cm.comm_seconds("fc0", "x")}
    r = both(scenario)
    enc, wire, dec = r["parts"]
    assert enc == pytest.approx(r["raw"] / 1e6)
    assert dec == pytest.approx(r["raw"] / 2e6)
    assert wire == pytest.approx((r["raw"] / 2.0) / 1e6)
    assert r["rep"][1] == pytest.approx(enc / 2 + wire + dec / 3)
    assert r["one"][1] == pytest.approx(r["comm"])


def test_evaluate_cuts_replicated_and_validation():
    p = both(lambda pk: pk.plan.evaluate_cuts(
        dense_chain(pk, [16, 16, 16]), ["fc0"],
        pk.plan.StageCostModel(dense_chain(pk, [16, 16, 16]), gen="v4"),
        replicas=[1, 2]).to_json())
    assert p["replicas"] == [1, 2] and p["num_nodes"] == 3
    g = dense_chain(T, [16, 16, 16])
    cm = tplan.StageCostModel(g, gen="v4")
    with pytest.raises(ValueError, match="replica counts"):
        tplan.evaluate_cuts(g, ["fc0"], cm, replicas=[1, 2, 1])
    with pytest.raises(ValueError, match="adjacent"):
        tplan.evaluate_cuts(g, ["fc0", "fc1"], cm, replicas=[1, 2, 2])


def test_sweep_nodes_recommendation():
    def scenario(pk):
        g = dense_chain(pk, [16, 16, 16, 16])
        cm = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e9)
        sw = pk.plan.sweep_nodes(g, cm, max_nodes=4)
        sw2 = pk.plan.sweep_nodes(g, cm, max_nodes=4, latency_target_s=1e6)
        return {"bots": [p.bottleneck_s for p in sw["plans"]],
                "plans": [p.to_json() for p in sw["plans"]],
                "rec": sw["recommended"].to_json(),
                "met2": sw2["target_met"],
                "nodes2": sw2["recommended"].num_nodes}
    r = both(scenario)
    bots = r["bots"]
    assert all(b2 <= b1 * (1 + 1e-9) for b1, b2 in zip(bots, bots[1:]))
    assert r["met2"] is True and r["nodes2"] == 1


def test_replan_replicated_keeps_budget_and_moves_replicas():
    def scenario(pk):
        g = dense_chain(pk, [64] * 6, in_width=64)
        free = {"raw": pk.plan.CodecSpec("raw", 1.0, 1e15, 1e15)}
        cm = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e13,
                                    codecs=free)
        plan = pk.plan.solve_replicated(g, cm, num_nodes=4)
        order = g.topo_order
        bounds = [0] + [order.index(c) + 1 for c in plan.cuts] \
            + [len(order)]
        snap = {}
        for k in range(plan.num_stages):
            names = order[bounds[k]:bounds[k + 1]]
            snap[f"p.stage{k}.latency_s"] = {
                "count": 8,
                "p50": cm.compute_seconds(names) * (10.0 if k == 0 else 1.0)}
        return pk.plan.replan(g, plan, snap, cm).to_json()
    rp = both(scenario)
    assert rp["corrections"][0] == pytest.approx(10.0, rel=1e-4)
    assert rp["new"]["num_nodes"] <= rp["old"]["num_nodes"]
    assert rp["new"]["replicas"]
    assert rp["predicted_improvement"] >= 1.0


def test_measured_stage_seconds_averages_replicas():
    stats = [{"stage": 1, "replica": 0,
              "infer_latency_s": {"count": 4, "p50": 0.4}},
             {"stage": 1, "replica": 1,
              "infer_latency_s": {"count": 4, "p50": 0.6}},
             {"stage": 0, "infer_latency_s": {"count": 4, "p50": 0.1}}]
    got = tplan.measured_stage_seconds(stats)
    assert got == jplan.measured_stage_seconds(stats)
    assert got == {0: pytest.approx(0.1), 1: pytest.approx(0.5)}


# -- codec selection ---------------------------------------------------------


def _codec_table(pk):
    return {"raw": pk.plan.CodecSpec("raw", 1.0, 8e9, 8e9),
            "bf8": pk.plan.CodecSpec("bf8", 4.0, 2e8, 4e8, lossy=True)}


def test_per_hop_codec_selection_follows_link_bandwidth():
    def scenario(pk):
        g = dense_chain(pk, [4096, 16, 16], in_width=16)
        slow = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e6,
                                      codecs=_codec_table(pk))
        fast = pk.plan.StageCostModel(g, gen="v4", link_bw_s=4.5e10,
                                      codecs=_codec_table(pk))
        lossless = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e6,
                                          codecs=_codec_table(pk),
                                          lossless_only=True)
        return {"slow": list(slow.best_codec("fc0")),
                "fast": list(fast.best_codec("fc0")),
                "lossless": sorted(lossless.codecs),
                "describe": lossless.describe()}
    r = both(scenario)
    assert r["slow"][0] == "bf8" and r["fast"][0] == "raw"
    assert "bf8" not in r["lossless"]


def test_plan_json_shape_and_cross_load():
    """A JAX plan loads through the port's ``plan_from_json`` and back,
    replicated plans included."""
    def scenario(pk):
        g = dense_chain(pk, [16, 16, 16])
        cm = pk.plan.StageCostModel(g, gen="v4")
        return [pk.plan.solve(g, 2, cm).to_json(),
                pk.plan.solve_replicated(g, cm, num_nodes=3).to_json()]
    docs = both(scenario)
    d = docs[0]
    assert d["num_stages"] == 2 and len(d["cuts"]) == 1
    assert len(d["hop_codecs"]) == 1
    assert len(d["stage_compute_ms"]) == 2 and len(d["hop_comm_ms"]) == 1
    assert d["bound_by"] in ("compute", "comm")
    for doc in docs:
        tp, jp = tplan.plan_from_json(doc), jplan.plan_from_json(doc)
        assert type(tp).__name__ == type(jp).__name__
        assert _js(tp) == _js(jp) == _js(doc)
        assert _js(jplan.plan_from_json(tp.to_json())) == _js(doc)
        assert _js(tplan.plan_from_json({"plan": doc})) == _js(doc)


def test_sweep_stages_recommendation():
    def scenario(pk):
        g = dense_chain(pk, [16] * 6)
        cm = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e9)
        sw = pk.plan.sweep_stages(g, cm, max_stages=4)
        sw2 = pk.plan.sweep_stages(g, cm, max_stages=4,
                                   latency_target_s=1e-30)
        sw3 = pk.plan.sweep_stages(g, cm, max_stages=4,
                                   latency_target_s=1e6)
        return {"plans": [p.to_json() for p in sw["plans"]],
                "rec": sw["recommended"].to_json(),
                "met2": sw2["target_met"], "met3": sw3["target_met"],
                "rec3": sw3["recommended"].num_stages}
    r = both(scenario)
    assert [p["num_stages"] for p in r["plans"]] == [1, 2, 3, 4]
    assert r["met2"] is False and r["met3"] is True and r["rec3"] == 1


# -- quantile greedy regressions ---------------------------------------------


def test_quantile_tail_pool_guard_skewed_costs():
    def scenario(pk):
        g = dense_chain(pk, [16] * 10)
        costs = {n: 1e-6 for n in g.topo_order}
        costs[g.topo_order[-1]] = 1e3
        return {"cuts": {S: pk.analysis.auto_cut_points(g, S, costs=costs)
                         for S in (3, 4, 5, 6)},
                "order": g.topo_order,
                "stages": len(pk.partition(g, num_stages=4, costs=costs))}
    r = both(scenario)
    for S, cuts in r["cuts"].items():
        assert len(cuts) == S - 1
        idx = [r["order"].index(c) for c in cuts]
        assert idx == sorted(idx) and len(set(idx)) == len(idx)
    assert r["stages"] == 4


def test_max_activation_bytes():
    def scenario(pk):
        g = dense_chain(pk, [4096, 16], in_width=16)
        return [pk.analysis.max_activation_elems(g, ["fc0"]),
                pk.analysis.max_activation_bytes(g, ["fc0"]),
                pk.analysis.max_activation_bytes(g, ["fc0"], batch=8),
                pk.analysis.max_activation_bytes(g, ["fc1"])]
    assert both(scenario) == [4096, 4096 * 4, 4096 * 4 * 8, 16 * 4]


# -- telemetry replan --------------------------------------------------------


def test_measured_stage_seconds_both_sources():
    snap = {
        "pipeline0.stage0.latency_s": {"count": 9, "p50": 0.02,
                                       "mean": 0.05},
        "pipeline0.stage1.latency_s": {"count": 9, "p50": 0.004},
        "pipeline0.stage2.latency_s": {"count": 0},
        "pipeline0.push_latency_s": {"count": 9, "p50": 1.0},
        "transport.tx_bytes": 123,
    }
    assert tplan.measured_stage_seconds(snap) == {0: 0.02, 1: 0.004}
    assert tplan.measured_stage_seconds(snap, quantile="mean")[0] == 0.05
    stats = [{"stage": 1, "infer_latency_s": {"count": 4, "p50": 0.5}},
             {"stage": None, "infer_latency_s": {"count": 4, "p50": 9.0}},
             {"stage": 0, "infer_latency_s": {"count": 0}}]
    assert tplan.measured_stage_seconds(stats) == {1: 0.5}
    base = [{"stage": 1, "infer_latency_s": {"count": 2, "sum": 0.2}}]
    now = [{"stage": 1, "infer_latency_s": {"count": 4, "sum": 1.0,
                                            "p50": 0.3}}]
    for src, b in ((snap, None), (stats, None), (now, base),
                   ({0: 0.1, "1": 0.2}, None)):
        assert tplan.measured_stage_seconds(src, baseline=b) == \
            jplan.measured_stage_seconds(src, baseline=b)


def test_replan_moves_cut_toward_measured_hotspot():
    def scenario(pk):
        g = dense_chain(pk, [512] * 8, in_width=512)
        free = {"raw": pk.plan.CodecSpec("raw", 1.0, 1e15, 1e15)}
        cm = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e13,
                                    codecs=free, host_sync_bw_s=0)
        plan = pk.plan.solve(g, 2, cm)
        i = g.topo_order.index(plan.cuts[0]) + 1
        snap = {"pipeline0.stage0.latency_s": {
                    "count": 20,
                    "p50": cm.compute_seconds(g.topo_order[:i]) * 10},
                "pipeline0.stage1.latency_s": {
                    "count": 20,
                    "p50": cm.compute_seconds(g.topo_order[i:])}}
        rp = pk.plan.replan(g, plan, snap, cm)
        return {"order": g.topo_order, "rp": rp.to_json(),
                "corr": rp.corrections, "gain": rp.predicted_improvement}
    r = both(scenario)
    rp, order = r["rp"], r["order"]
    assert rp["old"]["cuts"] == ["fc3"]
    assert r["corr"][0] == pytest.approx(10.0, rel=1e-6)
    assert r["corr"][1] == pytest.approx(1.0, rel=1e-6)
    assert rp["moved"] is True
    assert order.index(rp["new"]["cuts"][0]) < order.index("fc3")
    assert r["gain"] > 1.0


def test_replan_noop_when_model_is_right():
    def scenario(pk):
        g = dense_chain(pk, [16] * 6)
        cm = pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e9)
        plan = pk.plan.solve(g, 3, cm)
        order = g.topo_order
        bounds = [0] + [order.index(c) + 1 for c in plan.cuts] \
            + [len(order)]
        snap = {f"p.stage{k}.latency_s": {
            "count": 5,
            "p50": cm.compute_seconds(order[bounds[k]:bounds[k + 1]])}
            for k in range(3)}
        rp = pk.plan.replan(g, plan, snap, cm)
        return {"corr": rp.corrections, "new": rp.new_plan.bottleneck_s,
                "old": plan.bottleneck_s, "moved": rp.moved}
    r = both(scenario)
    assert all(v == pytest.approx(1.0, rel=1e-6) for v in r["corr"].values())
    assert r["new"] == pytest.approx(r["old"], rel=1e-6)


def test_cost_model_from_plan_restores_calibrated_plan():
    def scenario(pk):
        g = dense_chain(pk, [64] * 5, in_width=64)
        cm = pk.plan.StageCostModel(
            g, gen="v4", batch=4, link_bw_s=3e8, local_bw_s=2e10,
            ici_bw_s=7e10, host_sync_bw_s=5e9,
            codecs={"raw": pk.plan.CodecSpec("raw", 1.0, 3e9, 4e9),
                    "odd": pk.plan.CodecSpec("odd", 1.7, 1e8, 2e8)},
            hop_tiers={"fc1": "shm"})
        plan = pk.plan.solve(g, 3, cm)
        back = pk.plan.cost_model_from_plan(
            g, pk.plan.plan_from_json(plan.to_json()))
        return {"plan": plan.to_json(), "back": back.describe(),
                "eval": pk.plan.evaluate_cuts(g, plan.cuts, back).to_json()}
    r = both(scenario)
    assert r["back"]["codecs"] == r["plan"]["cost_model"]["codecs"]
    assert r["back"]["batch"] == 4


# -- latency budget (the serving front door's width query) -------------------


def test_latency_budget_width_query():
    """``tests/test_serve.py``'s budget queries, with ``serve/batcher``'s
    re-export being the planner's function."""
    from defer_tpu_torch.serve import batcher
    assert batcher.max_batch_within_budget is tplan.max_batch_within_budget

    def scenario(pk):
        g = pk.models.resnet_tiny()
        cuts = [s.output_name for s in pk.partition(g, num_stages=3)][:-1]
        cm = pk.plan.StageCostModel(g, batch=1, gen="unknown")
        ms1 = max(pk.plan.stage_ms_at_batch(g, cuts, cm, 1))
        ms8 = max(pk.plan.stage_ms_at_batch(g, cuts, cm, 8))
        w = pk.plan.max_batch_within_budget(g, cuts, cm, ms8, cap=64)
        mcm = pk.plan.StageCostModel(
            g, batch=1, gen="unknown",
            node_costs={n: 1e-4 for n in g.topo_order})
        return {"ms1": ms1, "ms8": ms8, "w": w,
                "w_ms": max(pk.plan.stage_ms_at_batch(g, cuts, cm, w)),
                "half": pk.plan.max_batch_within_budget(g, cuts, cm,
                                                        ms1 * 0.5),
                "big": pk.plan.max_batch_within_budget(g, cuts, cm, 1e9,
                                                       cap=16),
                "m1": pk.plan.stage_ms_at_batch(g, cuts, mcm, 1),
                "m2": pk.plan.stage_ms_at_batch(g, cuts, mcm, 2)}
    r = both(scenario)
    assert r["ms8"] > r["ms1"] > 0
    assert r["half"] == 1 and 8 <= r["w"] <= 64 and r["big"] == 16
    assert r["w_ms"] <= r["ms8"] + 1e-9
    assert max(r["m2"]) == pytest.approx(2 * max(r["m1"]), rel=0.2)


# -- hop tiers (tests/test_colocate.py, test_shm.py, test_ici.py) -------------


def _fat_boundary_model(pk):
    b = pk.GraphBuilder("fatcut")
    x = b.input((4096,))
    for i in range(3):
        x = b.add(pk.ops.Dense(4096), x, name=f"d{i}")
    x = b.add(pk.ops.Dense(8), x, name="head")
    g = b.build()
    costs = {"d0": 1e-3, "d1": 1e-3, "d2": 1e-3, "head": 1e-4}
    return g, pk.plan.StageCostModel(g, gen="v4", link_bw_s=1e6,
                                     node_costs=costs)


@pytest.mark.parametrize("tier", ["local", "shm", "ici"])
def test_solver_exploits_hop_tier_map(tier):
    def scenario(pk):
        g, cm = _fat_boundary_model(pk)
        tiers = {c: tier for c in ("d0", "d1", "d2")}
        p_t = pk.plan.solve(g, 3, cm, hop_tiers=tiers)
        rp = pk.plan.replan(g, p_t, {0: 2e-3, 1: 1e-3, 2: 1e-3},
                            cm.with_hop_tiers(tiers))
        return {"tcp": pk.plan.solve(g, 3, cm).to_json(),
                "tier": p_t.to_json(),
                "back": pk.plan.plan_from_json(p_t.to_json()).hop_tiers,
                "ici_bw": cm.ici_bw_s, "hs_bw": cm.host_sync_bw_s,
                "replan": rp.to_json()}
    r = both(scenario)
    assert r["tier"]["bottleneck_ms"] < r["tcp"]["bottleneck_ms"]
    assert set(r["tier"]["hop_codecs"]) == {tier}
    assert r["tier"]["hop_tiers"] == [tier] * 2 == r["back"]
    assert r["tcp"]["hop_tiers"] == ["tcp"] * 2
    assert r["tier"]["cost_model"]["ici_bw_s"] == r["ici_bw"]
    assert r["tier"]["cost_model"]["host_sync_bw_s"] == r["hs_bw"]
    assert set(r["replan"]["new"]["hop_tiers"]) == {tier}
    assert set(r["replan"]["old_corrected"]["hop_tiers"]) == {tier}


def test_tier_ordering_is_principled():
    def scenario(pk):
        g, cm = _fat_boundary_model(pk)
        cost = {t: cm.with_hop_tiers({"d1": t}).comm_seconds("d1", t)
                for t in ("device", "ici", "local", "shm")}
        cost["tcp"] = cm.best_codec("d1")[1]
        return {"cost": cost, "bytes": cm.cut_bytes("d1"),
                "ici_bw": cm.ici_bw_s, "local_bw": cm.local_bw_s,
                "hs": cm.host_sync_seconds("d1"),
                "best_local": list(cm.with_hop_tiers({"d1": "local"})
                                   .best_codec("d1")),
                "best": cm.best_codec("d1")[0]}
    r = both(scenario)
    c = r["cost"]
    assert c["device"] == 0.0
    assert c["device"] < c["ici"] < c["local"] < c["shm"] < c["tcp"]
    assert c["ici"] == pytest.approx(r["bytes"] / r["ici_bw"])
    assert r["hs"] > 0
    assert c["local"] == pytest.approx(r["bytes"] / r["local_bw"] + r["hs"])
    assert c["shm"] - c["local"] == pytest.approx(r["bytes"] / r["local_bw"])
    assert r["best_local"] == ["local", c["local"]]
    assert r["best"] != "local"


@pytest.mark.parametrize("tier", ["local", "shm", "ici"])
def test_tier_never_applies_to_fan_hops(tier):
    def scenario(pk):
        g, cm = _fat_boundary_model(pk)
        cm = cm.with_hop_tiers({"d1": tier})
        return [list(cm.best_codec_replicated("d1", 1, 1)),
                list(cm.best_codec_replicated("d1", 2, 1))]
    (name, s), (name2, s2) = both(scenario)
    assert name == tier and name2 != tier and s2 > s


def test_hop_tiers_reject_bad_names_and_cuts():
    g, cm = _fat_boundary_model(T)
    with pytest.raises(ValueError, match="unknown hop tiers"):
        cm.with_hop_tiers({"d1": "rdma"})
    with pytest.raises(ValueError, match="not valid cut points"):
        cm.with_hop_tiers({"nope": "shm"})


# -- the CLI's machine-readable surface --------------------------------------


def _cli_json(capsys, argv):
    """The last JSON line each package's CLI prints for ``argv``."""
    from defer_tpu.cli import main as jmain
    from defer_tpu_torch.cli import main as tmain
    out = {}
    for name, main in (("jax", jmain), ("torch", tmain)):
        main(list(argv))
        out[name] = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
    assert _js(out["torch"]) == _js(out["jax"])
    return out["torch"]


def test_cli_plan_nodes_json(capsys):
    d = _cli_json(capsys, ["plan", "--model", "resnet_tiny", "--nodes", "4",
                           "--link-bw", "1e8", "--json"])
    p = d["plan"]
    assert sum(p["replicas"]) == p["num_nodes"] <= 4
    assert d["predicted_speedup_vs_cuts_only"] >= 1.0
    assert d["cuts_only"]["bottleneck_ms"] >= p["bottleneck_ms"]


def test_cli_partition_json(capsys):
    d = _cli_json(capsys, ["partition", "--model", "resnet_tiny",
                           "--stages", "3", "--json"])
    assert d["model"] == "resnet_tiny" and d["num_stages"] == 3
    assert len(d["cuts"]) == 2 and len(d["stages"]) == 3
    assert d["max_activation_bytes"] > 0
    assert "buffer" in d and "plan" not in d
    for s in d["stages"]:
        assert {"index", "nodes", "in_shape", "out_shape",
                "boundary_bytes"} <= set(s)


def test_cli_partition_json_bottleneck(capsys):
    d = _cli_json(capsys, ["partition", "--model", "resnet_tiny",
                           "--stages", "3", "--balance", "bottleneck",
                           "--link-bw", "1e8", "--json"])
    assert d["cuts"] == d["plan"]["cuts"]
    assert len(d["plan"]["hop_codecs"]) == 2
    assert d["plan"]["bottleneck_ms"] > 0


def test_cli_plan_json(capsys, tmp_path):
    d = _cli_json(capsys, ["plan", "--model", "resnet_tiny", "--stages",
                           "3", "--link-bw", "1e8", "--json"])
    assert d["plan"]["num_stages"] == 3
    assert d["quantile"]["objective"] == "quantile"
    assert d["predicted_speedup_vs_quantile"] >= 1.0
    snap = {"registry": {
        "pipeline0.stage0.latency_s": {"count": 10, "p50": 0.5},
        "pipeline0.stage1.latency_s": {"count": 10, "p50": 0.001},
        "pipeline0.stage2.latency_s": {"count": 10, "p50": 0.001},
    }}
    f = tmp_path / "metrics.json"
    f.write_text(json.dumps(snap))
    d = _cli_json(capsys, ["plan", "--model", "resnet_tiny", "--stages",
                           "3", "--link-bw", "1e8", "--replan", str(f),
                           "--json"])
    assert d["replan"]["corrections"]["0"] > 1.0
    assert d["replan"]["new"]["num_stages"] == 3


def test_cli_plan_sweep_json(capsys):
    d = _cli_json(capsys, ["plan", "--model", "resnet_tiny", "--sweep", "3",
                           "--json"])
    assert [p["num_stages"] for p in d["sweep"]] == [1, 2, 3]
    assert d["recommended"]["num_stages"] in (1, 2, 3)


def test_cli_plan_tiers_and_codecs_json(capsys):
    """``--hop-tier-map``, ``--codecs``, ``--ici-bw`` and ``--batch``
    reach the cost model as the JAX CLI's do."""
    d = _cli_json(capsys, ["plan", "--model", "resnet_tiny", "--stages",
                           "3", "--batch", "4", "--codecs", "raw,lzb",
                           "--ici-bw", "2e10", "--link-bw", "1e8",
                           "--hop-tier-map", "add=ici,add_1=shm", "--json"])
    assert d["cost_model"]["hop_tiers"] == {"add": "ici", "add_1": "shm"}
    assert sorted(d["cost_model"]["codecs"]) == ["lzb", "raw"]


def test_cli_partition_linear_shortage_names_merges():
    from defer_tpu_torch.cli import main
    with pytest.raises(SystemExit, match="merge"):
        main(["partition", "--model", "inception_tiny", "--stages", "40"])


def test_cli_partition_measured_on_the_cpu(capsys):
    """``--balance measured`` times every node (here on the CPU, the
    card's default being asked off) and snaps quantiles of the measured
    costs to valid cuts."""
    from defer_tpu_torch.cli import main
    main(["partition", "--model", "resnet_tiny", "--stages", "3",
          "--balance", "measured", "--device", "cpu", "--json"])
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["num_stages"] == 3
    valid = set(d["valid_cut_points"])
    assert set(d["cuts"]) <= valid


def test_top_level_exports_plan():
    assert dt.plan is tplan
    assert "plan" in dt.__all__
    assert tplan.__all__ == jplan.__all__
