"""The port's chain smokes on the CPU: ``scripts/torch_replication_smoke.py``,
``scripts/torch_colocate_smoke.py``, ``scripts/torch_shm_smoke.py`` and
``scripts/torch_chain_overlap_smoke.py``, each run ``--quick --device cpu``
as a subprocess.  Each must exit 0 and print its JAX script's row (metric
and keys); the rows' planner fields are held to the JAX package's solver
on the same graphs and cost models, their tier maps and frame counts to
what the JAX scripts assert, and the ``slow`` pair test runs each JAX
script beside its port and compares every clock-free field."""

import pytest

from defer_tpu import GraphBuilder
from defer_tpu.graph import ops
from defer_tpu.plan import StageCostModel, solve, solve_replicated

import torch_smoke_harness as H


def _fatcut_plans(tier):
    """The colocate and shm smokes' planner check in the JAX package."""
    b = GraphBuilder("fatcut")
    x = b.input((4096,))
    for i in range(3):
        x = b.add(ops.Dense(4096), x, name=f"d{i}")
    b.add(ops.Dense(8), x, name="head")
    g = b.build()
    costs = {"d0": 1e-3, "d1": 1e-3, "d2": 1e-3, "head": 1e-4}
    cm = StageCostModel(g, gen="v4", link_bw_s=1e6, node_costs=costs)
    return solve(g, 3, cm), solve(
        g, 3, cm, hop_tiers={c: tier for c in ("d0", "d1", "d2")})


def _jax_fatstage_solver_row() -> dict:
    """The replication smoke's ``solver`` row from the JAX solver on the
    smoke's fat-stage graph and costs."""
    b = GraphBuilder("fatstage")
    x = b.input((16,))
    for n in ("pre", "fat", "post"):
        x = b.add(ops.Dense(16), x, name=n)
    g = b.build()
    cm = StageCostModel(g, gen="v4", link_bw_s=1e9,
                        node_costs={"pre": 1e-4, "fat": 1e-3, "post": 1e-4})
    rp = solve_replicated(g, cm, num_nodes=4)
    cuts_only = min((solve(g, s, cm) for s in range(1, 4)),
                    key=lambda p: p.bottleneck_s)
    k = rp.bottleneck_stage if max(rp.replicas) == 1 else \
        rp.replicas.index(max(rp.replicas))
    return {
        "cuts_only_bottleneck_ms": round(cuts_only.bottleneck_s * 1e3, 4),
        "hybrid_bottleneck_ms": round(rp.bottleneck_s * 1e3, 4),
        "predicted_speedup": round(cuts_only.bottleneck_s
                                   / rp.bottleneck_s, 4),
        "replicas": rp.replicas, "cuts": rp.cuts, "replicated_stage": k}


# slow: the script's quick in-process replication speedup bar (1.2x), kept
# as its JAX script has it, failed under the load of a -n 6 tier-1 run
# (1.028x and 0.906x with four copies beside the planner, chaos, obs and
# serving files); test_replication_solver_equals_the_jax_package keeps
# the row's solver fields in tier-1
@pytest.mark.slow
@pytest.mark.timeout(240)
def test_replication_smoke_quick_cpu():
    row, _ = H.run("replication", timeout=200)
    H.check_row("replication", row)
    # the JAX solver on the smoke's fat-stage graph and costs
    assert row["solver"] == _jax_fatstage_solver_row()
    # 16 frames and 2 warm ones, dealt round-robin over two replicas
    assert row["quick"]["replica_split"] == {"0": 9, "1": 9}
    assert row["quick"]["speedup"] >= 1.2
    assert row["value"] is None and row["replicas"] == {"stage1": 2}


def test_replication_solver_equals_the_jax_package():
    """The replication smoke's solver part (its ``solver_check``, run in
    this process) prints the row that the JAX solver gives on the same
    graph and costs."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_replication_smoke", H.SCRIPTS / "torch_replication_smoke.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.solver_check() == _jax_fatstage_solver_row()


@pytest.mark.timeout(240)
def test_colocate_smoke_quick_cpu():
    row, _ = H.run("colocate", timeout=200)
    H.check_row("colocate", row)
    p_tcp, p_colo = _fatcut_plans("local")
    assert row["planner"] == {
        "tcp_bottleneck_ms": round(p_tcp.bottleneck_s * 1e3, 4),
        "colocated_bottleneck_ms": round(p_colo.bottleneck_s * 1e3, 4),
        "predicted_speedup": round(p_tcp.bottleneck_s
                                   / p_colo.bottleneck_s, 4),
        "hop_tiers": p_colo.hop_tiers}
    assert row["quick"]["tiers"] == ["local"] * 3
    assert row["quick"]["speedup"] >= 1.5
    # device-tier fusion: one program, two local hops a frame (12 frames
    # and 2 warm ones), no tensor frame on the wire
    assert row["fused"]["stages"] == 1
    assert row["fused"]["local_frames"] == 2 * (12 + 2)
    assert row["fused"]["wire_frames"] <= 2


@pytest.mark.timeout(240)
def test_shm_smoke_quick_cpu():
    row, _ = H.run("shm", timeout=200)
    H.check_row("shm", row)
    p_tcp, p_shm = _fatcut_plans("shm")
    assert row["planner"] == {
        "tcp_bottleneck_ms": round(p_tcp.bottleneck_s * 1e3, 4),
        "shm_bottleneck_ms": round(p_shm.bottleneck_s * 1e3, 4),
        "predicted_speedup": round(p_tcp.bottleneck_s
                                   / p_shm.bottleneck_s, 4),
        "hop_tiers": p_shm.hop_tiers}
    assert row["quick"]["tiers"] == ["shm"] * 3
    assert row["quick"]["speedup"] >= 1.5
    assert row["fallback"]["degraded_hop_fallbacks"] >= 1
    assert row["fallback"]["granted_hop_fallbacks"] == 0


@pytest.mark.timeout(240)
def test_chain_overlap_smoke_quick_cpu():
    row, _ = H.run("chain_overlap", timeout=200)
    H.check_row("chain_overlap", row)
    assert (row["stages"], row["codec"], row["batch"], row["count"]) == (
        4, "bf8", 16, 48)
    assert row["value"] is None and row["overlap_wall_vs_phase_sum"] < 0.8


@pytest.mark.slow
@pytest.mark.timeout(900)
@pytest.mark.parametrize("name", ["replication", "colocate", "shm",
                                  "chain_overlap"])
def test_pair_with_the_jax_script(name):
    jrow, _ = H.run(name, jax=True, timeout=400)
    prow, _ = H.run(name, timeout=400)
    H.check_row(name, jrow)
    H.check_row(name, prow)
    assert H.clock_free(name, prow) == H.clock_free(name, jrow)
