"""The port's chaos smoke on the CPU: ``scripts/torch_chaos_smoke.py
--quick --device cpu`` as a subprocess.  It must exit 0 and print its JAX
script's row: one failover after the ``SIGKILL`` of a replica with the
stream byte-identical to an undisturbed one, and a live replan whose cuts
are the JAX planner's on the same graph and default cost model, with every
stage quiesced at the first segment.  The ``slow`` pair test runs the JAX
script beside the port and compares every clock-free field."""

import pytest

import defer_tpu.models as jm
from defer_tpu.graph.analysis import valid_cut_points
from defer_tpu.plan import StageCostModel, solve

import torch_smoke_harness as H


@pytest.mark.timeout(240)
def test_chaos_smoke_quick_cpu():
    row, _ = H.run("chaos", timeout=200)
    H.check_row("chaos", row)
    assert row["byte_identical"] is True and row["count"] == 16
    # a heal per failover event; a loaded host may heal a second time
    assert row["failovers"] >= 1 and row["replayed"] >= 1
    assert row["recovery_ms"] == row["value"] > 0
    # the replan leg: the JAX planner's cuts on resnet_tiny, then the
    # first other valid pair, 8 frames cut over at the half
    g = jm.resnet_tiny()
    plan1 = solve(g, 3, StageCostModel(g))
    valid = [c for c in g.topo_order if c in set(valid_cut_points(g))]
    cuts2 = next([a, b] for i, a in enumerate(valid) for b in valid[i + 1:]
                 if [a, b] != list(plan1.cuts))
    assert row["old_cuts"] == list(plan1.cuts)
    assert row["new_cuts"] == cuts2
    assert row["replan_byte_identical"] is True
    assert row["quiesced"] == [8 // 2] * 3


@pytest.mark.slow
@pytest.mark.timeout(900)
def test_pair_with_the_jax_script():
    jrow, _ = H.run("chaos", jax=True, timeout=400)
    prow, _ = H.run("chaos", timeout=400)
    H.check_row("chaos", jrow)
    H.check_row("chaos", prow)
    assert H.clock_free("chaos", prow) == H.clock_free("chaos", jrow)
