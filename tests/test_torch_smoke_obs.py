"""The port's observability smokes on the CPU: ``scripts/torch_monitor_smoke.py``,
``scripts/torch_profile_smoke.py``, ``scripts/torch_postmortem_smoke.py``
(each ``--quick --device cpu``) and ``scripts/torch_metrics_smoke.py``
(its one mode), each run as a subprocess.  Each must exit 0 and print its
JAX script's row (metric and keys) with the verdicts the JAX script
asserts: the delay-bound stage as the bottleneck and the straggler, one
recompile event per episode, ``stage1.r0`` as the first fault.  The
``slow`` pair test runs each JAX script beside its port and compares
every clock-free field."""

import pytest

import torch_smoke_harness as H


# slow: the script's straggler verdict (stage 1 flagged before any other), kept as its JAX
# script has it, failed under the load of a -n 6 tier-1 run
@pytest.mark.slow
@pytest.mark.timeout(240)
def test_monitor_smoke_quick_cpu():
    row, _ = H.run("monitor", timeout=200)
    H.check_row("monitor", row)
    assert row["bottleneck"] == 1 and row["replan_argmax_stage"] == 1
    st = row["straggler"]
    assert (st["stage"], st["reason"], st["intervals"]) == (1, "slow", 2)
    assert st["ratio"] > 1.5
    assert row["monitor_frames"] == 40
    assert row["sampled_waterfalls"] >= 48 // 4
    assert row["min_waterfall_gap_us"] >= -200
    assert row["value"] < 0.05


# slow: the script's 5% profiling-overhead bound, kept as its JAX
# script has it, failed under the load of a -n 6 tier-1 run
@pytest.mark.slow
@pytest.mark.timeout(240)
def test_profile_smoke_quick_cpu():
    row, _ = H.run("profile", timeout=200)
    H.check_row("profile", row)
    assert set(row["phase_sums"]) == {"stage0", "stage1", "stage2"}
    for s in row["phase_sums"].values():
        assert s["rel_err"] <= 0.10 and s["frames"] > 0, s
    # a new batch re-exports and reloads all three stage programs: one
    # episode, one event
    assert row["recompiles_injected"] >= 3
    assert row["recompile_events"] == 1
    assert row["value"] < 0.05


# slow: the script's 5% journaling-overhead bound, kept as its JAX
# script has it, failed under the load of a -n 6 tier-1 run
@pytest.mark.slow
@pytest.mark.timeout(240)
def test_postmortem_smoke_quick_cpu():
    row, _ = H.run("postmortem", timeout=200)
    H.check_row("postmortem", row)
    assert row["byte_identical"] is True and row["count"] == 12
    assert row["first_fault"] == "stage1.r0"
    assert row["casualties"][0] == "stage2"
    assert row["journals"] >= 5 and row["auto_bundle"] is True
    assert row["respawn_gap_s"] >= 0 and row["spilled_records"] > 0
    assert row["value"] < 0.05


@pytest.mark.timeout(240)
def test_metrics_smoke_cpu():
    row, _ = H.run("metrics", timeout=200)
    H.check_row("metrics", row)
    assert row["value"] == 1 and row["spans"] > 0
    assert row["push_p99_ms"] > 0


@pytest.mark.slow
@pytest.mark.timeout(900)
@pytest.mark.parametrize("name", ["monitor", "profile", "postmortem",
                                  "metrics"])
def test_pair_with_the_jax_script(name):
    jrow, _ = H.run(name, jax=True, timeout=400)
    prow, _ = H.run(name, timeout=400)
    H.check_row(name, jrow)
    H.check_row(name, prow)
    assert H.clock_free(name, prow) == H.clock_free(name, jrow)
