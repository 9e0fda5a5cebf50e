"""The port's ``utils/profiling.py`` on the CPU: ``measured_node_costs``
times every node (floating, integer and multi-input nodes, float32 and
bfloat16), and its costs drive the planner and the quantile cuts.  The
card's case (flash launches counted under graph replay) is in
``tests/test_torch_cuda.py``."""

import math

import pytest
import torch

from defer_tpu_torch import models
from defer_tpu_torch.graph.analysis import auto_cut_points
from defer_tpu_torch.plan import StageCostModel, solve
from defer_tpu_torch.utils.profiling import measured_node_costs, timed_window

torch.set_num_threads(1)


@pytest.mark.parametrize("model,dtype", [
    ("resnet_tiny", None), ("bert_tiny", None), ("bert_tiny", "bfloat16"),
    ("inception_tiny", torch.bfloat16)])
def test_measured_node_costs_every_node_positive(model, dtype):
    g = getattr(models, model)()
    params = g.init(torch.Generator().manual_seed(0))
    costs = measured_node_costs(g, params, batch=2, compute_dtype=dtype,
                                k=2, reps=1, device="cpu")
    assert list(costs) == g.topo_order
    assert all(math.isfinite(v) and v > 0 for v in costs.values())


def test_measured_costs_feed_the_planner():
    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    costs = measured_node_costs(g, params, batch=1, k=2, reps=1,
                                device="cpu")
    cm = StageCostModel(g, gen="unknown", node_costs=costs)
    assert cm.describe()["node_costs"] == "measured"
    plan = solve(g, 3, cm)
    assert len(plan.cuts) == 2
    assert len(auto_cut_points(g, 3, costs=costs)) == 2
    assert plan.stage_compute_s == pytest.approx(
        [sum(costs[n] for n in s) for s in (
            g.topo_order[:g.topo_order.index(plan.cuts[0]) + 1],
            g.topo_order[g.topo_order.index(plan.cuts[0]) + 1:
                         g.topo_order.index(plan.cuts[1]) + 1],
            g.topo_order[g.topo_order.index(plan.cuts[1]) + 1:])])


def test_measured_node_costs_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    g = models.resnet_tiny()
    with pytest.raises(RuntimeError):
        measured_node_costs(g, g.init(torch.Generator().manual_seed(0)))


def test_timed_window_counts_calls():
    calls = []
    sec = timed_window(lambda: calls.append(1), min_iters=3, min_s=0.0)
    assert len(calls) == 4 and sec >= 0.0
    calls.clear()
    timed_window(lambda: calls.append(1), min_iters=1, min_s=10.0,
                 max_iters=5)
    assert len(calls) == 6
