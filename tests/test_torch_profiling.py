"""The port's ``utils/profiling.py`` on the CPU, and the small pieces the
CLI stands on, held to the JAX package.

``measured_node_costs`` times every node (floating, integer and
multi-input nodes, float32 and bfloat16), and its costs drive the planner
and the quantile cuts.  ``amortized_forward_seconds`` runs ``k``
perturbed forwards per call, ``pipeline_window_seconds`` clears the
deployment's counters before its window, ``trace`` writes a Chrome trace,
and ``profile_pipeline`` returns the JAX package's keys with its
``num_stages`` and ``buffer_bytes_per_hop``.  ``flush_artifact`` writes
the JAX package's files byte for byte; ``PipelineMetrics.clear_counters``,
``LatencyHistogram.percentiles``, ``LayerGraph.predecessors`` and the
wire dtype strings equal JAX's.  The card's cases (flash launches counted
under graph replay) are in ``tests/test_torch_cuda.py``."""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from defer_tpu_torch import models
from defer_tpu_torch.graph.analysis import auto_cut_points
from defer_tpu_torch.plan import StageCostModel, solve
from defer_tpu_torch.utils.profiling import (amortized_forward_seconds,
                                             measured_node_costs,
                                             pipeline_window_seconds,
                                             profile_pipeline, timed_window,
                                             trace)

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


# ---------------------------------------------------------------------------
# amortized forwards, pipeline windows, traces, profile_pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_amortized_forward_seconds_runs_k_live_forwards(dtype):
    """Each timed call runs ``k`` forwards on ``x0 + t``: floats perturbed
    by ``linspace(0, 1e-6, k)``, integers by +0/+1 alternately."""
    seen = []

    def apply_fn(p, x):
        seen.append(x.clone())
        return x.to(torch.float32) * p

    x0 = torch.full((3,), 5, dtype=dtype)
    k = 4
    sec = amortized_forward_seconds(apply_fn, 2.0, x0, k, min_iters=2,
                                    min_s=0.0, max_iters=2)
    assert math.isfinite(sec) and sec >= 0
    assert len(seen) == 3 * k            # one warm call, two timed
    steps = torch.stack([x[0] for x in seen[:k]])
    if dtype.is_floating_point:
        want = x0[0] + torch.linspace(0, 1e-6, k)
        assert torch.equal(steps, want)
    else:
        assert steps.tolist() == [5, 6, 5, 6]


def test_amortized_forward_seconds_of_a_graph():
    g = models.bert_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    ids = torch.zeros((2,) + tuple(g.input_spec.shape), dtype=torch.int32)
    sec = amortized_forward_seconds(g.apply, params, ids, 2, min_iters=1,
                                    min_s=0.0, max_iters=1)
    assert math.isfinite(sec) and sec > 0


def _tiny_pipe(stages=2, chunk=2):
    from defer_tpu_torch import SpmdPipeline, partition
    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    pipe = SpmdPipeline(partition(g, num_stages=stages), params,
                        device="cpu", chunk=chunk)
    return pipe, params


def test_pipeline_window_seconds_bills_only_the_window():
    pipe, _ = _tiny_pipe()
    xs = pipe.stage_inputs(np.zeros((2, 1, 32, 32, 3), np.float32))
    sec = pipeline_window_seconds(pipe, xs, inflight=1, min_s=0.0,
                                  max_chunks=3)
    assert math.isfinite(sec) and sec > 0
    m = pipe.metrics
    # the window alone: max(2, min(3, ceil(0 / t1))) = 2 chunks
    assert (m.chunk_calls, m.steps) == (2, 4)
    assert m.push_latency.count == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(8).add_(1)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    assert any("add" in e.get("name", "") for e in events)


def test_profile_pipeline_keys_equal_to_jax():
    """The JAX package's scenario (tests/test_utils.py), at 3 stages:
    resnet_tiny, chunk 2; the same keys, stage count and hop bytes."""
    import defer_tpu as jdt
    from defer_tpu.models import resnet_tiny as jax_resnet_tiny

    jg = jax_resnet_tiny()
    jp = jg.init(jax.random.key(0))
    jpipe = jdt.SpmdPipeline(jdt.partition(jg, num_stages=3), jp,
                             mesh=jdt.pipeline_mesh(3), chunk=2)
    want = jdt.profile_pipeline(jpipe, jp, iters=2, warmup=1)
    pipe, params = _tiny_pipe(stages=3)
    got = profile_pipeline(pipe, params, iters=2, warmup=1)
    assert list(got) == list(want)
    assert got["num_stages"] == want["num_stages"] == 3
    assert got["buffer_bytes_per_hop"] == want["buffer_bytes_per_hop"]
    assert len(got["stage_latency_ms"]) == 3
    assert got["stage_imbalance"] >= 1.0
    assert got["pipeline_step_ms"] > 0
    assert got["steady_state_throughput_per_s"] > 0


def test_profile_pipeline_never_syncs_on_the_cpu(monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("synchronize on the CPU path")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    pipe, params = _tiny_pipe()
    assert profile_pipeline(pipe, params, iters=1, warmup=1)[
        "num_stages"] == 2


def test_top_level_exports():
    import defer_tpu as jdt
    import defer_tpu_torch as tdt
    for name in ("profile_pipeline", "trace"):
        assert name in jdt.__all__ and name in tdt.__all__
        assert getattr(tdt, name) is globals()[name]


# ---------------------------------------------------------------------------
# the small pieces, equal to JAX's
# ---------------------------------------------------------------------------

def test_clear_counters_equal_to_jax():
    from defer_tpu.utils.metrics import PipelineMetrics as JaxMetrics
    from defer_tpu_torch.utils.metrics import PipelineMetrics

    out = []
    for cls in (JaxMetrics, PipelineMetrics):
        m = cls(num_stages=4, microbatch=2, buffer_elems=64,
                buffer_bytes_per_hop=256)
        m.inferences, m.steps, m.wall_s, m.chunk_calls = 10, 20, 1.5, 3
        for v in (0.001, 0.002, 0.004):
            m.push_latency.record(v)
            m.record_stage_latency(1, v)
        m.clear_counters()
        assert (m.inferences, m.steps, m.wall_s, m.chunk_calls) == \
            (0, 0, 0.0, 0)
        assert m.push_latency.count == 0
        out.append(m.as_dict())
    assert out[0] == out[1]
    assert out[1]["stage_latency_ms"][1] > 0


@pytest.mark.parametrize("samples", [[], [0.25] * 100,
                                     [i / 1000 for i in range(1, 10001)],
                                     [1e-6, 3.0, 0.02, 0.02, 7e-4]])
def test_percentiles_equal_to_jax(samples):
    from defer_tpu.obs import LatencyHistogram as JaxHistogram
    from defer_tpu_torch.obs import LatencyHistogram

    hs = [JaxHistogram(), LatencyHistogram()]
    for h in hs:
        for v in samples:
            h.record(v)
    assert hs[1].percentiles == hs[0].percentiles
    assert repr(hs[1]) == repr(hs[0])
    assert set(hs[1].percentiles) == {"p50", "p95", "p99", "max"}


@pytest.mark.parametrize("model", ["resnet_tiny", "inception_tiny",
                                   "bert_tiny", "moe_branched_tiny"])
def test_predecessors_equal_to_jax(model):
    import defer_tpu.models as jax_models
    jg, g = getattr(jax_models, model)(), getattr(models, model)()
    assert g.topo_order == jg.topo_order
    for name in g.topo_order:
        assert g.predecessors(name) == jg.predecessors(name)
    joins = [n for n in g.topo_order if len(g.predecessors(n)) > 1]
    assert joins or model == "bert_tiny"


@pytest.mark.parametrize("dtype", ["<f4", "<i4", "|i1", "<f2", "<i8", "|u1",
                                   "bfloat16"])
def test_dtype_from_wire(dtype):
    from defer_tpu.transport.framed import dtype_from_wire as jax_dtype
    from defer_tpu_torch.transport.framed import dtype_from_wire, wire_dtype
    got = dtype_from_wire(dtype)
    if dtype == "bfloat16":
        assert got is torch.bfloat16
        assert str(jax_dtype(dtype)) == "bfloat16"
    else:
        assert got == jax_dtype(dtype) == np.dtype(dtype)
        assert wire_dtype(got) == dtype


def _artifact_steps(flush_artifact, d, stderr):
    """The JAX package's flush scenario (tests/test_utils.py), step by step:
    each step's returned payload and the file's bytes."""
    p = os.path.join(d, "a.json")
    out = []
    out.append(flush_artifact(p, {"metric": "m", "value": 5.0,
                                  "rows": {"a": {"tokens_per_s": 5.0},
                                           "b": {"tokens_per_s": 3.0}}},
                              merge_key="rows"))
    out.append(open(p, "rb").read())
    out.append(flush_artifact(p, {"metric": "m", "value": 2.0,
                                  "rows": {"c": {"tokens_per_s": 2.0}}},
                              merge_key="rows", merge_prior=True))
    out.append(open(p, "rb").read())
    out.append(flush_artifact(p, {"metric": "m", "value": 0.0,
                                  "rows": {"a": {"tokens_per_s": 4.0}}},
                              merge_key="rows"))
    out.append(open(p, "rb").read())
    out.append(flush_artifact(None, {"value": 0.0,
                                     "rows": {"base": {"tokens_per_s": 9.0},
                                              "spec_x": {"tokens_per_s": 2.0}}},
                              merge_key="rows",
                              row_filter=lambda k: k.startswith("spec_")))
    e = os.path.join(d, "empty.json")
    open(e, "w").close()
    out.append(flush_artifact(e, {"value": 0.0,
                                  "rows": {"a": {"tokens_per_s": 1.0}}},
                              merge_key="rows", merge_prior=True))
    out.append(open(e, "rb").read())
    bad = os.path.join(d, "a_dir")
    os.mkdir(bad)
    out.append(flush_artifact(bad, {"value": 1.0}))
    out.append(stderr().replace(d, "<d>"))
    out.append(flush_artifact(None, {"x": 1}))
    out.append(sorted(f for f in os.listdir(d) if f.endswith(".part")))
    return out


def test_flush_artifact_byte_equal_to_jax(tmp_path, capsys):
    from defer_tpu.utils.artifact import flush_artifact as jax_flush
    from defer_tpu_torch.utils.artifact import flush_artifact

    runs = []
    for name, fn in (("jax", jax_flush), ("port", flush_artifact)):
        d = tmp_path / name
        d.mkdir()
        runs.append(_artifact_steps(fn, str(d),
                                    lambda: capsys.readouterr().err))
    assert runs[0] == runs[1]
    steps = runs[1]
    assert json.loads(steps[3])["value"] == 5.0
    assert set(json.loads(steps[3])["rows"]) == {"a", "b", "c"}
    assert steps[6]["value"] == 2.0
    assert "flush_artifact: could not write <d>/a_dir" in steps[10]
    assert steps[-1] == ["a_dir.part"]
