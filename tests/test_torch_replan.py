"""Port parity: telemetry replanning and the live cutover (``plan/replan.py``).

The quiesce and live-cutover scenarios of ``tests/test_replay.py`` on the
port's persistent ``StageNode`` chain (``resnet_tiny``, the CPU): a
bursty first segment, a replan suggestion from measured per-stage
seconds, ``ReplanResult.apply(LiveReplan(...))`` cutting the chain over
mid-stream, and the whole output stream byte-identical to two
undisturbed chains (old cuts, then new cuts).  The suggestion itself is
the JAX package's: the same plan and measurements give the same new
cuts, corrections and JSON in both packages.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import defer_tpu.models as jmodels
import defer_tpu.plan as jplan
from defer_tpu_torch import models, partition
from defer_tpu_torch.obs.events import recorder
from defer_tpu_torch.plan import StageCostModel, replan, solve
from defer_tpu_torch.plan import measured_stage_seconds
from defer_tpu_torch.plan.replan import LiveReplan
from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode
from defer_tpu_torch.serve import poisson_trace

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    g = models.resnet_tiny()
    return g, g.init(torch.Generator().manual_seed(0))


def _boot(n: int, **kw):
    nodes = [StageNode(None, "127.0.0.1:0", None, device="cpu", **kw)
             for _ in range(n)]
    addrs = [f"127.0.0.1:{node.address[1]}" for node in nodes]
    threads = [threading.Thread(target=node.serve, daemon=True)
               for node in nodes]
    for t in threads:
        t.start()
    return addrs, threads


def _js(x) -> str:
    return json.dumps(x, sort_keys=True)


@pytest.mark.timeout(120)
def test_quiesce_returns_stable_sequence_points(tiny):
    g, params = tiny
    addrs, threads = _boot(2, persist=True)
    disp = ChainDispatcher(addrs[0], codec="raw")
    try:
        disp.deploy(partition(g, num_stages=2), params, addrs, batch=1)
        rng = np.random.default_rng(3)
        xs = [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
              for _ in range(3)]
        assert len(disp.stream(xs)) == 3
        processed = disp.quiesce(addrs, timeout_s=30.0)
        assert processed == [3, 3]
        evs = [e for e in recorder().snapshot() if e["kind"] == "quiesce"]
        assert len(evs) >= 2
        # the nodes' own telemetry feeds the replanner
        got = measured_stage_seconds(disp.stats(addrs))
        assert sorted(got) == [0, 1] and all(v > 0 for v in got.values())
    finally:
        disp.end_stream()
        disp.shutdown_nodes(addrs)
        disp.close()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def _plain(g, params, cuts, inputs):
    """An undisturbed one-shot chain of the same three nodes' shape."""
    addrs, ths = _boot(3)
    d = ChainDispatcher(addrs[0], codec="raw")
    d.deploy(partition(g, list(cuts)), params, addrs, batch=1)
    got = d.stream(inputs)
    d.close()
    for t in ths:
        t.join(timeout=30)
    return got


@pytest.mark.timeout(180)
def test_live_replan_cutover_byte_identical_under_bursty_arrivals(tiny):
    g, params = tiny
    cost = StageCostModel(g, gen="unknown")
    plan1 = solve(g, 3, cost)
    jg = jmodels.resnet_tiny()
    jcost = jplan.StageCostModel(jg, gen="unknown")
    assert _js(plan1.to_json()) == _js(jplan.solve(jg, 3, jcost).to_json())
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
          for _ in range(10)]
    cut = 6
    offsets = poisson_trace(200.0, 1.0, seed=5,
                            bursts=[(0.2, 0.5, 3.0)])[:cut]
    while len(offsets) < cut:
        offsets.append(offsets[-1] if offsets else 0.0)

    addrs, threads = _boot(3, persist=True)
    disp = ChainDispatcher(addrs[0], codec="raw")
    disp.deploy(partition(g, list(plan1.cuts)), params, addrs, batch=1)
    live = LiveReplan(disp, g, params, addrs, batch=1)

    def bursty(inputs):
        t0 = time.monotonic()
        for off, x in zip(offsets, inputs):
            lag = t0 + off * 0.2 - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            yield x

    outs = disp.stream(bursty(xs[:cut]))
    measured = {0: 0.5, 1: 0.001, 2: 0.001}
    result = replan(g, plan1, measured, cost)
    want = jplan.replan(jg, jplan.solve(jg, 3, jcost), measured, jcost)
    assert _js(result.to_json()) == _js(want.to_json())
    assert result.moved
    receipt = result.apply(live, min_improvement=1.0)
    assert receipt is not None
    assert receipt["stages"] == 3
    assert receipt["quiesced"] == [cut, cut, cut]
    assert receipt["cuts"] == list(result.new_plan.cuts)
    assert receipt["cutover_ms"] > 0
    outs += disp.stream(xs[cut:])
    disp.close()
    live.shutdown()
    for t in threads:
        t.join(timeout=30)
    assert live.cutovers == 1
    evs = [e for e in recorder().snapshot() if e["kind"] == "cutover"]
    assert evs and evs[-1]["data"] == {"stages": 3,
                                       "quiesced": [cut, cut, cut]}

    ref = _plain(g, params, plan1.cuts, xs[:cut]) \
        + _plain(g, params, result.new_plan.cuts, xs[cut:])
    assert len(outs) == len(ref) == len(xs)
    for i, (y, r) in enumerate(zip(outs, ref)):
        np.testing.assert_array_equal(y, r, err_msg=f"sample {i}")


def test_replan_apply_skips_unmoved_suggestions(tiny):
    g, _ = tiny
    cost = StageCostModel(g, gen="unknown")
    plan1 = solve(g, 3, cost)
    result = replan(g, plan1, {}, cost)
    assert not result.moved

    class _Boom:
        def apply(self, *_a, **_k):  # pragma: no cover
            raise AssertionError("unmoved suggestion must not cut over")

    assert result.apply(_Boom()) is None


def test_live_replan_keeps_the_process_set(tiny):
    """A plan whose cuts make another stage count is refused before any
    node is touched (a live replan redeploys onto the same nodes)."""
    g, params = tiny

    class _Untouched:
        codec = "raw"

        def __getattr__(self, name):  # pragma: no cover
            raise AssertionError(f"dispatcher.{name} called")

    cost = StageCostModel(g, gen="unknown")
    live = LiveReplan(_Untouched(), g, params, ["a:1", "b:2", "c:3"])
    with pytest.raises(ValueError, match="keeps the process set"):
        live.apply(solve(g, 4, cost))


def test_live_replan_passes_one_codec_per_stage(tiny):
    """``apply`` deploys the plan's per-cut codecs plus the dispatcher's
    codec for the result hop: one outbound codec per stage."""
    g, params = tiny
    calls = {}

    class _Disp:
        codec = "lzb"

        def quiesce(self, addrs, **kw):
            calls["quiesce"] = (list(addrs), kw)
            return [4] * len(addrs)

        def end_stream(self):
            calls["end"] = True

        def deploy(self, stages, params_, addrs, **kw):
            calls["deploy"] = (len(stages), list(addrs), kw)

    cost = StageCostModel(g, gen="unknown")
    plan = solve(g, 3, cost)
    receipt = LiveReplan(_Disp(), g, params, ["a:1", "b:2", "c:3"],
                         batch=2).apply(plan)
    n, addrs, kw = calls["deploy"]
    assert n == 3 and addrs == ["a:1", "b:2", "c:3"] and calls["end"]
    assert kw == {"batch": 2, "codecs": list(plan.codecs) + ["lzb"]}
    assert receipt["quiesced"] == [4, 4, 4]
