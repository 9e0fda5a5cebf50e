"""Port parity: per-request latency attribution (``obs/attrib.py``).

The same synthetic span lists go through the JAX package's
``attribute_request``/``attribute_sampled`` and the port's; the same
timestamps go through both ``DoorAttribution``s.  Results must be equal:
the fold is pure arithmetic on the same numbers.  The chain-traced
scenarios of ``tests/test_request_obs.py`` (a sampled request's waterfall,
its buckets summing to the wall over a ``dsleep`` hop) run on the port's
door and in-process stage-node chain, with the JAX test's bounds.
"""

import threading

import numpy as np
import pytest
import torch

from defer_tpu.obs import attrib as jattrib
from defer_tpu_torch.obs import attrib as tattrib


def _span(name, ts, dur, **args):
    return {"name": name, "ts_us": int(ts), "dur_us": int(dur), "tid": 1,
            "args": args}


def _request_spans(rid, seq, t0, rng, *, stages=3, deliver=True,
                   admission=True, gather=True, host_sync=True,
                   tenant="gold"):
    """One served request's spans on one timeline: admission wait,
    gather, every stage's infer (+ host sync), deliver, root."""
    out = []
    t = t0
    if admission:
        d = rng.integers(5, 500)
        out.append(_span("serve.admission_wait", t, d, rid=rid,
                         tenant=tenant, seq=seq))
        t += d
    if gather:
        d = rng.integers(1, 50)
        out.append(_span("serve.gather", t, d, seq=seq, n=2))
        t += d
    for k in range(stages):
        t += rng.integers(10, 300)   # the hop
        d = rng.integers(100, 2000)
        out.append(_span(f"stage{k}.infer", t, d, seq=seq))
        if host_sync:
            out.append(_span(f"stage{k}.host_sync", t + d // 2, d // 4,
                             seq=seq))
        t += d
    t += rng.integers(10, 300)       # the result hop
    if deliver:
        d = rng.integers(1, 40)
        out.append(_span("serve.deliver", t, d, rid=rid, tenant=tenant,
                         seq=seq))
        t += d
    t += rng.integers(0, 5)
    out.append(_span("serve.request", t0, t - t0, rid=rid, tenant=tenant,
                     seq=seq, client_seq=rid))
    return out


def _spans(seed):
    rng = np.random.default_rng(seed)
    spans = []
    variants = [{}, {"deliver": False}, {"admission": False},
                {"gather": False, "host_sync": False}, {"stages": 1},
                {"tenant": "silver"}]
    for i, kw in enumerate(variants):
        spans += _request_spans(100 + i, 7 + 2 * i, 1_000_000 + 50_000 * i,
                                rng, **kw)
    # noise the fold must ignore: unrelated spans, a root without a seq
    spans.append(_span("spmd.push", 1_000_000, 10))
    spans.append(_span("serve.request", 2_000_000, 100, rid=999,
                       tenant="gold"))
    rng.shuffle(spans)
    return spans


@pytest.mark.timeout(60)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("hop_tiers", [None, ["tcp", "shm", "tcp", "tcp"],
                                       ["tcp"]])
def test_attribute_sampled_equals_jax(seed, hop_tiers):
    spans = _spans(seed)
    got = tattrib.attribute_sampled(spans, hop_tiers=hop_tiers)
    want = jattrib.attribute_sampled(spans, hop_tiers=hop_tiers)
    assert [r.to_json() for r in got] == [r.to_json() for r in want]
    assert len(got) == 6
    assert [r.wall_ms for r in got] == sorted(r.wall_ms for r in got)
    for r, w in zip(got, want):
        assert r.stages == w.stages and r.ok(0.10) == w.ok(0.10)
        assert r.sum_ms == pytest.approx(w.sum_ms)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("rid", [100, 101, 102, 103, 104, 105, 999, 12345])
def test_attribute_request_equals_jax(rid):
    spans = _spans(4)
    got = tattrib.attribute_request(spans, rid, hop_tiers=["tcp"] * 4)
    want = jattrib.attribute_request(spans, rid, hop_tiers=["tcp"] * 4)
    if want is None:
        assert got is None
        return
    assert got.to_json() == want.to_json()
    # the buckets tile the timeline: the residual is the few microseconds
    # of the root's tail past the last bucket
    assert got.ok(0.10)
    for name in ("admission", "gather", "stage0", "host_sync",
                 "transport.hop0", "transport.result", "result_edge"):
        assert name in got.buckets


@pytest.mark.timeout(60)
def test_request_attribution_ok_and_residual():
    for mod in (tattrib, jattrib):
        rep = mod.RequestAttribution(1, "t", 2, 10.0, {"a": 4.0, "b": 5.5},
                                     {}, [0])
        assert rep.residual_ms == pytest.approx(0.5)
        assert rep.ok(0.10) and not rep.ok(0.01)
        empty = mod.RequestAttribution(1, "t", 2, 0.0, {}, {}, [])
        assert not empty.ok()


@pytest.mark.timeout(60)
def test_door_attribution_equals_jax():
    rng = np.random.default_rng(3)
    ours, theirs = tattrib.DoorAttribution(), jattrib.DoorAttribution()
    for i in range(200):
        t = float(rng.uniform(0, 100))
        stamps = np.cumsum(rng.exponential(0.01, 5)) + t
        if i % 17 == 0:          # out-of-order stamps clamp to zero width
            stamps = stamps[::-1]
        kw = dict(zip(("queued", "popped", "submitted", "demuxed",
                       "delivered"), map(float, stamps)))
        tenant = ("alpha", "beta", "gamma")[i % 3]
        ours.record(tenant, **kw)
        theirs.record(tenant, **kw)
    got, want = ours.summary(), theirs.summary()
    assert got == want
    assert sorted(got) == ["alpha", "beta", "gamma"]
    assert set(got["alpha"]) == set(tattrib.DOOR_BUCKETS) | {"e2e"}
    assert got["beta"]["e2e"]["count"] == 67


# ---------------------------------------------------------------------------
# the traced door over the port's chain (tests/test_request_obs.py)
# ---------------------------------------------------------------------------

IN_SHAPE = (32, 32, 3)


@pytest.fixture(scope="module")
def traced_door():
    """A 2-stage delay-bound port chain (in-process nodes on the CPU, one
    tracer, so every span lands on one clock) behind the port's door with
    tracing on and every request sampled."""
    from defer_tpu_torch import models, partition
    from defer_tpu_torch.obs import tracer
    from defer_tpu_torch.runtime.node import ChainDispatcher, StageNode
    from defer_tpu_torch.serve import ServeFrontDoor, TenantConfig
    from defer_tpu_torch.serve.frontdoor import ChainBackend

    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    stages = partition(g, num_stages=2)
    tr = tracer()
    tr.enabled = True
    tr.process = "serve"
    tr.start_trace()
    nodes = [StageNode(None, "127.0.0.1:0", None, device="cpu")
             for _ in stages]
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    threads = [threading.Thread(target=n.serve, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    disp = ChainDispatcher(addrs[0], codec="raw")
    # a decode-side sleep on the stage0 -> stage1 hop: a transport cost
    # the attribution must find
    disp.deploy(stages, params, addrs, batch=2,
                codecs=["dsleep5+raw", "raw"])
    door = ServeFrontDoor(
        backend=ChainBackend(disp, 2, IN_SHAPE, trace_sample_every=1),
        tenants=[TenantConfig("obs_gold", deadline_ms=5000.0)]).start()
    yield door
    door.stop()
    for t in threads:
        t.join(timeout=30)
    tr.enabled = False
    tr.clear()


def _stream(door, tenant, n):
    from defer_tpu_torch.serve import ServeClient
    rng = np.random.default_rng(7)
    data = [rng.standard_normal(IN_SHAPE).astype(np.float32)
            for _ in range(n)]
    outs = ServeClient(*door.address, tenant, deadline_ms=5000.0).stream(
        data)
    assert all(o is not None and o[0] == "ok" for o in outs), outs


@pytest.mark.timeout(120)
def test_sampled_request_trace_is_complete_and_ordered(traced_door):
    """A sampled request's trace holds admission, gather, every stage and
    the delivery, with monotone completion points (a few µs of slack for
    independently truncated timestamps)."""
    from defer_tpu_torch.obs import tracer

    _stream(traced_door, "obs_gold", 3)
    spans = tracer().spans
    rids = sorted({int(s["args"]["rid"]) for s in spans
                   if s["name"] == "serve.request"
                   and s["args"].get("tenant") == "obs_gold"})
    assert len(rids) == 3
    for rid in rids:
        mine = {s["name"]: s for s in spans
                if (s["args"] or {}).get("rid") == rid}
        root = mine["serve.request"]
        frame = {s["name"]: s for s in spans
                 if (s["args"] or {}).get("seq") == root["args"]["seq"]}
        chain = [mine["serve.admission_wait"], frame["serve.gather"],
                 frame["stage0.infer"], frame["stage1.infer"],
                 mine["serve.deliver"]]
        ends = [s["ts_us"] + s["dur_us"] for s in chain]
        for a, b in zip(ends, ends[1:]):
            assert b >= a - 3, ends
        assert root["ts_us"] <= chain[0]["ts_us"] + 3
        assert ends[-1] <= root["ts_us"] + root["dur_us"] + 3


@pytest.mark.timeout(120)
def test_attribution_buckets_sum_to_measured_wall(traced_door):
    """The buckets sum to within 10% of each request's wall, and the
    delay-bound hop carries the injected 5 ms.  The spans folded are
    those recorded from this stream's start: the tracer is the process's,
    and a span another chain of this worker recorded earlier under the
    same frame seq would be folded into these requests."""
    from defer_tpu_torch.obs import tracer

    cursor = tracer().span_cursor()
    _stream(traced_door, "obs_attr", 4)
    spans = tracer().spans_since(cursor)[1]
    reps = [r for r in tattrib.attribute_sampled(
        spans, hop_tiers=["tcp", "tcp", "tcp"]) if r.tenant == "obs_attr"]
    assert len(reps) == 4
    for rep in reps:
        assert rep.ok(0.10), rep.to_json()
        for want in ("admission", "gather", "transport.hop0", "stage0",
                     "transport.hop1", "stage1", "host_sync",
                     "transport.result", "result_edge"):
            assert want in rep.buckets, rep.buckets
        assert rep.buckets["transport.hop1"] >= 4.0, rep.to_json()
        assert rep.wall_ms >= 5.0
