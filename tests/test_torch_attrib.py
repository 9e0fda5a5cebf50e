"""Port parity: per-request latency attribution (``obs/attrib.py``).

The same synthetic span lists go through the JAX package's
``attribute_request``/``attribute_sampled`` and the port's; the same
timestamps go through both ``DoorAttribution``s.  Results must be equal:
the fold is pure arithmetic on the same numbers.  The chain-traced
scenarios of ``tests/test_request_obs.py`` need the port's own stage
processes and are not repeated here.
"""

import numpy as np
import pytest

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
