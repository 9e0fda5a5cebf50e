"""Port parity: the serving front door (``defer_tpu_torch.serve``) on the
CPU, mirroring ``tests/test_serve.py``.

Admission (weighted-fair queuing, priorities, SLO shedding) gets the same
scripted sequence in both packages and must make the same decisions.  The
continuous-batching engine runs ``gpt_tiny`` on ``params_from_jax`` weights:
its greedy tokens equal the JAX engine's, and every request's tokens are
byte-identical whether it runs alone or shares the batch.  The decode door
serves both packages' clients, and the port's client talks to the JAX
door.  Tensor mode puts the port's door and ``ChainBackend`` over a JAX
``ChainDispatcher`` and ``StageNode`` chain (the port has no stage
processes of its own yet); its rows equal the JAX door's on the same chain.

Tolerances, with their reasons:

* tokens: equal (greedy tokens of the two packages' engines agree unless an
  f32 reduction-order difference flips a near tie; none occurs on these
  inputs, and one would show here as a mismatch);
* per-row ``decode`` against each row run at its position as a scalar, at
  the same batch shape: bit-equal (no op reduces across rows);
* per-row ``decode`` against the JAX package's vmapped single-row decodes:
  1e-5 of max |y| (f32 summation order);
* tensor-mode rows: equal to the JAX door's (the same JAX chain computes
  both).

Every socket test binds ``127.0.0.1:0``, joins its threads with a bound
and carries its own time limit.
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import defer_tpu.serve as jserve
from defer_tpu import partition as jax_partition
from defer_tpu.models import resnet_tiny as jax_resnet_tiny
from defer_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from defer_tpu.runtime.node import ChainDispatcher, StageNode
from defer_tpu.serve.client import fetch_stats as jax_fetch_stats
from defer_tpu.serve.frontdoor import ChainBackend as JaxChainBackend
from defer_tpu.serve.frontdoor import ServeFrontDoor as JaxFrontDoor
import defer_tpu_torch as dt
import defer_tpu_torch.serve as tserve
from defer_tpu_torch import models, params_from_jax
from defer_tpu_torch.obs import REGISTRY
from defer_tpu_torch.runtime.decode import (_sample_ids, gumbel_noise,
                                            gumbel_noise_rows)
from defer_tpu_torch.serve import (BatchFormer, ContinuousBatchEngine,
                                   DecodeRequest, LoadGenerator, ServeClient,
                                   ServeFrontDoor, TenantConfig,
                                   WeightedFairQueue, poisson_trace)
from defer_tpu_torch.serve.client import fetch_events, fetch_stats
from defer_tpu_torch.serve.frontdoor import ChainBackend

torch.set_num_threads(1)

DECODE_RTOL = 1e-5


# ---------------------------------------------------------------------------
# arrival traces
# ---------------------------------------------------------------------------

@pytest.mark.timeout(60)
@pytest.mark.parametrize("rate,dur,seed,bursts", [
    (50.0, 4.0, 7, [(1.0, 2.0, 3.0)]),
    (50.0, 4.0, 8, [(1.0, 2.0, 3.0)]),
    (12.5, 10.0, 0, [(4.0, 6.0, 2.0)]),
    (200.0, 1.5, 3, None),
    (30.0, 6.0, 11, [(0.5, 1.0, 4.0), (3.0, 3.5, 0.25)]),
])
def test_poisson_trace_equals_jax(rate, dur, seed, bursts):
    got = poisson_trace(rate, dur, seed=seed, bursts=bursts)
    assert got == jserve.poisson_trace(rate, dur, seed=seed, bursts=bursts)
    assert got == sorted(got) and all(0 <= t < dur for t in got)


@pytest.mark.timeout(60)
def test_poisson_trace_bursty_and_validated():
    a = poisson_trace(50.0, 4.0, seed=7, bursts=[(1.0, 2.0, 3.0)])
    assert a != poisson_trace(50.0, 4.0, seed=8, bursts=[(1.0, 2.0, 3.0)])
    in_burst = sum(1 for t in a if 1.0 <= t < 2.0)
    steady = sum(1 for t in a if t < 1.0 or t >= 2.0) / 3.0
    assert in_burst > 1.8 * steady, (in_burst, steady)
    with pytest.raises(ValueError):
        poisson_trace(10, 1, bursts=[(0.5, 0.2, 2.0)])
    assert poisson_trace(0, 5) == []


# ---------------------------------------------------------------------------
# weighted-fair queuing: one script, both packages
# ---------------------------------------------------------------------------

def _wfq_greedy_neighbor(ns):
    q = ns.WeightedFairQueue()
    q.configure(ns.TenantConfig("greedy", weight=1.0))
    q.configure(ns.TenantConfig("steady", weight=1.0))
    for i in range(60):
        q.push("greedy", f"g{i}")
    for i in range(10):
        q.push("steady", f"s{i}")
    served = [q.pop()[0] for _ in range(70)]
    for k in range(1, 21):
        g, s = served[:k].count("greedy"), served[:k].count("steady")
        assert abs(g - s) <= 1, (k, g, s)
    return served


def _wfq_weights(ns):
    q = ns.WeightedFairQueue()
    q.configure(ns.TenantConfig("heavy", weight=3.0))
    q.configure(ns.TenantConfig("light", weight=1.0))
    for i in range(80):
        q.push("heavy", i)
        q.push("light", i)
    first = [q.pop() for _ in range(40)]
    h = sum(1 for t, _ in first if t == "heavy")
    assert 2.0 <= h / max(40 - h, 1) <= 4.0, h
    return first


def _wfq_priority(ns):
    q = ns.WeightedFairQueue()
    q.configure(ns.TenantConfig("bulk", weight=5.0, priority=0))
    q.configure(ns.TenantConfig("interactive", weight=1.0, priority=1))
    for i in range(5):
        q.push("bulk", i)
    q.push("interactive", "now")
    out = [q.pop() for _ in range(6)]
    assert out[0] == ("interactive", "now") and out[1][0] == "bulk"
    return out


def _wfq_reconfigure(ns):
    q = ns.WeightedFairQueue()
    q.configure(ns.TenantConfig("a", priority=0))
    q.configure(ns.TenantConfig("b", priority=0))
    for i in range(3):
        q.push("a", i)
    q.push("b", "x")
    q.configure(ns.TenantConfig("a", priority=1))  # promote mid-backlog
    trace = [q.pop(), q.qsize()]
    q.push("a", 99)  # new pushes land in the NEW level
    trace += [q.pop(), q.drop_tenant("a"), q.qsize("a"), q.qsize(),
              q.pop(), q.qsize()]
    assert trace[0][0] == "a" and trace[1] == 3 and trace[2][0] == "a"
    assert trace[3:] == [2, 0, 1, ("b", "x"), 0]
    return trace


def _wfq_blocking_pop_and_drop(ns):
    q = ns.WeightedFairQueue()
    q.configure(ns.TenantConfig("a"))
    trace = [q.pop(timeout=0.0)]
    t = threading.Timer(0.05, lambda: q.push("a", 1))
    t.start()
    trace.append(q.pop(timeout=2.0))
    t.join(timeout=10)
    q.push("a", 2)
    q.push("a", 3)
    trace += [q.drop_tenant("a"), q.qsize()]
    q.push("a", 4)  # still configured after the drop
    trace.append(q.pop())
    assert trace == [None, ("a", 1), 2, 0, ("a", 4)]
    return trace


@pytest.mark.timeout(60)
@pytest.mark.parametrize("script", [
    _wfq_greedy_neighbor, _wfq_weights, _wfq_priority, _wfq_reconfigure,
    _wfq_blocking_pop_and_drop], ids=lambda f: f.__name__[5:])
def test_wfq_same_order_as_jax(script):
    assert script(tserve) == script(jserve)


# ---------------------------------------------------------------------------
# admission / shedding: one script, both packages
# ---------------------------------------------------------------------------

def _adm_shed_then_retry(ns, tenant):
    ctl = ns.AdmissionController(service_s=lambda: 0.1)
    ctl.configure(ns.TenantConfig(tenant, deadline_ms=250.0))
    out = [ctl.admit(tenant, "u1"), ctl.admit(tenant, "u2"),
           ctl.admit(tenant, "u3")]   # predicted (2+1)*0.1 = 0.3 > 0.25
    ctl.complete(tenant, queued_at=time.monotonic())
    out.append(ctl.admit(tenant, "u3-retry"))
    d3 = out[2]
    assert [d.admitted for d in out] == [True, True, False, True]
    assert d3.reason == "deadline" and d3.retry_after_s > 0 \
        and d3.predicted_s > 0.25
    row = ctl.stats()["tenants"][tenant]
    assert (row["admitted"], row["shed"], row["completed"]) == (3, 1, 1)
    return [d.to_json() for d in out] + [
        {k: row[k] for k in ("admitted", "shed", "completed", "queued",
                             "weight", "priority", "deadline_ms")}]


def _adm_backlog_cap(ns, tenant):
    ctl = ns.AdmissionController(service_s=lambda: 0.0)
    ctl.configure(ns.TenantConfig(tenant, max_queued=2))
    out = [ctl.admit(tenant, i) for i in range(3)]
    assert [d.admitted for d in out] == [True, True, False]
    assert out[2].reason == "backlog"
    return [d.to_json() for d in out]


def _adm_ewma_isolation(ns, tenant):
    ctl = ns.AdmissionController()
    ctl.configure(ns.TenantConfig(tenant + "_slo", deadline_ms=50.0))
    ctl.configure(ns.TenantConfig(tenant + "_be"))  # never SLO-shed
    ctl.observe_service(0.2)
    est = [ctl.service_estimate_s()]
    ctl.observe_service(0.1)
    est.append(ctl.service_estimate_s())
    out = [ctl.admit(tenant + "_slo", 1), ctl.admit(tenant + "_be", 1)]
    assert est[0] == pytest.approx(0.2)
    assert est[1] == pytest.approx(0.75 * 0.2 + 0.25 * 0.1)
    assert not out[0].admitted and out[1].admitted
    return est + [d.to_json() for d in out]


def _adm_cluster_view(ns, tenant):
    """``bind_cluster_view`` is duck-typed: any ``stage_effective_ms()``."""
    view = types.SimpleNamespace(stage_effective_ms=lambda: {0: 4.0, 1: 9.0})
    ctl = ns.AdmissionController(seed_service_s=0.5)
    ctl.configure(ns.TenantConfig(tenant, deadline_ms=10.0))
    est = [ctl.service_estimate_s()]
    ctl.bind_cluster_view(view, batch_width=3)
    est.append(ctl.service_estimate_s())
    assert est == [0.5, pytest.approx(0.003)]
    return est + [ctl.admit(tenant, i).to_json() for i in range(5)]


@pytest.mark.timeout(60)
@pytest.mark.parametrize("script", [
    _adm_shed_then_retry, _adm_backlog_cap, _adm_ewma_isolation,
    _adm_cluster_view], ids=lambda f: f.__name__[5:])
def test_admission_same_decisions_as_jax(script):
    # a tenant name of its own: both registries are process-wide
    tenant = f"port_{script.__name__}"
    assert script(tserve, tenant) == script(jserve, tenant)


@pytest.mark.timeout(60)
def test_admission_events_and_registry_names():
    from defer_tpu_torch.obs.events import recorder
    cursor = recorder().cursor()
    ctl = tserve.AdmissionController(service_s=lambda: 1.0)
    ctl.configure(TenantConfig("port_events", deadline_ms=1500.0))
    ctl.admit("port_events", types.SimpleNamespace(request_id=7))
    ctl.admit("port_events", types.SimpleNamespace(rid=8))
    _, evs = recorder().events_since(cursor)
    assert [(e["kind"], e["data"]["rid"]) for e in evs] == [("admit", 7),
                                                            ("shed", 8)]
    snap = REGISTRY.snapshot()
    for name in ("serve.admitted", "serve.shed", "serve.queue_delay_s",
                 "serve.tenant.port_events.admitted",
                 "serve.tenant.port_events.slo_ok"):
        assert name in snap, name
    assert snap["serve.tenant.port_events.shed"] == 1


@pytest.mark.timeout(60)
def test_batch_former_width_order_and_stamps():
    q = WeightedFairQueue()
    q.configure(TenantConfig("a"))
    q.configure(TenantConfig("b", priority=1))
    units = [types.SimpleNamespace(popped_at=None, n=i) for i in range(5)]
    for u in units[:3]:
        q.push("a", u)
    for u in units[3:]:
        q.push("b", u)
    former = BatchFormer(q, 4)
    got = former.form(timeout=0.0)
    assert [(t, u.n) for t, u in got] == [("b", 3), ("b", 4), ("a", 0),
                                          ("a", 1)]
    assert all(u.popped_at is not None for _, u in got)
    assert [u.n for _, u in former.form(timeout=0.0)] == [2]
    assert former.form(timeout=0.0) == []
    with pytest.raises(ValueError):
        BatchFormer(q, 0)


# ---------------------------------------------------------------------------
# per-row decode and the row-keyed draw
# ---------------------------------------------------------------------------

@pytest.mark.timeout(120)
@pytest.mark.parametrize("kv_heads", [None, 1])
def test_decode_per_row_positions(kv_heads):
    """Rows at mixed positions: bit-equal to the same batch run at each
    row's position as a scalar (the engine's fixed width keeps every GEMM
    at one shape; a different row count may round differently), and
    within 1e-5 of the JAX package's vmapped single-row decodes."""
    jg = jax_gpt_tiny(kv_heads=kv_heads)
    jp = jg.init(jax.random.key(1))
    g = models.gpt_tiny(kv_heads=kv_heads)
    p = params_from_jax(g, jp)["block_1"]
    op, jop = g.nodes["block_1"].op, jg.nodes["block_1"].op
    b, L, hd = 4, 16, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, 32)).astype(np.float32)
    k = rng.standard_normal((b, op.kv_heads, L, hd)).astype(np.float32)
    v = rng.standard_normal((b, op.kv_heads, L, hd)).astype(np.float32)
    pos = np.array([0, 5, 15, 7])

    def run(p_arg):
        return op.decode(p, torch.from_numpy(x), torch.from_numpy(k.copy()),
                         torch.from_numpy(v.copy()), p_arg)

    y, k2, v2 = run(torch.from_numpy(pos))
    for r in range(b):
        ys, ks, vs = run(int(pos[r]))
        assert torch.equal(ys[r], y[r])
        assert torch.equal(ks[r], k2[r]) and torch.equal(vs[r], v2[r])
    # each row wrote only its own position
    written = (k2.numpy() != k).any(axis=(1, 3))
    assert (written == (np.arange(L)[None] == pos[:, None])).all()

    def row(x_r, k_r, v_r, pos_r):
        yy, kk, vv = jop.decode(jp["block_1"], x_r[None], k_r[None],
                                v_r[None], pos_r)
        return yy[0], kk[0], vv[0]

    jy, jk, jv = jax.jit(jax.vmap(row))(x, k, v, jnp.asarray(pos))
    jy = np.asarray(jy)
    assert np.abs(y.numpy() - jy).max() <= DECODE_RTOL * np.abs(jy).max()
    np.testing.assert_allclose(k2.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), atol=1e-5)


@pytest.mark.timeout(60)
def test_decode_scalar_pos_unchanged_and_checked():
    g = models.gpt_tiny()
    p = g.init(torch.Generator().manual_seed(2))["block_0"]
    op = g.nodes["block_0"].op
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 2, 8, 16)).astype(
        np.float32))
    outs = [op.decode(p, x, k.clone(), k.clone(), pos)
            for pos in (5, torch.tensor(5), torch.tensor([5]))]
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="positions"):
        op.decode(p, x, k.clone(), k.clone(), torch.tensor([1, 2]))


@pytest.mark.timeout(60)
def test_row_keyed_draw_equals_per_row_noise():
    seeds = torch.tensor([3, 5, 2**33 + 7, 0, 5])
    ts = torch.tensor([0, 9, 4, 255, 9])
    noise = gumbel_noise_rows(seeds, ts, 37)
    for r in range(5):
        assert torch.equal(noise[r], gumbel_noise(int(seeds[r]), int(ts[r]),
                                                  (1, 37), "cpu")[0])
    # the draw of a (seed, t) pair does not depend on its row
    assert torch.equal(noise[1], noise[4])
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (5, 37)).astype(np.float32))
    temps = torch.tensor([0.5, 1.0, 2.0, 0.8, 1.0])
    ids = _sample_ids(logits, temps[:, None], 5, seeds, ts)
    for r in range(5):
        one = _sample_ids(logits[r:r + 1], temps[r], 5, int(seeds[r]),
                          int(ts[r]))
        assert int(ids[r]) == int(one[0])


# ---------------------------------------------------------------------------
# the continuous-batching engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gpt_setup():
    jg = jax_gpt_tiny()
    jp = jax.tree.map(np.asarray, jg.init(jax.random.key(0)))
    g = models.gpt_tiny()
    return jg, jp, g, params_from_jax(g, jp)


def _prompts(n, rng):
    return [rng.integers(0, 97, (int(p),)).astype(np.int32)
            for p in rng.integers(2, 6, n)]


def _engine(g, p, width, **kw):
    return ContinuousBatchEngine(g, p, num_stages=2, width=width,
                                 device="cpu", **kw)


@pytest.mark.timeout(180)
def test_engine_greedy_tokens_equal_jax(gpt_setup):
    jg, jp, g, p = gpt_setup
    prompts = _prompts(5, np.random.default_rng(3))

    def reqs(cls):
        return [cls(prompt=q, max_new_tokens=5, request_id=i)
                for i, q in enumerate(prompts)]

    want = jserve.ContinuousBatchEngine(jg, jp, num_stages=2,
                                        width=3).run_all(reqs(
                                            jserve.DecodeRequest))
    eng = _engine(g, p, 3)
    got = eng.run_all(reqs(DecodeRequest))
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        assert got[rid].dtype == np.int64
    assert eng.captures == 0 and eng.graph_pool_bytes == 0


@pytest.mark.timeout(180)
def test_engine_byte_identity_solo_vs_continuous(gpt_setup):
    """The correctness bar: per-request outputs byte-identical to the
    request run alone, with requests joining at different steps, greedy
    and sampled rows mixed."""
    _, _, g, p = gpt_setup
    prompts = _prompts(4, np.random.default_rng(3))

    def make_reqs():
        return [DecodeRequest(prompt=q, max_new_tokens=5, request_id=i,
                              seed=100 + i,
                              temperature=0.8 if i in (1, 3) else 0.0)
                for i, q in enumerate(prompts)]

    solo = {}
    for req in make_reqs():
        solo[req.request_id] = _engine(g, p, 3).run_all([req])[
            req.request_id]

    eng = _engine(g, p, 3)

    def stagger(e, queue):
        while queue and e.free_slots() \
                and e.steps >= 3 * queue[0].request_id:
            e.join(queue.pop(0))

    batched = eng.run_all(make_reqs(), joiner=stagger)
    for rid, ids in solo.items():
        np.testing.assert_array_equal(batched[rid], ids)
    steps = REGISTRY.histogram("serve.decode.step_s").count
    assert steps > 0
    for phase in ("gather", "dispatch", "device", "sync", "delivery"):
        assert REGISTRY.histogram(f"serve.decode.{phase}_s").count == steps


@pytest.mark.timeout(180)
def test_engine_sampled_tokens_do_not_depend_on_slot(gpt_setup):
    _, _, g, p = gpt_setup
    prompts = _prompts(3, np.random.default_rng(8))

    def make_reqs():
        return [DecodeRequest(prompt=q, max_new_tokens=6, request_id=i,
                              seed=7 + i, temperature=1.0)
                for i, q in enumerate(prompts)]

    forward = _engine(g, p, 3).run_all(make_reqs())
    backward = _engine(g, p, 3).run_all(make_reqs()[::-1])
    assert sorted(forward) == sorted(backward)
    for rid in forward:
        np.testing.assert_array_equal(forward[rid], backward[rid])
    # distinct seeds on the same prompt draw differently
    a = _engine(g, p, 1).run_all([DecodeRequest(
        prompt=prompts[0], max_new_tokens=8, seed=1, temperature=2.0)])[0]
    b = _engine(g, p, 1).run_all([DecodeRequest(
        prompt=prompts[0], max_new_tokens=8, seed=2, temperature=2.0)])[0]
    assert (a != b).any()


@pytest.mark.timeout(180)
def test_engine_recycled_slot_hides_stale_rows(gpt_setup):
    """A recycled slot keeps stale K/V rows past the new request's
    position; the mask alone hides them (large finite values: a NaN would
    leak through 0 * NaN in either package)."""
    _, _, g, p = gpt_setup
    prompt = _prompts(1, np.random.default_rng(5))[0]
    want = _engine(g, p, 2).run_all([DecodeRequest(prompt=prompt,
                                                   max_new_tokens=6)])[0]
    eng = _engine(g, p, 2)
    for c in eng._caches:
        c["k"].fill_(1e6)
        c["v"].fill_(-1e6)
    got = eng.run_all([DecodeRequest(prompt=prompt, max_new_tokens=6)])[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.timeout(180)
def test_engine_cancel_reclaims_slot_others_unaffected(gpt_setup):
    _, _, g, p = gpt_setup
    p_victim, p_survivor, p_late = _prompts(3, np.random.default_rng(4))
    survivor_solo = _engine(g, p, 2).run_all(
        [DecodeRequest(prompt=p_survivor, max_new_tokens=6,
                       request_id=1)])[1]
    eng = _engine(g, p, 2)
    victim = DecodeRequest(prompt=p_victim, max_new_tokens=10, request_id=0)
    survivor = DecodeRequest(prompt=p_survivor, max_new_tokens=6,
                             request_id=1)
    seen = []
    victim.on_done = seen.append
    assert eng.join(victim) and eng.join(survivor)
    assert eng.free_slots() == 0
    for _ in range(3):
        eng.step()
    assert eng.cancel(victim) and not eng.cancel(victim)
    assert seen == [None], "cancellation must signal on_done(None)"
    assert eng.free_slots() == 1
    late = DecodeRequest(prompt=p_late, max_new_tokens=2, request_id=2)
    assert eng.join(late), "a new request must fit the reclaimed slot"
    out = {}
    while eng.active():
        for req, ids in eng.step():
            out[req.request_id] = ids
    np.testing.assert_array_equal(out[1], survivor_solo)
    assert 2 in out and eng.free_slots() == 2
    assert eng.step() == []


@pytest.mark.timeout(120)
def test_engine_validates(gpt_setup, monkeypatch):
    _, _, g, p = gpt_setup
    eng = _engine(g, p, 1)
    with pytest.raises(ValueError, match="max_len"):
        eng.join(DecodeRequest(prompt=np.arange(10), max_new_tokens=99))
    with pytest.raises(ValueError, match="at least one token"):
        DecodeRequest(prompt=np.zeros((0,)), max_new_tokens=1)
    with pytest.raises(ValueError, match="max_new_tokens"):
        DecodeRequest(prompt=np.arange(3), max_new_tokens=0)
    assert eng.join(DecodeRequest(prompt=np.arange(3), max_new_tokens=1))
    assert not eng.join(DecodeRequest(prompt=np.arange(3),
                                      max_new_tokens=1))
    with pytest.raises(ValueError, match="width"):
        _engine(g, p, 0)
    with pytest.raises(ValueError, match="positional table"):
        _engine(g, p, 1, max_len=99)
    with pytest.raises(ValueError, match="node contract"):
        ContinuousBatchEngine(models.resnet_tiny(), {}, num_stages=1,
                              width=1, device="cpu")
    # no device and no CUDA: the entry point raises, never drops to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchEngine(g, p, num_stages=2, width=2)


# ---------------------------------------------------------------------------
# the decode-mode front door, across both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_doors():
    """The port's decode door and the JAX package's, on the same weights
    (gpt_tiny with a 48-position table, so a victim can be caught
    mid-decode)."""
    jg = jax_gpt_tiny(seq_len=48)
    jp = jax.tree.map(np.asarray, jg.init(jax.random.key(0)))
    g = models.gpt_tiny(seq_len=48)
    engine = ContinuousBatchEngine(g, params_from_jax(g, jp), num_stages=2,
                                   width=3, device="cpu")
    door = ServeFrontDoor(engine=engine,
                          decode_defaults={"max_new_tokens": 4}).start()
    jdoor = JaxFrontDoor(
        engine=jserve.ContinuousBatchEngine(jg, jp, num_stages=2, width=3),
        decode_defaults={"max_new_tokens": 4}).start()
    yield door, jdoor
    door.stop()
    jdoor.stop()


@pytest.mark.timeout(240)
def test_decode_door_roundtrip_disconnect_and_attribution(decode_doors):
    door, _ = decode_doors
    host, port = door.address
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 97, (4,)).astype(np.int32) for _ in range(2)]
    solo = ServeClient(host, port, "ref", max_new_tokens=4).stream(
        [prompts[0]])
    assert solo[0][0] == "ok" and solo[0][1].dtype == np.int64

    # slow the engine's steps so that the abort lands mid-decode
    eng = door.engine
    fast_step = eng.step

    def slow_step():
        time.sleep(0.02)
        return fast_step()

    eng.step = slow_step
    try:
        victim = ServeClient(host, port, "victim", max_new_tokens=40)
        victim.submit(prompts[1])
        deadline = time.monotonic() + 60
        while eng.active() == 0:
            assert time.monotonic() < deadline, "victim never joined"
            time.sleep(0.01)
        victim.abort()
        while eng.active():
            assert time.monotonic() < deadline, "victim never left"
            time.sleep(0.01)
    finally:
        del eng.step

    steady = ServeClient(host, port, "steady", max_new_tokens=4)
    out = steady.stream([prompts[0]])
    assert out[0][0] == "ok"
    np.testing.assert_array_equal(out[0][1], solo[0][1])
    deadline = time.monotonic() + 60
    while door.engine.free_slots() != door.engine.width:
        assert time.monotonic() < deadline, \
            "the disconnected client's KV slot was never reclaimed"
        time.sleep(0.05)
    doc = fetch_stats(host, port)
    buckets = doc["attribution"]["steady"]
    assert buckets["e2e"]["count"] == 1
    assert buckets["chain"]["p50"] > 0
    assert buckets["chain"]["p50"] > buckets["admission"]["p50"]
    assert doc["mode"] == "decode" and doc["width"] == 3
    assert doc["decode"]["steps"] == door.engine.steps > 0
    assert doc["decode"]["captures"] == 0
    assert doc["tenants"]["steady"]["completed"] == 1
    kinds = {e["kind"] for e in fetch_events(host, port)["events"]}
    assert {"client_open", "client_close", "admit", "decode_join",
            "decode_cancel"} <= kinds
    door.healthcheck()


@pytest.mark.timeout(240)
def test_decode_doors_and_clients_interoperate(decode_doors):
    """Either package's client against either package's door: greedy and
    sampled tokens equal a solo run on the same door, and greedy tokens
    equal across the doors."""
    door, jdoor = decode_doors
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 97, (int(n),)).astype(np.int32)
               for n in rng.integers(3, 9, 4)]
    res = {}
    for dname, d in (("torch", door), ("jax", jdoor)):
        for cname, cls in (("torch", ServeClient),
                           ("jax", jserve.ServeClient)):
            for temp in (0.0, 0.9):
                c = cls(*d.address, f"x_{cname}_{temp}", max_new_tokens=5,
                        temperature=temp, seed=21)
                assert c.welcome["mode"] == "decode"
                outs = c.stream(prompts)
                assert all(o[0] == "ok" for o in outs), outs
                res[dname, cname, temp] = [o[1] for o in outs]
    for dname in ("torch", "jax"):
        for temp in (0.0, 0.9):
            for a, b in zip(res[dname, "torch", temp],
                            res[dname, "jax", temp]):
                np.testing.assert_array_equal(a, b)
    for a, b in zip(res["torch", "torch", 0.0], res["jax", "torch", 0.0]):
        np.testing.assert_array_equal(a, b)
    # the port's door answers the JAX package's stats query, and back
    assert jax_fetch_stats(*door.address)["tenants"]["x_jax_0.0"][
        "completed"] == len(prompts)
    assert fetch_stats(*jdoor.address)["tenants"]["x_torch_0.9"][
        "completed"] == len(prompts)
    door.healthcheck()
    jdoor.healthcheck()


@pytest.mark.timeout(240)
def test_decode_door_delivers_out_of_order(decode_doors):
    """One client's requests finish in another order than sent (shorter
    prompts behind a long one): each reply carries its own sample number
    and the tokens of a solo run."""
    door, _ = decode_doors
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 97, (n,)).astype(np.int32)
               for n in (9, 2, 5, 3, 7)]
    c = ServeClient(*door.address, "out_of_order", max_new_tokens=4)
    outs = c.stream(prompts)
    recv = [o[2] for o in outs]
    assert recv != sorted(recv), "the replies should arrive out of order"
    eng = door.engine
    for p, o in zip(prompts, outs):
        assert o[0] == "ok"
        solo = ContinuousBatchEngine(
            eng.graph, eng.params, num_stages=2, width=3,
            device="cpu").run_all([DecodeRequest(prompt=p,
                                                 max_new_tokens=4)])[0]
        np.testing.assert_array_equal(o[1], solo)
    door.healthcheck()


@pytest.mark.timeout(240)
def test_decode_door_many_clients_stress(decode_doors):
    """More client threads than cores, with a short switch interval: every
    request is answered with a solo run's tokens, each tenant's counters
    add up, and the admission backlog returns to zero (a lost update in
    the door's shared state would break one of these)."""
    import sys

    door, _ = decode_doors
    eng = door.engine
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 97, (int(n),)).astype(np.int32)
               for n in rng.integers(2, 8, 4)]
    want = [ContinuousBatchEngine(
        eng.graph, eng.params, num_stages=2, width=3,
        device="cpu").run_all([DecodeRequest(prompt=p, max_new_tokens=3)])[0]
        for p in prompts]
    outs, errs = {}, []

    def go(k):
        try:
            c = ServeClient(*door.address, f"stress{k % 4}",
                            weight=1.0 + k % 3, max_new_tokens=3)
            outs[k] = c.stream(prompts)
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=go, args=(k,), daemon=True)
              for k in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=180)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert errs == [] and len(outs) == 12
    for replies in outs.values():
        for o, w in zip(replies, want):
            assert o[0] == "ok"
            np.testing.assert_array_equal(o[1], w)
    doc = fetch_stats(*door.address)
    for t in range(4):
        assert doc["tenants"][f"stress{t}"]["completed"] == 3 * 4
    assert doc["inflight"] == 0 and door.admission.inflight == 0
    door.healthcheck()


@pytest.mark.timeout(240)
def test_decode_door_open_loop_load(decode_doors):
    door, _ = decode_doors
    prompts = [np.arange(3, dtype=np.int32) + i for i in range(4)]
    offsets = poisson_trace(40.0, 0.5, seed=2, bursts=[(0.1, 0.2, 2.0)])
    c = ServeClient(*door.address, "open_loop", max_new_tokens=3)
    rep = LoadGenerator(c, prompts, offsets).run()
    assert rep["offered"] == len(offsets) > 0
    assert rep["completed"] + rep["shed"] == rep["offered"]
    assert rep["latency_p99_ms"] >= rep["latency_p50_ms"] > 0
    assert fetch_stats(*door.address)["tenants"]["open_loop"][
        "completed"] == rep["completed"]


# ---------------------------------------------------------------------------
# tensor mode: the port's door over a JAX chain
# ---------------------------------------------------------------------------

IN_SHAPE = (32, 32, 3)


def _boot_chain(stages, params, batch):
    nodes = [StageNode(None, "127.0.0.1:0", None) for _ in stages]
    addrs = [f"127.0.0.1:{n.address[1]}" for n in nodes]
    threads = [threading.Thread(target=n.serve, daemon=True) for n in nodes]
    for t in threads:
        t.start()
    disp = ChainDispatcher(addrs[0], codec="raw")
    disp.deploy(stages, params, addrs, batch=batch)
    return disp, threads


@pytest.fixture(scope="module")
def tensor_doors():
    g = jax_resnet_tiny()
    params = g.init(jax.random.key(0))
    stages = jax_partition(g, num_stages=2)
    disp, threads = _boot_chain(stages, params, 4)
    door = ServeFrontDoor(backend=ChainBackend(disp, 4, IN_SHAPE)).start()
    jdisp, jthreads = _boot_chain(stages, params, 4)
    jdoor = JaxFrontDoor(backend=JaxChainBackend(jdisp, 4, IN_SHAPE)).start()
    yield door, jdoor
    door.stop()
    jdoor.stop()
    for t in threads + jthreads:
        t.join(timeout=30)


@pytest.mark.timeout(240)
def test_tensor_door_multitenant_byte_identity(tensor_doors):
    """Three concurrent tenants over ONE deployed chain: every row
    byte-identical to the request run alone, and to the JAX door's rows
    on the same chain."""
    door, jdoor = tensor_doors
    host, port = door.address
    rng = np.random.default_rng(11)
    # tenant names of this file's own: both packages' registries are
    # process-wide, and the JAX package's tests count their own tenants
    data = {t: [rng.standard_normal(IN_SHAPE).astype(np.float32)
                for _ in range(3)] for t in ("tx_alpha", "tx_beta",
                                             "tx_gamma")}
    solo = {t: ServeClient(host, port, t + "_solo").stream(data[t])
            for t in data}
    outs = {}

    def run_tenant(t):
        outs[t] = ServeClient(host, port, t).stream(data[t])

    ths = [threading.Thread(target=run_tenant, args=(t,)) for t in data]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120)
    door.healthcheck()
    ref = {t: jserve.ServeClient(*jdoor.address, t).stream(data[t])
           for t in data}
    for t in data:
        for i in range(len(data[t])):
            assert outs[t][i][0] == "ok" and solo[t][i][0] == "ok"
            np.testing.assert_array_equal(outs[t][i][1], solo[t][i][1])
            np.testing.assert_array_equal(outs[t][i][1], ref[t][i][1])
    doc = fetch_stats(host, port)
    assert doc["mode"] == "tensor" and doc["width"] == 4
    assert doc["tenants"]["tx_alpha"]["completed"] == 3
    assert doc["frames"] > 0 and doc["samples"] >= 18


@pytest.mark.timeout(240)
def test_tensor_door_shed_reply_and_retry(tensor_doors):
    door, _ = tensor_doors
    host, port = door.address
    # pin the service estimate high so the SLO math sheds immediately
    door.admission._service_s = lambda: 0.5
    try:
        c = ServeClient(host, port, "tx_slo", deadline_ms=600.0)
        x = np.zeros(IN_SHAPE, np.float32)
        for _ in range(4):
            c.submit(x)
        time.sleep(1.0)
        retry_seq = c.submit(x)
        results = c.finish()
        outcomes = [results[q][0] for q in sorted(results)]
        assert "shed" in outcomes, outcomes
        shed = next(v for v in results.values() if v[0] == "shed")
        assert shed[1]["reason"] == "deadline"
        assert shed[1]["retry_after_ms"] > 0
        assert shed[1]["predicted_ms"] > 600.0
        assert results[retry_seq][0] == "ok"
    finally:
        door.admission._service_s = None
    pressure = fetch_stats(host, port)["pressure"]
    assert pressure["width"] == 4 and pressure["backend_lost"] is False


@pytest.mark.timeout(60)
def test_top_level_exports():
    for name in ("ServeFrontDoor", "ContinuousBatchEngine", "DecodeRequest",
                 "ServeClient"):
        assert getattr(dt, name) is getattr(tserve, name)
        assert name in dt.__all__
    assert "max_batch_within_budget" not in tserve.__all__
