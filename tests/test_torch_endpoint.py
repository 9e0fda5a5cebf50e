"""Port parity: ``Defer.serve_endpoint`` on the CPU.

The scenarios of ``tests/test_endpoint_multiclient.py``,
``tests/test_staging.py``'s endpoint test and
``tests/test_advice_r2.py``'s endpoint regressions, on the port, with
``resnet_tiny`` in 4 stages as the JAX tests use: in-order streaming, two
concurrent clients, operator stop, live reweight between clients, a client
that dies and one that reconnects, a stalled ring and a bad sample that
fail loudly.  Across packages, the JAX package's ``TensorClient`` streams
through the port's endpoint and the port's client through the JAX
package's endpoint.

Tolerances, with their reasons:

* the endpoint against ``Defer.run`` of the same deployment in the same
  package: equal (the same pipeline steps on the same inputs), including
  bf16 compute on a bf16 ring under the int8 wire;
* across packages, against the other package's ``Defer.run`` on the
  buffer wire: 1e-5 of max |output| (the forward parity bound of
  ``tests/test_torch_pipeline.py``);
* ``bf8`` replies: blockfloat's 8-bit bound, the row max / 127
  (``tests/test_torch_codec.py``).

Every test joins its threads with a bound and carries its own time limit.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax

import defer_tpu as jdt
from defer_tpu.transport.framed import TensorClient as JaxClient
from defer_tpu_torch import Defer, DeferConfig, models, params_from_jax
from defer_tpu_torch.graph.ir import tree_map
from defer_tpu_torch.obs import REGISTRY
from defer_tpu_torch.transport.framed import TensorClient, send_frame
from defer_tpu_torch.transport.staging import HostStagingRing

torch.set_num_threads(1)

CROSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    g = models.resnet_tiny()
    return g, g.init(torch.Generator().manual_seed(0))


def _defer(**kw):
    return Defer(DeferConfig(device="cpu", **{"microbatch": 1, "chunk": 4,
                                              **kw}))


def _xs(n, seed, mb=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((mb, 32, 32, 3)).astype(np.float32)
            for _ in range(n)]


def _stream(address, xs, client=TensorClient, **kw):
    c = client(*address, timeout_s=60)
    try:
        return c.infer_stream(xs, **kw)
    finally:
        c.close()


def _join(thread, timeout=60):
    thread.join(timeout=timeout)
    assert not thread.is_alive()


@pytest.mark.timeout(120)
def test_serve_endpoint_streams_in_order(tiny):
    g, params = tiny
    defer = _defer()
    ep_in = REGISTRY.counter("endpoint.samples_in")
    ep_out = REGISTRY.counter("endpoint.samples_out")
    n_in, n_out = ep_in.n, ep_out.n
    address, thread = defer.serve_endpoint(g, params, num_stages=4)
    xs = _xs(10, 0)
    outs = _stream(address, xs)
    _join(thread)
    assert thread.errors == []
    assert len(outs) == 10 and outs[0].dtype == np.float32
    np.testing.assert_array_equal(
        np.stack(outs), defer.run(g, params, np.stack(xs), num_stages=4))
    with torch.inference_mode():
        for x, y in zip(xs, outs):
            np.testing.assert_allclose(
                y, g.apply(params, torch.from_numpy(x)).numpy(),
                rtol=2e-4, atol=2e-4)
    assert (ep_in.n - n_in, ep_out.n - n_out) == (10, 10)


@pytest.mark.timeout(120)
def test_two_concurrent_clients_each_get_their_own_results(tiny):
    g, params = tiny
    defer = _defer()
    address, thread = defer.serve_endpoint(g, params, num_stages=4,
                                           max_clients=2)
    xs = {"a": _xs(7, 1), "b": _xs(7, 2)}  # distinct, so a mix-up shows
    outs = {}

    def go(k):
        outs[k] = _stream(address, xs[k])

    ts = [threading.Thread(target=go, args=(k,), daemon=True) for k in xs]
    for t in ts:
        t.start()
    for t in ts:
        _join(t, 90)
    _join(thread)
    assert thread.errors == []
    for k in xs:
        np.testing.assert_array_equal(
            np.stack(outs[k]),
            defer.run(g, params, np.stack(xs[k]), num_stages=4))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mb,chunk", [(2, 3)])
def test_microbatched_bf8_replies(tiny, mb, chunk):
    """Microbatch 2 (the serve loop pads each row to the ring's width),
    ``bf8`` replies within blockfloat's 8-bit bound of ``Defer.run``, and
    the endpoint counters at ``microbatch`` samples per frame."""
    g, params = tiny
    defer = _defer(microbatch=mb, chunk=chunk)
    ep_in = REGISTRY.counter("endpoint.samples_in")
    ep_out = REGISTRY.counter("endpoint.samples_out")
    n_in, n_out = ep_in.n, ep_out.n
    address, thread = defer.serve_endpoint(g, params, num_stages=4,
                                           codec="bf8")
    xs = _xs(5, 3, mb)
    outs = _stream(address, xs)
    _join(thread)
    # the counters count samples (the JAX package counts frames)
    assert (ep_in.n - n_in, ep_out.n - n_out) == (5 * mb, 5 * mb)
    want = defer.run(g, params, np.stack(xs), num_stages=4)
    assert np.stack(outs).shape == want.shape
    for y, w in zip(outs, want):
        assert np.abs(y - w).max() <= np.abs(w).max() / 127


@pytest.mark.timeout(120)
def test_bf16_int8_deployment_equals_defer_run(tiny):
    """bf16 compute on a bf16 ring under the int8 wire (the card's served
    deployment): the staged f32 block is cast on the device, and the rows
    equal ``Defer.run``; bfloat16 request frames are accepted."""
    g, params = tiny
    defer = _defer(wire="int8", compute_dtype="bfloat16",
                   buffer_dtype="bfloat16")
    address, thread = defer.serve_endpoint(g, params, num_stages=4)
    xs = _xs(6, 4)
    outs = _stream(address, [torch.from_numpy(x).to(torch.bfloat16)
                             for x in xs])
    _join(thread)
    assert thread.errors == []
    rounded = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
               for x in xs]
    np.testing.assert_array_equal(
        np.stack(outs), defer.run(g, params, np.stack(rounded),
                                  num_stages=4))


@pytest.mark.timeout(120)
def test_operator_stop_terminates_undersubscribed_endpoint(tiny):
    g, params = tiny
    address, thread = _defer().serve_endpoint(g, params, num_stages=4,
                                              max_clients=4)
    assert len(_stream(address, _xs(3, 3))) == 3
    assert thread.is_alive()  # still waiting for 3 more clients
    thread.stop()
    _join(thread)


@pytest.mark.timeout(120)
def test_live_reweight_between_clients(tiny):
    g, params = tiny
    defer = _defer()
    address, thread = defer.serve_endpoint(g, params, num_stages=4,
                                           max_clients=2)
    xs = _xs(3, 4)
    out1 = _stream(address, xs)
    params2 = tree_map(lambda v: v * 1.5, params)
    thread.reweight(params2)
    out2 = _stream(address, xs)
    _join(thread)
    np.testing.assert_array_equal(
        np.stack(out1), defer.run(g, params, np.stack(xs), num_stages=4))
    np.testing.assert_array_equal(
        np.stack(out2), defer.run(g, params2, np.stack(xs), num_stages=4))
    assert not np.array_equal(out1[0], out2[0])


@pytest.mark.timeout(120)
def test_client_death_then_reconnect(tiny):
    g, params = tiny
    defer = _defer()
    address, thread = defer.serve_endpoint(g, params, num_stages=4,
                                           max_clients=2)
    raw = socket.create_connection(address)  # two samples, then no END
    x = np.zeros((1, 32, 32, 3), np.float32)
    send_frame(raw, x)
    send_frame(raw, x)
    raw.close()
    xs = _xs(5, 2)
    outs = _stream(address, xs)
    _join(thread, 120)
    np.testing.assert_array_equal(
        np.stack(outs), defer.run(g, params, np.stack(xs), num_stages=4))


@pytest.mark.timeout(60)
def test_endpoint_ring_stall_fails_loudly(tiny, monkeypatch):
    """A ring that never accepts aborts the connection instead of
    returning fewer results than inputs."""
    g, params = tiny
    monkeypatch.setattr(HostStagingRing, "push",
                        lambda self, sample, timeout_s=30.0: False)
    address, thread = _defer(chunk=2).serve_endpoint(
        g, params, num_stages=2, stall_timeout_s=0.2)
    x = np.zeros((1, 32, 32, 3), np.float32)
    with pytest.raises((OSError, ConnectionError)):
        _stream(address, [x, x])
    _join(thread, 30)
    assert any(isinstance(e, RuntimeError) for e in thread.errors)


@pytest.mark.timeout(60)
def test_endpoint_bad_sample_aborts_connection(tiny):
    g, params = tiny
    address, thread = _defer(chunk=2).serve_endpoint(g, params,
                                                     num_stages=2)
    t0 = time.monotonic()
    with pytest.raises((OSError, ConnectionError)):
        _stream(address, [np.zeros((1, 7), np.float32)])
    assert time.monotonic() - t0 < 30
    _join(thread, 30)
    assert any(isinstance(e, ValueError) for e in thread.errors)


@pytest.mark.timeout(60)
def test_mpmd_mode_is_refused(tiny):
    g, params = tiny
    with pytest.raises(ValueError, match="spmd"):
        _defer(mode="mpmd").serve_endpoint(g, params, num_stages=2)


@pytest.fixture(scope="module")
def crossed():
    jg = jdt.models.resnet_tiny()
    np_params = jax.tree.map(np.asarray, jax.jit(jg.init)(jax.random.key(0)))
    tg = models.resnet_tiny()
    return jg, np_params, tg, params_from_jax(tg, np_params)


@pytest.mark.timeout(180)
def test_jax_client_through_the_ports_endpoint(crossed):
    jg, np_params, tg, params = crossed
    address, thread = _defer().serve_endpoint(tg, params, num_stages=4)
    xs = _xs(6, 5)
    outs = _stream(address, xs, client=JaxClient)
    _join(thread)
    want = jdt.Defer(config=jdt.DeferConfig(microbatch=1, chunk=4)).run(
        jg, np_params, np.stack(xs), num_stages=4)
    got = np.stack(outs)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= CROSS_RTOL * np.abs(want).max()


@pytest.mark.timeout(180)
def test_ports_client_through_the_jax_endpoint(crossed):
    jg, np_params, tg, params = crossed
    address, thread = jdt.Defer(config=jdt.DeferConfig(
        microbatch=1, chunk=4)).serve_endpoint(jg, np_params, num_stages=4)
    xs = _xs(6, 6)
    outs = _stream(address, xs)
    _join(thread, 120)
    want = _defer().run(tg, params, np.stack(xs), num_stages=4)
    got = np.stack(outs)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= CROSS_RTOL * np.abs(want).max()
