"""Port parity: ``defer_tpu_torch.transport.staging.HostStagingRing``.

The scenarios of ``tests/test_staging.py``'s ring tests on the port's ring
(native, from ``defer_tpu_torch/csrc/staging.cpp``, and the Python
fallback), plus what the port adds: ``pop_block`` into a caller's tensor
(page-locked on the card) and its checks.  Blocks are compared exactly.
The endpoint built on the ring is ``tests/test_torch_endpoint.py``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from defer_tpu.transport.staging import HostStagingRing as JaxRing
from defer_tpu_torch.ops import _build
from defer_tpu_torch.transport import staging
from defer_tpu_torch.transport.staging import HostStagingRing


def test_native_library_builds_from_the_ports_own_source():
    lib = staging._load()
    assert lib is not None
    path = _build.build_host("staging.cpp")["path"]
    assert lib._name == str(path) and path.parent == _build.BUILD_DIR
    assert HostStagingRing(4, 2).is_native


@pytest.mark.timeout(30)
@pytest.mark.parametrize("native", [True, False])
def test_ring_push_pop_layout(native, monkeypatch):
    if not native:
        monkeypatch.setattr(staging, "_load", lambda: None)
    ring = HostStagingRing(slot_elems=8, n_slots=4)
    assert ring.is_native == native
    ring.push(np.arange(5, dtype=np.float32))        # short: zero-padded
    ring.push(np.arange(8, dtype=np.float32) + 100)  # exact size
    assert ring.depth == 2
    got, block = ring.pop_block(4)
    assert got == 2 and block.shape == (4, 8)
    np.testing.assert_array_equal(block[0], [0, 1, 2, 3, 4, 0, 0, 0])
    np.testing.assert_array_equal(block[1], np.arange(8) + 100)
    np.testing.assert_array_equal(block[2:], 0)      # bubble tail
    with pytest.raises(ValueError, match="exceeds slot"):
        ring.push(np.zeros(9, np.float32))


@pytest.mark.timeout(30)
@pytest.mark.parametrize("native", [True, False])
def test_blocks_equal_the_jax_rings(native, monkeypatch):
    """The same pushes give the same blocks as the JAX package's ring."""
    if not native:
        monkeypatch.setattr(staging, "_load", lambda: None)
    rng = np.random.default_rng(0)
    samples = [rng.standard_normal(rng.integers(1, 13)).astype(np.float32)
               for _ in range(7)]
    ours, theirs = HostStagingRing(12, 8), JaxRing(12, 8)
    for s in samples:
        ours.push(s)
        theirs.push(s)
    for _ in range(2):
        a, b = ours.pop_block(4), theirs.pop_block(4)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.timeout(30)
@pytest.mark.parametrize("native", [True, False])
def test_pop_into_a_callers_tensor(native, monkeypatch):
    if not native:
        monkeypatch.setattr(staging, "_load", lambda: None)
    ring = HostStagingRing(slot_elems=6, n_slots=4)
    out = torch.full((3, 6), 7.0)
    ring.push(np.ones(6, np.float32))
    got, block = ring.pop_block(3, out=out)
    assert got == 1 and block is out
    assert torch.equal(out[0], torch.ones(6))
    assert torch.equal(out[1:], torch.zeros(2, 6))  # bubbles overwrite
    ring.push(np.ones(6, np.float32))
    for bad in (torch.zeros(2, 6), torch.zeros(3, 6, dtype=torch.float64),
                torch.zeros(6, 3).t(), np.zeros((3, 5), np.float32)):
        with pytest.raises(ValueError, match="out must be"):
            ring.pop_block(3, out=bad)
    assert ring.depth == 1  # a refused block pops nothing


@pytest.mark.timeout(30)
@pytest.mark.parametrize("native", [True, False])
def test_ring_close_drain_and_timeout(native, monkeypatch):
    if not native:
        monkeypatch.setattr(staging, "_load", lambda: None)
    ring = HostStagingRing(slot_elems=4, n_slots=2)
    ring.push(np.ones(4, np.float32))
    ring.close()
    got, _ = ring.pop_block(2)
    assert got == 1                       # backlog drains after close
    got, block = ring.pop_block(2)
    assert got == 0 and block is None     # then end-of-stream
    with pytest.raises(ValueError, match="closed"):
        ring.push(np.ones(4, np.float32))
    with pytest.raises(TimeoutError):
        HostStagingRing(slot_elems=4, n_slots=2).pop_block(1, timeout_s=0.05)


@pytest.mark.timeout(30)
@pytest.mark.parametrize("native", [True, False])
def test_ring_backpressure_blocks_producer(native, monkeypatch):
    if not native:
        monkeypatch.setattr(staging, "_load", lambda: None)
    ring = HostStagingRing(slot_elems=4, n_slots=2)
    assert ring.push(np.ones(4, np.float32), timeout_s=1.0)
    assert ring.push(np.ones(4, np.float32), timeout_s=1.0)
    t0 = time.perf_counter()
    assert not ring.push(np.ones(4, np.float32), timeout_s=0.2)  # timeout
    assert 0.15 < time.perf_counter() - t0 < 5.0

    def drain():
        time.sleep(0.2)
        ring.pop_block(2)

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    assert ring.push(np.ones(4, np.float32), timeout_s=5.0)  # unblocked
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.timeout(60)
def test_many_producers_one_consumer():
    """Four producers against one consumer with a shortened switch
    interval: every sample arrives exactly once."""
    import sys

    ring = HostStagingRing(slot_elems=2, n_slots=4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def produce(p):
            for i in range(200):
                assert ring.push(np.array([p, i], np.float32), timeout_s=10)

        ts = [threading.Thread(target=produce, args=(p,), daemon=True)
              for p in range(4)]
        for t in ts:
            t.start()
        seen = []
        while len(seen) < 800:
            got, block = ring.pop_block(3, timeout_s=10)
            seen.extend(map(tuple, block[:got].astype(int).tolist()))
        for t in ts:
            t.join(timeout=10)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert sorted(seen) == [(p, i) for p in range(4) for i in range(200)]
    for p in range(4):  # each producer's samples stay in its order
        assert [i for q, i in seen if q == p] == list(range(200))
