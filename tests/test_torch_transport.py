"""Port parity: ``defer_tpu_torch.transport.framed`` and ``.channel``.

The scenarios of ``tests/test_transport.py`` and of
``tests/test_channel.py``'s channel tests, on the port, plus the
cross-package wire contract: a frame sent by one package is byte-identical
to the other's and decodes in the other, for the ``raw``, ``lzb`` and
``bf8`` codecs, for float32 and — without ``ml_dtypes`` on the port's
side — bfloat16 (a ``torch.bfloat16`` tensor in the port, an ``ml_dtypes``
array in the JAX package), and for v2's sequence-stamped frames.

Tolerances: raw and lzb frames are exact; bf8 is blockfloat's bound at 8
bits (block max / 127, ``tests/test_torch_codec.py``); the remote edge's
pipeline results are held to the forward at 2e-3, as the JAX test holds
its.  Every test
joins its threads with a bound and carries its own time limit.
"""

import socket
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from defer_tpu.transport import framed as jf
from defer_tpu_torch import Defer, DeferConfig, models
from defer_tpu_torch.obs import REGISTRY
from defer_tpu_torch.transport import framed as tf
from defer_tpu_torch.transport.channel import (AsyncReceiver, AsyncSender,
                                               ChannelError)

torch.set_num_threads(1)


def _wire_bytes(send, *args, **kw) -> bytes:
    """Everything one ``send(sock, ...)`` call puts on a socket."""
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=send, args=(a, *args), kwargs=kw,
                             daemon=True)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        a.close()
        chunks = []
        while True:
            got = b.recv(1 << 20)
            if not got:
                return b"".join(chunks)
            chunks.append(got)
    finally:
        b.close()


def _decode(recv, data: bytes):
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=a.sendall, args=(data,), daemon=True)
        t.start()
        out = recv(b)
        t.join(timeout=30)
        return out
    finally:
        a.close()
        b.close()


@pytest.mark.timeout(60)
def test_frame_roundtrip_socketpair():
    a, b = socket.socketpair()
    try:
        x = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
        tf.send_frame(a, x)
        kind, y = tf.recv_frame(b)
        assert kind == tf.K_TENSOR and y.dtype == np.int16
        np.testing.assert_array_equal(x, y)
        tf.send_frame(a, b"\x00\x01hello")
        assert tf.recv_frame(b) == (tf.K_BYTES, b"\x00\x01hello")
        # a frame larger than the kernel buffer, sent from a thread
        big = np.random.RandomState(0).randn(300_000).astype(np.float32)
        sender = threading.Thread(target=tf.send_frame, args=(a, big),
                                  kwargs={"codec": "bf8"}, daemon=True)
        sender.start()
        _, got = tf.recv_frame(b)
        sender.join(timeout=30)
        assert not sender.is_alive()
        assert np.abs(big - got).max() <= np.abs(big).max() / 127
        tf.send_end(a)
        assert tf.recv_frame(b) == (tf.K_END, None)
    finally:
        a.close()
        b.close()


@pytest.mark.timeout(30)
def test_truncated_frame_raises():
    a, b = socket.socketpair()
    a.sendall(b"\x01\x03")  # header cut short
    a.close()
    with pytest.raises(ConnectionError):
        tf.recv_frame(b)
    b.close()


#: the bench-only delay wrappers (``sleep``/``esleep``/``dsleep``) ride
#: the wire as the codec they wrap, under their own name
CODECS = ["raw", "lzb", "bf8", "sleep1+lzb", "esleep1+bf8", "dsleep1"]


@pytest.mark.timeout(60)
@pytest.mark.parametrize("codec", CODECS)
def test_f32_frames_byte_identical_across_packages(codec):
    x = np.random.default_rng(1).standard_normal((3, 5, 70)).astype(
        np.float32)
    port = _wire_bytes(tf.send_frame, x, codec=codec)
    assert port == _wire_bytes(jf.send_frame, x, codec=codec)
    kind, in_jax = _decode(jf.recv_frame, port)
    kind2, in_port = _decode(tf.recv_frame, port)
    assert kind == kind2 == tf.K_TENSOR
    assert in_port.dtype == in_jax.dtype == np.float32
    np.testing.assert_array_equal(in_port, in_jax)
    if "bf8" not in codec:
        np.testing.assert_array_equal(in_port, x)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("codec", CODECS)
def test_bf16_frames_byte_identical_across_packages(codec):
    """A ``torch.bfloat16`` tensor from the port and the same bits as an
    ``ml_dtypes`` array from the JAX package make the same frame; each
    package decodes the other's to the same bits."""
    t = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 300)).astype(np.float32)).to(torch.bfloat16)
    bits = t.view(torch.int16).numpy()
    arr = bits.view(ml_dtypes.bfloat16)
    port = _wire_bytes(tf.send_frame, t, codec=codec)
    assert port == _wire_bytes(jf.send_frame, arr, codec=codec)
    assert b"bfloat16" in port
    _, in_jax = _decode(jf.recv_frame, port)
    _, in_port = _decode(tf.recv_frame, _wire_bytes(jf.send_frame, arr,
                                                    codec=codec))
    assert in_port.dtype == torch.bfloat16 and in_jax.dtype.name == "bfloat16"
    np.testing.assert_array_equal(in_port.view(torch.int16).numpy(),
                                  np.asarray(in_jax).view(np.int16))
    if "bf8" not in codec:
        np.testing.assert_array_equal(in_port.view(torch.int16).numpy(), bits)


@pytest.mark.timeout(60)
def test_seq_ctrl_and_ack_frames_across_packages():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    port = _wire_bytes(tf.send_frame, x, codec="lzb", seq=2**40 + 3)
    assert port == _wire_bytes(jf.send_frame, x, codec="lzb", seq=2**40 + 3)
    kind, (seq, y) = _decode(tf.recv_frame, port)
    assert kind == tf.K_TENSOR_SEQ and seq == 2**40 + 3
    np.testing.assert_array_equal(y, x)
    msg = {"cmd": "reweight", "n": 3}
    assert _wire_bytes(tf.send_ctrl, msg) == _wire_bytes(jf.send_ctrl, msg)
    assert _decode(tf.recv_frame, _wire_bytes(jf.send_ctrl, msg)) == (
        tf.K_CTRL, msg)
    assert _wire_bytes(tf.send_ack) == _wire_bytes(jf.send_ack)
    with pytest.raises(ConnectionError, match="expected frame kind"):
        _decode(lambda s: tf.recv_expect(s, tf.K_ACK),
                _wire_bytes(jf.send_end))


@pytest.mark.timeout(30)
def test_wire_counters_and_unknown_codec():
    tx = REGISTRY.counter("transport.tx_bytes")
    before = tx.n
    data = _wire_bytes(tf.send_frame, np.zeros(10, np.float32))
    assert tx.n - before == len(data)
    a, b = socket.socketpair()
    try:
        with pytest.raises(ValueError, match="unknown codec"):
            tf.send_frame(a, np.zeros(3, np.float32), codec="zstd")
    finally:
        a.close()
        b.close()


@pytest.mark.timeout(120)
def test_remote_edge_end_to_end():
    """A client streams inputs to a pipeline host over TCP with the lossy
    codec; the host runs the port's ring pipeline and replies."""
    g = models.resnet_tiny()
    params = g.init(torch.Generator().manual_seed(0))
    pipe = Defer(DeferConfig(device="cpu", microbatch=1, chunk=2)).build(
        g, params, num_stages=2)
    server = tf.TensorServer()
    t = threading.Thread(target=server.serve_once,
                         kwargs={"handler": lambda x: pipe.run(x[None])[0],
                                 "codec": "raw"}, daemon=True)
    t.start()
    client = tf.TensorClient(*server.address)
    rng = np.random.RandomState(1)
    xs = [rng.randn(1, 32, 32, 3).astype(np.float32) for _ in range(3)]
    results = [client.infer(x, codec="bf12") for x in xs]
    client.close()
    t.join(timeout=30)
    assert not t.is_alive()
    server.close()
    with torch.inference_mode():
        for x, r in zip(xs, results):
            ref = g.apply(params, torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(r, ref, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# channels (the scenarios of tests/test_channel.py:29-190)


@pytest.mark.timeout(60)
def test_receiver_bounded_queue_applies_backpressure():
    a, b = socket.socketpair()
    try:
        rx = AsyncReceiver(b, depth=2)
        for i in range(5):
            tf.send_frame(a, np.full((4,), i, np.int32))
        tf.send_end(a)
        time.sleep(0.3)
        assert rx.qsize() <= 2
        got = []
        while True:
            kind, v = rx.get(timeout=5.0)
            if kind == tf.K_END:
                break
            got.append(int(v[0]))
        assert got == list(range(5))
    finally:
        a.close()
        b.close()


@pytest.mark.timeout(60)
def test_sender_bounded_queue_blocks_producer():
    a, b = socket.socketpair()
    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 16384)
        tx = AsyncSender(a, depth=2)
        big = np.zeros(1 << 18, np.float32)  # 1 MiB frames
        fed = []
        done = threading.Event()

        def feed():
            for i in range(6):
                tx.send(big)
                fed.append(i)
            done.set()

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        time.sleep(0.4)
        assert not done.is_set()
        assert len(fed) <= 4
        for _ in range(6):
            kind, _ = tf.recv_frame(b)
            assert kind == tf.K_TENSOR
        t.join(timeout=10)
        assert done.is_set()
    finally:
        a.close()
        b.close()


@pytest.mark.timeout(30)
def test_receiver_error_propagates_to_consumer():
    a, b = socket.socketpair()
    try:
        rx = AsyncReceiver(b, depth=4)
        a.sendall(b"\x01\x03")
        a.close()
        with pytest.raises(ConnectionError):
            rx.get(timeout=5.0)
    finally:
        b.close()


@pytest.mark.timeout(30)
def test_sender_error_propagates_and_unblocks_producer():
    a, b = socket.socketpair()
    b.close()
    try:
        tx = AsyncSender(a, depth=2)
        with pytest.raises((ChannelError, OSError)):
            for _ in range(200):
                tx.send(np.zeros(1024, np.float32))
                time.sleep(0.005)
        with pytest.raises((ChannelError, OSError)):
            tx.flush(timeout=5.0)
    finally:
        a.close()


@pytest.mark.timeout(60)
def test_in_order_delivery_under_load():
    a, b = socket.socketpair()
    try:
        tx = AsyncSender(a, depth=4, codec="lzb")
        rx = AsyncReceiver(b, depth=4)
        n = 300

        def feed():
            for i in range(n):
                tx.send(np.full((16,), i, np.int32))
            tx.send_end()

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        seqs = []
        while True:
            kind, v = rx.get(timeout=30.0)
            if kind == tf.K_END:
                break
            seqs.append(int(v[0]))
        t.join(timeout=10)
        assert not t.is_alive()
        assert seqs == list(range(n))
    finally:
        a.close()
        b.close()


@pytest.mark.timeout(30)
def test_sender_flush_completes_pending_writes():
    a, b = socket.socketpair()
    try:
        tx = AsyncSender(a, depth=8)
        for i in range(5):
            tx.send(np.full((8,), i, np.float32))
        got = []

        def drain():
            for _ in range(5):
                got.append(tf.recv_frame(b)[1])

        t = threading.Thread(target=drain, daemon=True)
        t.start()
        tx.flush(timeout=10.0)
        t.join(timeout=10)
        assert not t.is_alive()
        assert tx.qsize() == 0 and len(got) == 5
    finally:
        a.close()
        b.close()


@pytest.mark.timeout(60)
def test_port_channel_talks_to_jax_channel():
    """A port sender feeding a JAX receiver (and back) over one socket
    pair: the frames arrive in order and equal."""
    from defer_tpu.transport.channel import AsyncReceiver as JaxReceiver
    from defer_tpu.transport.channel import AsyncSender as JaxSender

    for send_cls, recv_cls in ((AsyncSender, JaxReceiver),
                               (JaxSender, AsyncReceiver)):
        a, b = socket.socketpair()
        try:
            tx, rx = send_cls(a, depth=4, codec="bf8"), recv_cls(b, depth=4)
            rng = np.random.default_rng(0)
            xs = [rng.standard_normal(70).astype(np.float32)
                  for _ in range(20)]
            for x in xs:
                tx.send(x)
            tx.close(timeout=10)
            for x in xs:
                kind, v = rx.get(timeout=10)
                assert kind == tf.K_TENSOR
                assert np.abs(v - x).max() <= np.abs(x).max() / 127
            assert rx.get(timeout=10)[0] == tf.K_END
        finally:
            a.close()
            b.close()
