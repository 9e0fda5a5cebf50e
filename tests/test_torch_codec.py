"""Port parity: ``defer_tpu_torch.codec`` against the JAX package's codecs.

The scenarios of ``tests/test_codec.py`` on both of the port's backends
(the native library built from ``defer_tpu_torch/csrc/codec.cpp``, and
NumPy), plus the cross-package contract: ``BFC1`` and ``LZB1`` payloads are
byte-identical to the JAX package's, and each package decodes the other's.

Tolerances: blockfloat's error is at most half a step of its block,
2^e / (2 qmax) with qmax = 2^(bits-1) - 1 and 2^e <= 2 max|x| — so at most
max|x| / qmax (1/127 of the block max at 8 bits), plus 1e-7 absolute.  The
JAX package's docstring says 2^-(bits-1) (1/128); a block whose max is a
power of two reaches 1/127 (``test_blockfloat_bound_is_one_step_of_qmax``).
Lossless and cross-package results are exact.
"""

import os
import time

import numpy as np
import pytest

from defer_tpu import codec as jc
from defer_tpu_torch import codec as tc
from defer_tpu_torch.ops import _build

RNG = np.random.RandomState(42)
BACKENDS = [False, True]  # force_numpy


def bf_bound(x, bits):
    """blockfloat's error bound: max|x| / (2^(bits-1) - 1), plus 1e-7."""
    return np.abs(x).max() / ((1 << (bits - 1)) - 1) + 1e-7


def test_native_library_builds_from_the_ports_own_source():
    assert tc.native_available(), "g++ is present; the native codec loads"
    from defer_tpu_torch.codec import native
    path = _build.build_host("codec.cpp")["path"]
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdefercodec-")
    assert native.load()._name == str(path)


@pytest.mark.parametrize("force_numpy", BACKENDS)
def test_blockfloat_roundtrip_error_bound(force_numpy):
    c = tc.BlockFloatCodec(bits=8, force_numpy=force_numpy)
    x = RNG.randn(3, 57, 11).astype(np.float32) * 10
    data = c.encode(x)
    y = c.decode(data, x.shape)
    assert np.abs(x - y).max() <= bf_bound(x, c.bits)
    assert len(data) < x.nbytes * (c.bits / 32.0) * 1.2 + 64


@pytest.mark.parametrize("bits", [2, 7, 8, 12, 24])
@pytest.mark.parametrize("jax_native", [True, False])
def test_blockfloat_byte_identical_to_jax(bits, jax_native):
    """Both port backends encode the JAX package's bytes, and each package
    decodes the other's payload to the same values."""
    x = (np.random.default_rng(bits).standard_normal(1000) *
         np.exp(np.random.default_rng(1).uniform(-8, 8, 1000))).astype(
        np.float32)
    jcodec = jc.BlockFloatCodec(bits=bits, force_numpy=not jax_native)
    want = jcodec.encode(x)
    for force_numpy in BACKENDS:
        pc = tc.BlockFloatCodec(bits=bits, force_numpy=force_numpy)
        got = pc.encode(x)
        assert got == want
        np.testing.assert_array_equal(pc.decode(want, x.shape),
                                      jcodec.decode(got, x.shape))


@pytest.mark.parametrize("force_numpy", BACKENDS)
def test_blockfloat_edge_cases(force_numpy):
    c = tc.BlockFloatCodec(bits=8, force_numpy=force_numpy)
    j = jc.BlockFloatCodec(bits=8)
    for x in [np.zeros((64,), np.float32),
              np.zeros((0,), np.float32),
              np.array([1e-30, -1e30, 0, np.inf, -np.inf, np.nan],
                       np.float32),
              np.full((65,), 7.25, np.float32)]:
        data = c.encode(x)
        assert data == j.encode(x)
        y = c.decode(data, x.shape)
        assert y.shape == x.shape
        assert np.isfinite(y).all()  # non-finite values flush to 0
        if np.isfinite(x).all() and x.size:
            assert np.abs(x - y).max() <= bf_bound(x, 8)


@pytest.mark.parametrize("force_numpy", BACKENDS)
def test_blockfloat_extreme_exponents(force_numpy):
    """Exponent-byte saturation: huge values clamp toward 2^127, subnormal
    blocks flush toward 0 — never wrap — in the JAX package's bytes."""
    c = tc.BlockFloatCodec(bits=8, force_numpy=force_numpy)
    j = jc.BlockFloatCodec(bits=8)
    huge = np.full((64,), 3e38, np.float32)
    assert c.decode(c.encode(huge), huge.shape).max() > 1e38
    tiny = np.full((64,), 1e-40, np.float32)
    assert np.abs(c.decode(c.encode(tiny), tiny.shape)).max() < 1e-30
    for x in (huge, tiny, np.array([2.0**-130, 2.0**127], np.float32)):
        assert c.encode(x) == j.encode(x)


@pytest.mark.parametrize("force_numpy", BACKENDS)
def test_lossless_roundtrip(force_numpy):
    c = tc.LosslessCodec(force_numpy=force_numpy)
    for x in [RNG.randint(0, 255, 10_000).astype(np.uint8),
              np.tile(np.arange(100, dtype=np.int32), 50),
              RNG.randn(999).astype(np.float32),
              np.zeros((4096,), np.float32)]:
        np.testing.assert_array_equal(c.decode(c.encode(x), x.shape,
                                               x.dtype), x)


@pytest.mark.parametrize("force_numpy", BACKENDS)
def test_lzb_byte_identical_to_jax(force_numpy):
    rng = np.random.default_rng(5)
    c = tc.LosslessCodec(force_numpy=force_numpy)
    for jax_native in (True, False):
        j = jc.LosslessCodec(force_numpy=not jax_native)
        for x in (np.tile(rng.integers(0, 9, 100).astype(np.uint8), 30),
                  np.frombuffer(b"the quick brown fox " * 200, np.uint8),
                  rng.standard_normal(777).astype(np.float32),
                  np.zeros(5000, np.int16)):
            got = c.encode(x)
            assert got == j.encode(x)
            np.testing.assert_array_equal(j.decode(got, x.shape, x.dtype), x)
            np.testing.assert_array_equal(
                c.decode(j.encode(x), x.shape, x.dtype), x)


def test_lzb_compresses_redundancy():
    c = tc.LosslessCodec()
    assert len(c.encode(np.zeros((100_000,), np.uint8))) < 3000
    text = np.frombuffer(b"the quick brown fox " * 500, np.uint8)
    assert len(c.encode(text)) < text.size // 5


@pytest.mark.parametrize("force_numpy", BACKENDS)
def test_pipeline_codec_stack_byte_identical(force_numpy):
    """lz(blockfloat(x)), the reference's ZFP+LZ4 stack, symmetric."""
    c = tc.PipelineCodec(bits=8, force_numpy=force_numpy)
    j = jc.PipelineCodec(bits=8)
    x = RNG.randn(32, 56, 56).astype(np.float32)
    data = c.encode(x)
    assert data == j.encode(x)
    y = c.decode(data, x.shape)
    assert np.abs(x - y).max() <= bf_bound(x, 8)
    np.testing.assert_array_equal(y, j.decode(data, x.shape))


@pytest.mark.parametrize("force_numpy", BACKENDS)
@pytest.mark.parametrize("bits", [4, 8, 12])
def test_blockfloat_bound_is_one_step_of_qmax(force_numpy, bits):
    """A block of 1.0s: exponent 1, 1.0 lands on half a step and rounds
    away, an error of exactly 1/qmax — above the 2^-(bits-1) the JAX
    package's docstring states, and at the bound the port states."""
    c = tc.BlockFloatCodec(bits=bits, force_numpy=force_numpy)
    x = np.ones(64, np.float32)
    err = np.abs(c.decode(c.encode(x), x.shape) - x).max()
    qmax = (1 << (bits - 1)) - 1
    assert err > 2.0 ** -(bits - 1)
    assert err == pytest.approx(1 / qmax, rel=1e-6)
    assert err <= bf_bound(x, bits)


@pytest.mark.parametrize("force_numpy", BACKENDS)
def test_corrupt_payloads_rejected(force_numpy):
    with pytest.raises(ValueError):
        tc.PipelineCodec(force_numpy=force_numpy).decode(b"garbage!", (2,))
    with pytest.raises(ValueError):
        tc.BlockFloatCodec(force_numpy=force_numpy).decode(
            b"NOPE" + b"\x00" * 20, (2,))
    with pytest.raises(ValueError):
        tc.LosslessCodec(force_numpy=force_numpy).decode(
            b"LZB1\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff", (2,), np.uint8)


def test_raw_codec():
    c = tc.RawCodec()
    x = RNG.randn(5, 5).astype(np.float32)
    assert c.encode(x) == jc.RawCodec().encode(x)
    np.testing.assert_array_equal(c.decode(c.encode(x), x.shape, x.dtype), x)


@pytest.mark.parametrize("force_numpy", BACKENDS)
def test_hostile_size_headers_rejected_before_allocating(force_numpy):
    bomb_bf = (b"BFC1" + (2 ** 40).to_bytes(8, "little")
               + bytes([8, 0, 0, 0]))
    with pytest.raises(ValueError):
        tc.BlockFloatCodec(bits=8, force_numpy=force_numpy).decode(
            bomb_bf, (64,))
    c = tc.LosslessCodec(force_numpy=force_numpy)
    with pytest.raises(ValueError):
        c.decode(c.encode(np.zeros(64, np.uint8)), (2 ** 40,), np.uint8)


def test_lzb_expansion_worst_case_bound():
    """Alternating [len-4 match at long distance][1-byte literal] expands
    to ~1.2x the input: both backends stay inside the bound, agree with
    each other and with the JAX package byte for byte, and round-trip."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, 60000, dtype=np.uint8).tobytes()
    b = bytearray(a)
    for k in range(0, len(b), 5):
        b[k] = (b[k] + 1) % 256
    payload = np.frombuffer(a + bytes(b), np.uint8)
    native, py = tc.LosslessCodec(), tc.LosslessCodec(force_numpy=True)
    enc = native.encode(payload)
    assert enc == py.encode(payload) == jc.LosslessCodec().encode(payload)
    n = payload.size
    assert len(enc) > n + n // 128 + 24
    for codec in (native, py):
        np.testing.assert_array_equal(
            codec.decode(enc, payload.shape, payload.dtype), payload)


def test_build_host_contract(tmp_path, monkeypatch):
    """The host build: builds when missing, reuses a library whose source
    and flags are unchanged, builds an edited source under a new name,
    and raises (leaving no temporary file) when g++ fails."""
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "m.cpp"
    src.write_text('extern "C" int f() { return 1; }\n')
    first = _build.build_host("m.cpp")
    assert first["path"].exists() and first["seconds"] > 0
    again = _build.build_host("m.cpp")
    assert again == {"path": first["path"], "seconds": 0.0}
    mtime = first["path"].stat().st_mtime_ns
    time.sleep(0.01)
    src.write_text('extern "C" int f() { return 2; }\n')
    edited = _build.build_host("m.cpp")
    assert edited["path"] != first["path"]
    assert first["path"].stat().st_mtime_ns == mtime
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.build_host("m.cpp")
    assert not [p for p in os.listdir(tmp_path / "build") if ".tmp" in p]


def test_no_toolchain_falls_back_to_numpy(monkeypatch):
    """Without a library the codecs run the NumPy formats (same bytes)."""
    from defer_tpu_torch.codec import native
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_lib", None)
    assert not tc.native_available()
    x = RNG.randn(300).astype(np.float32)
    assert tc.PipelineCodec().encode(x) == jc.PipelineCodec().encode(x)
