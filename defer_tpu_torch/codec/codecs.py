"""Codec implementations: native-backed with NumPy fallbacks.

The port of ``defer_tpu.codec.codecs``.  Formats are defined by
``csrc/codec.cpp`` (blockfloat ``BFC1`` and lzb ``LZB1``, a copy of the
JAX package's); the NumPy paths implement the identical wire formats, so
payloads are interchangeable between backends and between the packages.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native

BF_BLOCK = 64


def native_available() -> bool:
    return native.load() is not None


class Codec:
    """encode(array) -> (payload bytes, metadata); decode inverts it.

    The role ``_comp``/``_decomp`` play in the reference
    (src/dispatcher.py:81-84, src/node.py:76-79), as an explicit interface.
    """

    name = "codec"

    def encode(self, arr: np.ndarray) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes, shape, dtype) -> np.ndarray:
        raise NotImplementedError


class RawCodec(Codec):
    """Identity codec (the ICI path: no host-side compression at all)."""

    name = "raw"

    def encode(self, arr):
        return np.ascontiguousarray(arr).tobytes()

    def decode(self, data, shape, dtype):
        return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


# ---------------------------------------------------------------------------
# blockfloat
# ---------------------------------------------------------------------------


def _bf_compress_np(x: np.ndarray, bits: int) -> bytes:
    """NumPy implementation of the BFC1 format (see codec.cpp)."""
    n = x.size
    if n == 0:
        return b"BFC1" + (0).to_bytes(8, "little") + bytes([bits, 0, 0, 0])
    flat = np.ascontiguousarray(x, np.float32).ravel()
    flat = np.where(np.isfinite(flat), flat, 0.0).astype(np.float32)
    nblocks = (n + BF_BLOCK - 1) // BF_BLOCK
    padded = np.zeros(nblocks * BF_BLOCK, np.float32)
    padded[:n] = flat
    blocks = padded.reshape(nblocks, BF_BLOCK)

    amax = np.abs(blocks).max(axis=1)
    # frexp: amax = m * 2^e with m in [0.5, 1); e = 0 where amax == 0
    _, e = np.frexp(amax)
    # clamp so the biased exponent byte can't wrap (mirrors codec.cpp)
    e = np.clip(e, -127, 127)
    qmax = (1 << (bits - 1)) - 1
    # float64: 2^127 * qmax overflows float32 (mirrors codec.cpp)
    scale = np.ldexp(np.float64(1.0), -e) * qmax
    v = blocks.astype(np.float64) * scale[:, None]
    # lround semantics: round half away from zero
    q = np.sign(v) * np.floor(np.abs(v) + 0.5)
    q = np.clip(q, -qmax, qmax).astype(np.int64)
    u = (q + qmax).astype(np.uint32)

    # LSB-first bit stream per block, packed to bytes
    bit_idx = np.arange(bits, dtype=np.uint32)
    ubits = ((u[:, :, None] >> bit_idx[None, None, :]) & 1).astype(np.uint8)
    payload = np.packbits(ubits.reshape(nblocks, -1), axis=1,
                          bitorder="little")

    header = b"BFC1" + int(n).to_bytes(8, "little") + bytes([bits, 0, 0, 0])
    if nblocks:
        body = np.concatenate(
            [(e + 128).astype(np.uint8)[:, None], payload], axis=1).ravel()
    else:
        body = np.zeros(0, np.uint8)
    return header + body.tobytes()


def _bf_decompress_np(data: bytes) -> np.ndarray:
    if len(data) < 16 or data[:4] != b"BFC1":
        raise ValueError("not a BFC1 payload")
    n = int.from_bytes(data[4:12], "little")
    bits = data[12]
    qmax = (1 << (bits - 1)) - 1
    nblocks = (n + BF_BLOCK - 1) // BF_BLOCK
    payload_len = (BF_BLOCK * bits + 7) // 8
    body = np.frombuffer(data, np.uint8, offset=16).reshape(
        nblocks, 1 + payload_len)
    e = body[:, 0].astype(np.int64) - 128
    bits_arr = np.unpackbits(body[:, 1:], axis=1, bitorder="little")
    bits_arr = bits_arr[:, : BF_BLOCK * bits].reshape(nblocks, BF_BLOCK, bits)
    u = (bits_arr.astype(np.uint32)
         << np.arange(bits, dtype=np.uint32)[None, None, :]).sum(axis=2)
    q = u.astype(np.int64) - qmax
    inv = np.ldexp(np.float64(1.0), e) / qmax
    out = (q * inv[:, None]).astype(np.float32).ravel()
    return out[:n]


class BlockFloatCodec(Codec):
    """Fixed-rate lossy float codec (ZFP-fixed-rate analogue).

    ``bits`` mantissa bits per value + 1 shared exponent byte per 64 values:
    rate = bits/value + 0.125, error <= the block max / (2^(bits-1) - 1)
    (half a step of 2^e / qmax, with 2^e <= twice the block max; a block
    whose max is a power of two reaches it).  bits=8 roughly matches bf16 mantissa fidelity at half the size of
    f32.
    """

    name = "blockfloat"

    def __init__(self, bits: int = 8, force_numpy: bool = False):
        if not 2 <= bits <= 24:
            raise ValueError("bits must be in [2, 24]")
        self.bits = bits
        self._lib = None if force_numpy else native.load()

    def encode(self, arr):
        x = np.ascontiguousarray(arr, np.float32)
        if self._lib is None:
            return _bf_compress_np(x, self.bits)
        lib = self._lib
        cap = lib.bf_max_compressed_size(x.size, self.bits)
        out = np.empty(cap, np.uint8)
        written = lib.bf_compress(
            x.ravel().ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            x.size, self.bits,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if written < 0:
            raise ValueError("bf_compress failed")
        return out[:written].tobytes()

    def decode(self, data, shape, dtype=np.float32):
        expected = int(np.prod(shape, dtype=np.int64))
        if self._lib is None:
            flat = _bf_decompress_np(data)
            if flat.size != expected:
                raise ValueError(
                    f"BFC1 payload declares {flat.size} values, "
                    f"expected {expected}")
        else:
            lib = self._lib
            buf = np.frombuffer(data, np.uint8)
            n = lib.bf_peek_count(
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size)
            if n < 0:
                raise ValueError("not a BFC1 payload")
            if n != expected:
                # validate the header count against the caller's shape BEFORE
                # allocating: a corrupt/hostile 20-byte payload could other-
                # wise declare a multi-terabyte output
                raise ValueError(
                    f"BFC1 payload declares {n} values, expected {expected}")
            flat = np.empty(n, np.float32)
            got = lib.bf_decompress(
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if got != n:
                raise ValueError("bf_decompress failed")
        return flat.reshape(shape).astype(dtype)


# ---------------------------------------------------------------------------
# lzb (LZ77) — byte-level, layered over blockfloat by PipelineCodec
# ---------------------------------------------------------------------------

_LZB_MIN_MATCH = 4


def _put_varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _get_varint(data: bytes, i: int) -> tuple[int, int]:
    r, shift = 0, 0
    while True:
        b = data[i]
        i += 1
        r |= (b & 0x7F) << shift
        if not b & 0x80:
            return r, i
        shift += 7
        if shift > 63:
            raise ValueError("varint overflow")


def _lzb_compress_py(src: bytes) -> bytes:
    """Python mirror of lzb_compress (greedy hash-head matcher)."""
    n = len(src)
    out = bytearray(b"LZB1")
    out += _put_varint(n)
    head: dict[int, int] = {}
    i = lit_start = 0

    def flush(upto: int):
        nonlocal lit_start
        while lit_start < upto:
            take = min(upto - lit_start, 128)
            out.append(take - 1)
            out.extend(src[lit_start:lit_start + take])
            lit_start += take

    while i + _LZB_MIN_MATCH <= n:
        # the SAME 16-bit multiplicative hash as the native matcher
        # (codec.cpp lzb_hash), so both backends pick identical match
        # candidates — including collisions — and emit identical streams
        v = int.from_bytes(src[i:i + 4], "little")
        key = ((v * 2654435761) & 0xFFFFFFFF) >> 16
        cand = head.get(key, -1)
        head[key] = i
        if cand >= 0 and i - cand <= 0xFFFF \
                and src[cand:cand + 4] == src[i:i + 4]:
            length = _LZB_MIN_MATCH
            maxlen = min(n - i, 127 + _LZB_MIN_MATCH)
            while length < maxlen and src[cand + length] == src[i + length]:
                length += 1
            flush(i)
            out.append(0x80 | (length - _LZB_MIN_MATCH))
            out += _put_varint(i - cand)
            i += length
            lit_start = i
        else:
            i += 1
    flush(n)
    return bytes(out)


def _lzb_decompress_py(data: bytes) -> bytes:
    if len(data) < 5 or data[:4] != b"LZB1":
        raise ValueError("not an LZB1 payload")
    n, i = _get_varint(data, 4)
    out = bytearray()
    while len(out) < n:
        c = data[i]
        i += 1
        if c & 0x80:
            length = (c & 0x7F) + _LZB_MIN_MATCH
            dist, i = _get_varint(data, i)
            if dist == 0 or dist > len(out):
                raise ValueError("corrupt match")
            for _ in range(length):  # overlap-safe byte-by-byte
                out.append(out[-dist])
        else:
            length = c + 1
            out += data[i:i + length]
            i += length
    if len(out) != n:
        raise ValueError("corrupt stream")
    return bytes(out)


def _lzb_compress(data: bytes, lib) -> bytes:
    if lib is None:
        return _lzb_compress_py(data)
    src = np.frombuffer(data, np.uint8)
    cap = lib.lzb_max_compressed_size(src.size)
    out = np.empty(cap, np.uint8)
    written = lib.lzb_compress(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if written < 0:
        raise ValueError("lzb_compress failed")
    if written > cap:  # the bound is the memory-safety contract: a
        # breach means the heap is already overrun — fail IMMEDIATELY
        # and loudly instead of aborting at some later malloc (the r5
        # 12.8 MB activation-payload failure mode)
        raise RuntimeError(
            f"lzb_compress wrote {written} > capacity {cap}: "
            f"lzb_max_compressed_size bound violated")
    return out[:written].tobytes()


def _lzb_decompress(data: bytes, lib, expected: int | None = None) -> bytes:
    if lib is None:
        if expected is not None:
            # validate the declared size BEFORE decompressing — a hostile
            # ~30-byte header must not drive an unbounded output loop
            if len(data) < 5 or data[:4] != b"LZB1":
                raise ValueError("not an LZB1 payload")
            n, _ = _get_varint(data, 4)
            if n != expected:
                raise ValueError(
                    f"LZB1 payload declares {n} bytes, expected {expected}")
        out = _lzb_decompress_py(data)
        if expected is not None and len(out) != expected:
            raise ValueError(
                f"LZB1 payload is {len(out)} bytes, expected {expected}")
        return out
    src = np.frombuffer(data, np.uint8)
    n = lib.lzb_decompressed_size(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size)
    if n < 0:
        raise ValueError("not an LZB1 payload")
    if expected is not None and n != expected:
        # bound the allocation by what the caller expects — a hostile header
        # must not pick the output size
        raise ValueError(
            f"LZB1 payload declares {n} bytes, expected {expected}")
    out = np.empty(n, np.uint8)
    got = lib.lzb_decompress(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)
    if got != n:
        raise ValueError("lzb_decompress failed")
    return out.tobytes()


class PipelineCodec(Codec):
    """blockfloat + lzb composition — the reference's ``lz4(zfp(arr))``
    stack (src/dispatcher.py:82) as one symmetric codec (the reference's
    decode sides are asymmetric/buggy; see SURVEY.md §3.5)."""

    name = "blockfloat+lzb"

    def __init__(self, bits: int = 8, force_numpy: bool = False):
        self._bf = BlockFloatCodec(bits, force_numpy)
        self._lib = None if force_numpy else native.load()

    def encode(self, arr):
        return _lzb_compress(self._bf.encode(arr), self._lib)

    def decode(self, data, shape, dtype=np.float32):
        n = int(np.prod(shape, dtype=np.int64))
        nblocks = (n + BF_BLOCK - 1) // BF_BLOCK
        expected = 16 + nblocks * (1 + (BF_BLOCK * self._bf.bits + 7) // 8)
        return self._bf.decode(
            _lzb_decompress(data, self._lib, expected=expected), shape, dtype)


class LosslessCodec(Codec):
    """lzb over raw bytes: lossless path for weights/ints (any dtype)."""

    name = "lzb"

    def __init__(self, force_numpy: bool = False):
        self._lib = None if force_numpy else native.load()

    def encode(self, arr):
        return _lzb_compress(np.ascontiguousarray(arr).tobytes(), self._lib)

    def decode(self, data, shape, dtype):
        expected = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        raw = _lzb_decompress(data, self._lib, expected=expected)
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
