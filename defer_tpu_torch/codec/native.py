"""ctypes loader for the port's native codec library.

Builds ``csrc/codec.cpp`` with g++ at first use (``ops/_build.py``
``build_host``, into ``defer_tpu_torch/_build/``; plain C ABI via ctypes).
Returns None when it cannot be built or loaded; the codecs then run the
NumPy implementation of the identical wire formats.
"""

from __future__ import annotations

import ctypes
import threading

_lock = threading.Lock()
_lib = None
_tried = False


def load():
    """The loaded ctypes library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        from ..ops._build import build_host
        try:
            lib = ctypes.CDLL(str(build_host("codec.cpp")["path"]))
        except (OSError, RuntimeError):
            return None
        c_i64, c_int = ctypes.c_int64, ctypes.c_int
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.bf_max_compressed_size.restype = c_i64
        lib.bf_max_compressed_size.argtypes = [c_i64, c_int]
        lib.bf_compress.restype = c_i64
        lib.bf_compress.argtypes = [f32p, c_i64, c_int, u8p]
        lib.bf_decompress.restype = c_i64
        lib.bf_decompress.argtypes = [u8p, c_i64, f32p]
        lib.bf_peek_count.restype = c_i64
        lib.bf_peek_count.argtypes = [u8p, c_i64]
        lib.lzb_max_compressed_size.restype = c_i64
        lib.lzb_max_compressed_size.argtypes = [c_i64]
        lib.lzb_compress.restype = c_i64
        lib.lzb_compress.argtypes = [u8p, c_i64, u8p]
        lib.lzb_decompressed_size.restype = c_i64
        lib.lzb_decompressed_size.argtypes = [u8p, c_i64]
        lib.lzb_decompress.restype = c_i64
        lib.lzb_decompress.argtypes = [u8p, c_i64, u8p, c_i64]
        _lib = lib
        return _lib
