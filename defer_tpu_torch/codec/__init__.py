"""Host-side codecs for the host edge of the pipeline: the port of
``defer_tpu.codec``.

The reference compresses every payload with ``lz4(zfp(array))``
(reference src/dispatcher.py:81-82, src/node.py:76-77).  Stage-to-stage
hops on the card use no codec (the int8 wire is the on-device analogue);
the host edge (streaming ingest and egress, weight shipping) uses
first-party native codecs from ``csrc/codec.cpp``: ``blockfloat`` (a
fixed-rate shared-exponent float codec, a ZFP-fixed-rate analogue) and
``lzb`` (an LZ77 byte compressor, an LZ4 analogue), composed the way the
reference composes ZFP then LZ4.  The formats are byte-identical to the
JAX package's.

The C++ library is compiled with g++ at first use; without a toolchain a
NumPy implementation of the identical formats runs instead, so the API
never changes behavior — only speed.  ``native_available()`` says which.
"""

from .codecs import (BlockFloatCodec, Codec, LosslessCodec, PipelineCodec,
                     RawCodec, native_available)

__all__ = ["Codec", "BlockFloatCodec", "LosslessCodec", "PipelineCodec",
           "RawCodec", "native_available"]
