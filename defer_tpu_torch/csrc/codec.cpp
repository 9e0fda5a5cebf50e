// defer_tpu_torch native host-side codec: a copy of the JAX package's
// defer_tpu/_native/codec.cpp, with the same code, so the two packages'
// BFC1 and LZB1 payloads are byte-identical.
//
// The reference compresses every payload with third-party native deps
// (zfpy/ZFP and lz4.frame — reference src/dispatcher.py:81-84,
// src/node.py:76-79).  Stage-to-stage hops on the card never touch this
// (activations stay in device memory), but the host edge still wants a
// real codec for streaming ingest/egress and weight shipping.  Two
// first-party codecs:
//
//  1. blockfloat: fixed-rate lossy float codec in the spirit of ZFP's
//     fixed-rate mode — blocks of 64 floats share one exponent byte, each
//     value stores a signed fixed-point mantissa of `bits` bits.  Rate and
//     error are strictly bounded, compression is branch-free and
//     vectorizable.
//  2. lzb: LZ77 byte compressor (greedy hash-chain match, 64KB window,
//     varint-framed literals/matches) layered over blockfloat the way LZ4
//     was layered over ZFP.  Self-describing frame, first-party format.
//
// C ABI only (ctypes-friendly).  Built with g++ at first use by
// defer_tpu_torch/ops/_build.py (build_host).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// blockfloat: shared-exponent fixed-rate float codec
// ---------------------------------------------------------------------------

static const int BF_BLOCK = 64;

// bytes needed for n floats at `bits` mantissa bits per value
int64_t bf_max_compressed_size(int64_t n, int bits) {
  int64_t nblocks = (n + BF_BLOCK - 1) / BF_BLOCK;
  int64_t payload = (static_cast<int64_t>(BF_BLOCK) * bits + 7) / 8;
  return 16 + nblocks * (1 + payload);  // header: magic, n, bits
}

// Compress n floats -> dst.  Returns bytes written, or -1 on error.
int64_t bf_compress(const float* src, int64_t n, int bits, uint8_t* dst) {
  if (bits < 2 || bits > 24 || n < 0) return -1;
  uint8_t* out = dst;
  std::memcpy(out, "BFC1", 4); out += 4;
  std::memcpy(out, &n, 8); out += 8;
  *out++ = static_cast<uint8_t>(bits);
  *out++ = 0; *out++ = 0; *out++ = 0;  // pad header to 16

  const int64_t nblocks = (n + BF_BLOCK - 1) / BF_BLOCK;
  const int32_t qmax = (1 << (bits - 1)) - 1;
  for (int64_t b = 0; b < nblocks; ++b) {
    const int64_t lo = b * BF_BLOCK;
    const int64_t hi = std::min(lo + BF_BLOCK, n);
    // shared exponent = exponent of the largest magnitude in the block
    float amax = 0.f;
    for (int64_t i = lo; i < hi; ++i) {
      float a = std::fabs(src[i]);
      if (std::isfinite(a) && a > amax) amax = a;
    }
    int e = 0;
    if (amax > 0.f) std::frexp(amax, &e);  // amax = m * 2^e, m in [0.5, 1)
    // clamp so the biased byte can't wrap: |x| >= 2^127 saturates toward
    // 2^127, subnormal blocks flush toward 0 (both backends identical)
    e = std::max(-127, std::min(127, e));
    *out++ = static_cast<uint8_t>(e + 128);
    // double: 2^127 * qmax overflows float, and lround(inf) would be UB
    const double scale = std::ldexp(1.0, -e) * qmax;  // value -> fixed point
    // pack mantissas little-endian bit stream
    uint64_t acc = 0;
    int nbits = 0;
    for (int64_t i = lo; i < lo + BF_BLOCK; ++i) {
      float v = (i < hi && std::isfinite(src[i])) ? src[i] : 0.f;
      int32_t q = static_cast<int32_t>(std::lround(v * scale));
      q = std::max(-qmax, std::min(qmax, q));
      uint32_t u = static_cast<uint32_t>(q + qmax);  // bias to unsigned
      acc |= static_cast<uint64_t>(u) << nbits;
      nbits += bits;
      while (nbits >= 8) {
        *out++ = static_cast<uint8_t>(acc & 0xff);
        acc >>= 8;
        nbits -= 8;
      }
    }
    if (nbits > 0) *out++ = static_cast<uint8_t>(acc & 0xff);
  }
  return out - dst;
}

// Decompress -> dst (must hold n floats; n returned via bf_peek_count).
// Returns number of floats written, or -1 on malformed input.
int64_t bf_decompress(const uint8_t* src, int64_t src_len, float* dst) {
  if (src_len < 16 || std::memcmp(src, "BFC1", 4) != 0) return -1;
  int64_t n;
  std::memcpy(&n, src + 4, 8);
  const int bits = src[12];
  if (bits < 2 || bits > 24 || n < 0) return -1;
  const uint8_t* in = src + 16;
  const uint8_t* end = src + src_len;
  const int64_t nblocks = (n + BF_BLOCK - 1) / BF_BLOCK;
  const int32_t qmax = (1 << (bits - 1)) - 1;
  const int64_t payload = (static_cast<int64_t>(BF_BLOCK) * bits + 7) / 8;
  for (int64_t b = 0; b < nblocks; ++b) {
    if (in + 1 + payload > end) return -1;
    const int e = static_cast<int>(*in++) - 128;
    const double inv = std::ldexp(1.0, e) / qmax;
    uint64_t acc = 0;
    int nbits = 0;
    const int64_t lo = b * BF_BLOCK;
    for (int64_t i = lo; i < lo + BF_BLOCK; ++i) {
      while (nbits < bits) {
        acc |= static_cast<uint64_t>(*in++) << nbits;
        nbits += 8;
      }
      uint32_t u = static_cast<uint32_t>(acc & ((1u << bits) - 1));
      acc >>= bits;
      nbits -= bits;
      if (i < n) dst[i] = static_cast<float>(
          (static_cast<int32_t>(u) - qmax) * inv);
    }
  }
  return n;
}

int64_t bf_peek_count(const uint8_t* src, int64_t src_len) {
  if (src_len < 16 || std::memcmp(src, "BFC1", 4) != 0) return -1;
  int64_t n;
  std::memcpy(&n, src + 4, 8);
  return n;
}

// ---------------------------------------------------------------------------
// lzb: greedy LZ77 byte compressor (varint-framed, 64KB window)
// ---------------------------------------------------------------------------
//
// Frame: "LZB1" + varint(raw_len) + sequence of tokens.
// Token: control byte C.
//   C & 0x80 set  -> match: len = (C & 0x7f) + MIN_MATCH, followed by
//                    varint(distance)
//   C & 0x80 zero -> literal run: len = C + 1 literal bytes follow
//                    (runs longer than 128 emit multiple tokens)

static const int LZB_MIN_MATCH = 4;
static const int LZB_HASH_BITS = 16;

static inline uint32_t lzb_hash(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return (v * 2654435761u) >> (32 - LZB_HASH_BITS);
}

static inline uint8_t* put_varint(uint8_t* out, uint64_t v) {
  while (v >= 0x80) {
    *out++ = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  *out++ = static_cast<uint8_t>(v);
  return out;
}

static inline const uint8_t* get_varint(const uint8_t* in, const uint8_t* end,
                                        uint64_t* v) {
  uint64_t r = 0;
  int shift = 0;
  while (in < end) {
    uint8_t b = *in++;
    r |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) { *v = r; return in; }
    shift += 7;
    if (shift > 63) return nullptr;
  }
  return nullptr;
}

int64_t lzb_max_compressed_size(int64_t n) {
  // True worst case is NOT all-literals (n + n/128): alternating
  // [4-byte match][1-byte literal run] emits up to 4 + 2 = 6 bytes per
  // 5 input bytes (control + 3-byte varint distance for the match, then
  // a token byte + the literal) — 1.2x expansion.  Bound with n + n/4
  // (1.25x), which dominates every mix of matches (out <= in) and
  // literal runs (out <= in + runs, runs <= in/5 between matches,
  // <= in/128 otherwise).  Undersizing this corrupted the heap on real
  // 12.8 MB activation payloads (r5).
  return 24 + n + n / 4;
}

int64_t lzb_compress(const uint8_t* src, int64_t n, uint8_t* dst) {
  if (n < 0) return -1;
  uint8_t* out = dst;
  std::memcpy(out, "LZB1", 4); out += 4;
  out = put_varint(out, static_cast<uint64_t>(n));

  int32_t head[1 << LZB_HASH_BITS];
  std::fill(head, head + (1 << LZB_HASH_BITS), -1);

  int64_t i = 0, lit_start = 0;
  auto flush_literals = [&](int64_t upto) {
    int64_t len = upto - lit_start;
    while (len > 0) {
      int64_t take = std::min<int64_t>(len, 128);
      *out++ = static_cast<uint8_t>(take - 1);
      std::memcpy(out, src + lit_start, take);
      out += take;
      lit_start += take;
      len -= take;
    }
  };

  while (i + LZB_MIN_MATCH <= n) {
    uint32_t h = lzb_hash(src + i);
    int64_t cand = head[h];
    head[h] = static_cast<int32_t>(i);
    if (cand >= 0 && i - cand <= 0xffff &&
        std::memcmp(src + cand, src + i, LZB_MIN_MATCH) == 0) {
      int64_t len = LZB_MIN_MATCH;
      int64_t maxlen = std::min<int64_t>(n - i, 127 + LZB_MIN_MATCH);
      while (len < maxlen && src[cand + len] == src[i + len]) ++len;
      flush_literals(i);
      *out++ = static_cast<uint8_t>(0x80 | (len - LZB_MIN_MATCH));
      out = put_varint(out, static_cast<uint64_t>(i - cand));
      i += len;
      lit_start = i;
    } else {
      ++i;
    }
  }
  flush_literals(n);
  return out - dst;
}

int64_t lzb_decompressed_size(const uint8_t* src, int64_t src_len) {
  if (src_len < 5 || std::memcmp(src, "LZB1", 4) != 0) return -1;
  uint64_t n;
  const uint8_t* p = get_varint(src + 4, src + src_len, &n);
  return p ? static_cast<int64_t>(n) : -1;
}

int64_t lzb_decompress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                       int64_t dst_len) {
  if (src_len < 5 || std::memcmp(src, "LZB1", 4) != 0) return -1;
  const uint8_t* end = src + src_len;
  uint64_t n;
  const uint8_t* in = get_varint(src + 4, end, &n);
  if (!in || static_cast<int64_t>(n) > dst_len) return -1;
  uint8_t* out = dst;
  uint8_t* out_end = dst + n;
  while (out < out_end && in < end) {
    uint8_t c = *in++;
    if (c & 0x80) {
      int64_t len = (c & 0x7f) + LZB_MIN_MATCH;
      uint64_t dist;
      in = get_varint(in, end, &dist);
      if (!in || dist == 0 || out - dst < static_cast<int64_t>(dist) ||
          out + len > out_end) return -1;
      const uint8_t* from = out - dist;
      for (int64_t k = 0; k < len; ++k) out[k] = from[k];  // overlap-safe
      out += len;
    } else {
      int64_t len = c + 1;
      if (in + len > end || out + len > out_end) return -1;
      std::memcpy(out, in, len);
      in += len;
      out += len;
    }
  }
  return (out == out_end) ? static_cast<int64_t>(n) : -1;
}

}  // extern "C"
