// Block-scale int8 quantizer for the pipeline's inter-stage wire, sm_90a.
//
// Replaces: the Pallas TPU kernel `_quant_kernel` of
//   defer_tpu/ops/quant_pallas.py (launched by quantize_int8_blocks_pallas),
//   which the JAX pipeline runs on every wire="int8" step.  Same contract as
//   the plain version in defer_tpu_torch/ops/quant.py, bit for bit: per
//   256-value block, flush non-finite values to 0, amax = max|x|,
//   scale = amax * f32(1/127) (1 when amax is 0), q = clip(rint(x / scale),
//   -127, 127).  The scale multiplies by the f32 reciprocal because that is
//   what XLA compiles the reference's `amax / 127.0` into (ROADMAP.md
//   queue C); x / scale is a true division in both.
//
// Bound: memory.  Per value it reads 4 B (f32) or 2 B (bf16) and writes 1 B,
//   plus 4 B of scale per 256 values; it does ~4 flops per value, far below
//   the card's flop rate.  A step of the ResNet50 eight-stage ring at
//   microbatch 1 moves ~32 MB, ~10 us at 3.35 TB/s.
//
// Design: the only reduction is inside one quant block, so one warp owns one
//   block and nothing crosses warps or CTAs: each lane loads 8 consecutive
//   values as 16-byte vectors (two float4 for f32, one uint4 for bf16 —
//   neighbouring lanes on neighbouring addresses, fully coalesced), the block
//   max is a 5-step __shfl_xor_sync butterfly in registers, lane 0 stores the
//   scale and every lane stores its 8 bytes of q as one 8-byte store.  256
//   threads per CTA (8 quant blocks), grid = ceil(nblocks / 8): a ring step
//   is tens of thousands of CTAs, enough to keep every SM's loads in flight.
//   Exactness: compile WITHOUT --use_fast_math; divide x / scale with
//   __fdiv_rn (IEEE, never a reciprocal multiply), round with rintf (half to
//   even, as jnp.round), and form the scale with __fmul_rn, so ties land
//   where the reference puts them.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;        // values per scale (ops/quant.py BLOCK)
constexpr int kPerLane = 8;        // 32 lanes x 8 values = one quant block
constexpr int kWarpsPerCta = 8;
constexpr float kInv127 = 1.0f / 127.0f;  // f32(1/127), folded at compile time

__device__ __forceinline__ void load8(const float* p, float v[kPerLane]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// bf16 is carried as its 16-bit pattern; widening to f32 is exact (the
// pattern is the top half of the f32), as astype(float32) in the reference
__device__ __forceinline__ void load8(const uint16_t* p, float v[kPerLane]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
quant_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ s, long long nblocks) {
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= nblocks) return;  // warp-uniform: the whole warp owns blk
  const int lane = threadIdx.x & 31;
  const long long off = blk * kBlock + lane * kPerLane;

  float v[kPerLane];
  load8(x + off, v);
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    v[i] = isfinite(v[i]) ? v[i] : 0.0f;  // flush first: NaN never reaches max
    amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
  const float scale = amax > 0.0f ? __fmul_rn(amax, kInv127) : 1.0f;
  if (lane == 0) s[blk] = scale;

  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], scale)), -127.0f), 127.0f);
    const uint32_t byte = static_cast<uint8_t>(static_cast<int8_t>(r));
    packed[i >> 2] |= byte << (8 * (i & 3));
  }
  *reinterpret_cast<uint2*>(q + off) = make_uint2(packed[0], packed[1]);
}

}  // namespace

// x: nblocks * 256 contiguous values, 16-byte aligned; dtype 0 = f32,
// 1 = bf16.  q: nblocks * 256 int8 (8-byte aligned); s: nblocks f32.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int defer_quant_int8(const void* x, void* q, void* s,
                                long long nblocks, int dtype, void* stream) {
  if (nblocks <= 0) return static_cast<int>(cudaSuccess);
  const long long ctas = (nblocks + kWarpsPerCta - 1) / kWarpsPerCta;
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ctas));
  const dim3 block(kWarpsPerCta * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qo = static_cast<int8_t*>(q);
  auto* so = static_cast<float*>(s);
  switch (dtype) {
    case 0:
      quant_int8_kernel<float><<<grid, block, 0, st>>>(
          static_cast<const float*>(x), qo, so, nblocks);
      break;
    case 1:
      quant_int8_kernel<uint16_t><<<grid, block, 0, st>>>(
          static_cast<const uint16_t*>(x), qo, so, nblocks);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* defer_quant_int8_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
