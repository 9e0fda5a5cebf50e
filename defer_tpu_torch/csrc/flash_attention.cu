// Exact softmax attention (flash attention, forward), sm_90a.
//
// Replaces: the Pallas TPU kernel `_attn_kernel` of
//   defer_tpu/ops/flash_attention.py (launched by `flash_attention`), which
//   every TransformerBlock of the BERT pipeline runs once per step.  Same
//   contract as the plain version in defer_tpu_torch/ops/flash_attention.py:
//   out = softmax(q k^T * f32(1/sqrt(D))) v over [B, H, Tq, D] x
//   [B, H, Tk, D], f32 online-softmax state (running max m, denominator l,
//   rescaled accumulator), key padding masked, causal mode bottom-right
//   aligned (query row i sees keys <= i + Tk - Tq), key tiles wholly in
//   the future skipped, denominator floored at 1e-20 so a row with no live
//   key returns 0.  f32 or bf16 in (bf16 widened on load), output in q's
//   dtype.  Head dims up to 128.
//
// Bound: operations.  At the BERT-Base shape [8, 12, 128, 64] the two
//   products are 4*B*H*Tq*Tk*D = 403 MFLOP, 6.0 us at the card's 67 TFLOP/s
//   f32 rate outside the tensor cores (TF32 would change the results), while
//   q, k, v and o are 12.6 MB, 3.8 us at 3.35 TB/s.  The kernel keeps the
//   [Tq, Tk] score matrix out of device memory, so it moves only those
//   bytes; what is left is feeding the FMA units from shared memory.
//
// Design (simple first; wgmma, TMA and warp specialisation are later work):
//   one CTA of 256 threads per (batch*head, 64 query rows).  The Q tile is
//   staged once in shared memory; a loop over 64-key tiles stages K and V
//   (zero-filled past Tk and past D), then
//     - S = Q K^T: thread (ty, tx) of a 16x16 layout owns rows ty + 16 i and
//       keys tx + 16 j (i, j < 4), reading Q and K rows as float4 (K rows
//       padded by 4 floats, so 8 lanes of a phase hit distinct banks);
//     - online softmax in registers: the 16 lanes that share a row reduce
//       its max and sum with __shfl_xor_sync inside their half-warp;
//     - P goes through shared memory, and the thread's accumulator rows
//       (the same rows it scored) add P V, with V read as float4.
//   The head dim is padded with zeros to DP = 64 or 128 (exact: zero
//   columns add nothing to q.k and the extra output columns are not
//   stored).  q, k and v are read by stride (last dim contiguous), so the
//   transformer block's head-split views need no copy.  No --use_fast_math:
//   expf and IEEE division, as the plain version computes.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // 16 x 16 thread layout
constexpr int kRows = kBQ / 16;   // query rows per thread
constexpr int kKeys = kBK / 16;   // keys per thread in S
constexpr float kLFloor = 1e-20f;  // ops/flash_attention.py L_FLOOR

struct Strides {
  long long b, h, t;  // elements; the last dim is contiguous
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
// bf16 is carried as its 16-bit pattern; widening to f32 is exact
__device__ __forceinline__ float load(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));  // round to nearest even
}

// max / sum over the 16 lanes of a half-warp (the lanes sharing ty)
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [r0, r0 + rows) of one head, D columns, into a [rows][ld] f32 tile
// zero-filled past `valid` rows and past D
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long st, int r0, int valid,
                                          int D, int rows) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    dst[r * ld + c] = (r0 + r < valid && c < D)
                          ? load(src + static_cast<long long>(r0 + r) * st + c)
                          : 0.0f;
  }
}

template <int DP>
constexpr int smem_bytes() {
  // Q [kBQ][DP+4], K [kBK][DP+4], V [kBK][DP], P [kBQ][kBK+4]
  return 4 * (kBQ * (DP + 4) + kBK * (DP + 4) + kBK * DP + kBQ * (kBK + 4));
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, Strides sq,
                  Strides sk, Strides sv, int H, int Tq, int Tk, int D,
                  float scale, int causal) {
  constexpr int LDQ = DP + 4, LDK = DP + 4, LDV = DP, LDP = kBK + 4;
  constexpr int kC4 = DP / 64;  // float4 column groups per thread in P V
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LDQ;
  float* Vs = Ks + kBK * LDK;
  float* Ps = Vs + kBK * LDV;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kbase = k + b * sk.b + h * sk.h;
  const T* vbase = v + b * sv.b + h * sv.h;

  load_tile<T, DP>(Qs, LDQ, qb, sq.t, q0, Tq, D, kBQ);

  float acc[kRows][4 * kC4];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kC4; ++c) acc[i][c] = 0.0f;
  }

  const int off = Tk - Tq;  // bottom-right causal alignment
  int nkb = (Tk + kBK - 1) / kBK;
  if (causal) {
    // the last key any live row of this tile may see; tiles past it are
    // wholly in the future and skipped
    const int last_key = min(q0 + kBQ, Tq) - 1 + off;
    nkb = last_key < 0 ? 0 : min(nkb, last_key / kBK + 1);
  }

  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // Q is staged / the previous tile's P V reads are done
    load_tile<T, DP>(Ks, LDK, kbase, sk.t, k0, Tk, D, kBK);
    load_tile<T, DP>(Vs, LDV, vbase, sv.t, k0, Tk, D, kBK);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LDQ + d]);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LDK + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + 16 * j;
        const bool live = key < Tk && (!causal || key <= row + off);
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mt));
      // rows with no live key yet keep m = -inf and stay inert
      const float safe = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = m[i] == -INFINITY ? 0.0f : expf(m[i] - safe);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - safe);  // masked: exp(-inf) = 0
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kC4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c4 = 0; c4 < kC4; ++c4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(kk + u) * LDV + c4 * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z : pv[i].w;
            acc[i][4 * c4 + 0] = fmaf(p, vv.x, acc[i][4 * c4 + 0]);
            acc[i][4 * c4 + 1] = fmaf(p, vv.y, acc[i][4 * c4 + 1]);
            acc[i][4 * c4 + 2] = fmaf(p, vv.z, acc[i][4 * c4 + 2]);
            acc[i][4 * c4 + 3] = fmaf(p, vv.w, acc[i][4 * c4 + 3]);
          }
        }
      }
    }
  }

  T* ob = o + static_cast<long long>(bh) * Tq * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[i], kLFloor);
#pragma unroll
    for (int c4 = 0; c4 < kC4; ++c4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c4 * 64 + tx * 4 + e;
        if (col < D)
          store(ob + static_cast<long long>(row) * D + col,
                acc[i][4 * c4 + e] / denom);
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides sq, Strides sk, Strides sv, int BH, int H, int Tq,
                   int Tk, int D, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DP>();
  static bool configured = false;  // idempotent, so a race is harmless
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((Tq + kBQ - 1) / kBQ));
  flash_attn_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, H, Tq, Tk, D,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, Tq, D], k and v [B, H, Tk, D], each read by its (batch, head,
// row) strides in elements with a contiguous last dim; o contiguous
// [B, H, Tq, D].  dtype 0 = f32, 1 = bf16 (all four tensors).  1 <= D <= 128.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int defer_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qsh, long long qst, long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst, int B, int H, int Tq, int Tk,
    int D, float scale, int causal, int dtype, void* stream) {
  const long long bh = static_cast<long long>(B) * H;
  if (bh == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  if (B < 0 || H <= 0 || Tq < 0 || Tk < 0 || D < 1 || D > 128 ||
      bh > INT_MAX || (Tq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{qsb, qsh, qst}, sk{ksb, ksh, kst}, sv{vsb, vsh, vst};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(bh);
  cudaError_t e;
  if (dtype == 0)
    e = D <= 64 ? launch<float, 64>(q, k, v, o, sq, sk, sv, n, H, Tq, Tk, D,
                                    scale, causal, st)
                : launch<float, 128>(q, k, v, o, sq, sk, sv, n, H, Tq, Tk, D,
                                     scale, causal, st);
  else if (dtype == 1)
    e = D <= 64 ? launch<uint16_t, 64>(q, k, v, o, sq, sk, sv, n, H, Tq, Tk,
                                       D, scale, causal, st)
                : launch<uint16_t, 128>(q, k, v, o, sq, sk, sv, n, H, Tq, Tk,
                                        D, scale, causal, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}

extern "C" const char* defer_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
