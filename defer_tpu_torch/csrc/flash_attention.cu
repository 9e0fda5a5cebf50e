// Exact softmax attention (flash attention, forward) on Hopper tensor cores,
// sm_90a.
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
//   key returns 0.  f32 or bf16 in, output in q's dtype.  Head dims up to
//   128.  q, k and v are read by their (batch, head, row) strides with a
//   contiguous last dim, so the transformer block's head-split views of the
//   fused qkv projection need no copy.
//
// Bound: bytes.  At the BERT-Base shape [8, 12, 128, 64] f32, q, k, v and o
//   are 12.6 MB, 3.8 us at 3.35 TB/s.  The two products are 403 MFLOP; in
//   three TF32 passes (below) that is 1.2 GFLOP, 2.4 us at the tensor
//   cores' 495 TFLOP/s.  (Without tensor cores the same products take
//   6.0 us at 67 TFLOP/s of f32 FMA, which bounded the previous design.)
//
// Design:
//   1. Both products run on the tensor cores as TF32 `wgmma` (m64nNk8, f32
//      accumulate), error-compensated.  One TF32 product per term misses
//      f32 accuracy: emulated at the BERT shape on N(0,1) inputs it is off
//      the exact-f32 result by 7.4e-4, against the 1e-5 tolerance the kernel
//      is held to.  So each f32 operand x is split into hi = rna_tf32(x) and
//      lo = rna_tf32(x - hi), and each product is lo*hi + hi*lo + hi*hi,
//      the small terms first (emulated: 1.0e-6).  bf16 inputs are exact in
//      TF32: S = Q K^T takes one term and P V two (only P is split).  The
//      f32(1/sqrt(D)) scale and the masks apply to S in f32.
//   2. Operands live in shared memory in wgmma's K-major layout without
//      swizzle: 8-row x 16-byte core matrices, the two along the reduction
//      dim 128 bytes apart (LBO) and row groups SBO apart.  Q and K tiles
//      (rows x D) are K-major as stored.  V is not (the reduction runs over
//      keys), so the threads that split V write it transposed, [D][keys].
//      P never leaves registers: the S accumulator holds keys 2t and 2t+1
//      of each 8-key group where wgmma's A fragment wants keys t and t+4,
//      so V^T's key columns are stored in the order 0 2 4 6 1 3 5 7 within
//      each group, and the accumulator feeds the P V product as it stands.
//   3. K and V tiles stream through a two-stage ring in shared memory
//      filled by 16-byte `cp.async.cg`: tile j+1 is in flight while tile j
//      is split and multiplied.  Q's loads go out first, then the first two
//      tiles; warpgroup 1 issues each later tile while it waits for
//      warpgroup 0's S.  (TMA would need a tensor map encoded on the host
//      for every call, since the q/k/v pointers change each call.)  A
//      tensor whose head base or row stride is not a multiple of 16 bytes
//      is staged by element-wise loads into the same ring.
//   4. One CTA of two consumer warpgroups covers 128 query rows of one
//      (batch, head); each warpgroup owns 64 rows and both read the same
//      ring, so K and V cross from L2 once per 128 query rows.  The
//      warpgroups run staggered by a named barrier: warpgroup 1 starts its
//      S when warpgroup 0's is done, so each one's softmax overlaps the
//      other's products.  The running max and sum reduce over the four
//      lanes that share a row in the accumulator layout.
//   5. The epilogue divides by the row sums as IEEE division does (one
//      rounded reciprocal a row, then a Markstein correction: no slow-path
//      branch per element) and stores o in 16-byte chunks staged through
//      shared memory.
//   Shared memory (f32): Q hi/lo 128 x DP, K hi/lo and V^T hi/lo BK x DP,
//   and the raw ring 2 x 2 x BK x (DP + 4).  DP = 64 takes 64-key tiles
//   (196 KB); DP = 128 in f32 takes 16-key tiles (193 KB), since 32 keys
//   would need 258 KB of the 227 KB a block may use.  bf16 needs no lo
//   halves and takes 64-key tiles at both head dims.
//   The head dim is padded with zeros to DP = 64 or 128 (exact: zero
//   columns add nothing to q.k and the extra output columns are not
//   stored).  No --use_fast_math: expf and IEEE division, as the plain
//   version computes.

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWG = 64;            // query rows per consumer warpgroup
constexpr int kBQ = 2 * kWG;       // query rows per CTA
constexpr int kThreads = 256;      // two warpgroups
constexpr float kLFloor = 1e-20f;  // ops/flash_attention.py L_FLOOR

struct Strides {
  long long b, h, t;  // elements; the last dim is contiguous
};

// Built with -DDEFER_FLASH_TIMELINE (ops/flash_timeline.py), thread 0 of
// each warpgroup of CTA (0, 0) records clock64() as each phase ends:
// 0 start, 1 loads issued, 2 Q split, then for key tile j < kMarkTiles
// 3 + 5j landed, 4 + 5j split, 5 + 5j S, 6 + 5j softmax, 7 + 5j P V, and
// 60 loop done, 61 divided, 62 stored.
constexpr int kMarks = 64, kMarkTiles = 11;
#ifdef DEFER_FLASH_TIMELINE
__device__ long long g_marks[2][kMarks];
__device__ __forceinline__ void mark(int i) {
  if (i < kMarks && blockIdx.x == 0 && blockIdx.y == 0 &&
      (threadIdx.x & 127) == 0)
    g_marks[threadIdx.x >> 7][i] = clock64();
}
#else
__device__ __forceinline__ void mark(int) {}
#endif

// ---- wgmma (TF32 in, f32 accumulate; A and B descriptors or A in registers)

__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pin registers that an in-flight wgmma reads or writes to this point of
// the program, so the compiler neither reads them early nor reuses them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
// generic-proxy shared-memory writes -> visible to wgmma's operand reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared-memory matrix descriptor: K-major, no swizzle, core matrices along
// the reduction dim 128 bytes apart, 8-row groups `sbo` bytes apart
__device__ __forceinline__ uint64_t make_desc(const float* p, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}
// one k8 step along the reduction dim: two core matrices, 256 bytes
constexpr uint64_t kDescStep = 256 >> 4;

// element (r, c) of a K-major operand tile with C columns along the
// reduction dim: [r / 8][c / 4][r % 8][c % 4]
template <int C>
__device__ __forceinline__ int core(int r, int c) {
  return ((r >> 3) * (C / 4) + (c >> 2)) * 32 + (r & 7) * 4 + (c & 3);
}

// ---- TF32 split

// x rounded to TF32, to nearest with ties away from zero: add half a TF32
// ulp to the magnitude and clear the low 13 bits.  Equal to
// cvt.rna.tf32.f32 for every finite x and infinity, in two instructions
// where cvt takes four; a NaN may come out as an infinity, but its lo half
// is then NaN, so its products stay NaN.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float(rna_tf32(x));
  lo = __uint_as_float(rna_tf32(x - hi));
}

// a / d rounded as IEEE division, given r = 1/d rounded to nearest: q is
// within an ulp, the residual a - q d is exact in one fma, and q + e r is
// then the correctly rounded quotient (Markstein) unless it underflows.
// Branch-free, where `/` would test for its slow path at every element.
__device__ __forceinline__ float div_rn(float a, float d, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, d, a), r, q);
}

// ---- loads

__device__ __forceinline__ float widen(float x) { return x; }
// bf16 is carried as its 16-bit pattern; widening to f32 is exact
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));  // round to nearest even
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(uint16_t* p, float4 x) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(x.x)) |
                     static_cast<uint32_t>(__bfloat16_as_ushort(
                         __float2bfloat16_rn(x.y))) << 16;
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(x.z)) |
                     static_cast<uint32_t>(__bfloat16_as_ushort(
                         __float2bfloat16_rn(x.w))) << 16;
  *reinterpret_cast<uint2*>(p) = make_uint2(a, b);
}

// four consecutive elements at p, widened (p 16-byte aligned for f32,
// 8-byte aligned for bf16)
__device__ __forceinline__ void load4(const float* p, float (&x)[4],
                                      bool global) {
  const float4 v = global ? __ldg(reinterpret_cast<const float4*>(p))
                          : *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const uint16_t* p, float (&x)[4],
                                      bool global) {
  const uint2 v = global ? __ldg(reinterpret_cast<const uint2*>(p))
                         : *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16), x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16), x[3] = __uint_as_float(v.y & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ bool aligned(const T* p, long long stride,
                                        unsigned bytes) {
  return ((reinterpret_cast<uintptr_t>(p) |
           static_cast<uintptr_t>(stride * static_cast<long long>(sizeof(T)))) &
          (bytes - 1)) == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// named barrier 1 across both warpgroups: warpgroup 0 arrives, 1 waits
__device__ __forceinline__ void bar_arrive() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_wait() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// keys [k0, k0 + BK) of one head into a raw ring tile [BK][DP + pad] in the
// input dtype, zero past Tk and past D, by NT threads (this one is `tid`):
// 16-byte cp.async when the head's base and row stride allow it,
// element-wise loads otherwise
template <typename T, int DP, int BK, int NT>
__device__ __forceinline__ void stage_tile(T* dst, const T* src,
                                           long long st, int k0, int Tk,
                                           int D, bool async, int tid) {
  constexpr int EPC = 16 / sizeof(T), CPR = DP / EPC, LDR = DP + EPC;
  static_assert(BK * CPR % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < BK * CPR / NT; ++it) {
    const int idx = tid + it * NT;
    const int r = idx / CPR, c = (idx % CPR) * EPC;
    T* d = dst + r * LDR + c;
    const int key = k0 + r;
    const int valid = key < Tk ? max(0, min(EPC, D - c)) : 0;
    const T* s = src + (valid ? static_cast<long long>(key) * st + c : 0);
    if (async) {
      cp_async16(d, s, valid * static_cast<int>(sizeof(T)));
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) d[e] = e < valid ? s[e] : T(0);
    }
  }
}

template <typename T, int DP, int BK>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int halves = std::is_same<T, float>::value ? 2 : 1;
  // Q [kBQ][DP], K [BK][DP] and V^T [DP][BK] (hi, and lo for f32), then
  // the raw ring [2 stages][K, V][BK][DP + 16 bytes]
  return 4 * halves * (kBQ * DP + 2 * BK * DP) +
         2 * 2 * BK * (DP + 16 / static_cast<int>(sizeof(T))) *
             static_cast<int>(sizeof(T));
}

template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, Strides sq,
                  Strides sk, Strides sv, int H, int Tq, int Tk, int D,
                  float scale, int causal) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int EPC = 16 / sizeof(T), LDR = DP + EPC;
  constexpr int kQ = kBQ * DP, kOp = BK * DP, kRaw = BK * LDR;
  constexpr int kSteps = BK / 8;  // k8 steps of P V (and 8-key groups of S)
  static_assert(smem_bytes<T, DP, BK>() <= 232448, "shared memory");
  extern __shared__ float4 smem4[];
  float* Qh = reinterpret_cast<float*>(smem4);
  float* Ql = Qh + kQ;  // f32 only
  float* Kh = Qh + (kF32 ? 2 : 1) * kQ;
  float* Kl = Kh + kOp;  // f32 only
  float* Vh = Kh + (kF32 ? 2 : 1) * kOp;
  float* Vl = Vh + kOp;  // f32 only
  T* ring = reinterpret_cast<T*>(Vh + (kF32 ? 2 : 1) * kOp);

  mark(0);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, g = (tid & 31) >> 2, t = tid & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kBQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const bool k_async = aligned(kb, sk.t, 16), v_async = aligned(vb, sv.t, 16);

  const int off = Tk - Tq;  // bottom-right causal alignment
  int nkb = (Tk + BK - 1) / BK;
  if (causal) {
    // the last key any live row of this CTA may see; tiles past it are
    // wholly in the future and skipped
    const int last_key = min(q0 + kBQ, Tq) - 1 + off;
    nkb = last_key < 0 ? 0 : min(nkb, last_key / BK + 1);
  }
  // tile kt into ring stage kt % 2, by NT threads (this one is `i`)
  auto issue = [&](auto nt, int kt, int i) {
    constexpr int NT = decltype(nt)::value;
    T* kr = ring + (kt & 1) * 2 * kRaw;
    stage_tile<T, DP, BK, NT>(kr, kb, sk.t, kt * BK, Tk, D, k_async, i);
    stage_tile<T, DP, BK, NT>(kr + kRaw, vb, sv.t, kt * BK, Tk, D, v_async,
                              i);
  };
  using All = std::integral_constant<int, kThreads>;
  using Half = std::integral_constant<int, kThreads / 2>;

  // Q: 128 rows straight from global memory, split into the K-major tiles
  // (warpgroup w's 64 rows are row groups 8w..8w+7, one SBO-strided tile).
  // Its loads go out first, then both ring stages, then the split.
  {
    constexpr int kIt = kBQ * DP / 4 / kThreads;
    const bool vec = aligned(qb, sq.t, 4 * sizeof(T));
    float x[kIt][4];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int idx = tid + it * kThreads;
      const int r = ((idx >> 3) / (DP / 4)) * 8 + (idx & 7);
      const int c = ((idx >> 3) % (DP / 4)) * 4, row = q0 + r;
      if (row < Tq && vec && c + 4 <= D) {
        load4(qb + static_cast<long long>(row) * sq.t + c, x[it], true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[it][e] = row < Tq && c + e < D
                         ? widen(qb[static_cast<long long>(row) * sq.t + c + e])
                         : 0.0f;
      }
    }
    for (int kt = 0; kt < min(nkb, 2); ++kt) {
      issue(All(), kt, tid);
      cp_async_commit();
    }
    mark(1);
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int idx = tid + it * kThreads;
      const int r = ((idx >> 3) / (DP / 4)) * 8 + (idx & 7);
      const int c = ((idx >> 3) % (DP / 4)) * 4;
      float4 hi, lo;
      if constexpr (kF32) {
        split(x[it][0], hi.x, lo.x), split(x[it][1], hi.y, lo.y);
        split(x[it][2], hi.z, lo.z), split(x[it][3], hi.w, lo.w);
        *reinterpret_cast<float4*>(Ql + core<DP>(r, c)) = lo;
      } else {
        hi = make_float4(x[it][0], x[it][1], x[it][2], x[it][3]);
      }
      *reinterpret_cast<float4*>(Qh + core<DP>(r, c)) = hi;
    }
  }
  mark(2);

  const int r0 = q0 + wg * kWG + warp * 16 + g, r1 = r0 + 8;
  const bool wg_live = q0 + wg * kWG < Tq;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const uint64_t dqh = make_desc(Qh + wg * kWG * DP, DP * 32);
  const uint64_t dql = make_desc(Ql + wg * kWG * DP, DP * 32);
  const uint64_t dkh = make_desc(Kh, DP * 32), dkl = make_desc(Kl, DP * 32);
  const uint64_t dvh = make_desc(Vh, BK * 32), dvl = make_desc(Vl, BK * 32);

  for (int kt = 0; kt < nkb; ++kt) {
    // every thread has committed one group per tile so far (empty ones
    // included), and tiles kt and kt + 1 may be in flight
    if (kt + 1 < nkb)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    // tile kt has landed for every thread, and tile kt-1's products (each
    // warpgroup waited for its own) no longer read the operand tiles
    __syncthreads();
    const int mk = kt < kMarkTiles ? 3 + 5 * kt : kMarks;  // past: none
    mark(mk);
    {
      const T* kr = ring + (kt & 1) * 2 * kRaw;
      const T* vr = kr + kRaw;
      // K [keys][D] -> K-major hi/lo (lanes walk the 8 rows of a core
      // matrix); V [keys][D] -> V^T [D][keys] hi/lo, keys 8j + {0,2,4,6}
      // then 8j + {1,3,5,7} in each 8-key group (the P fragment's order).
      // Every shared-memory read is issued before the first is used.
      constexpr int kIt = BK * DP / 4 / kThreads;
      static_assert(BK * DP / 4 % kThreads == 0, "whole chunks per thread");
      float xk[kIt][4], xv[kIt][4];
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int idx = tid + it * kThreads;
        const int r = ((idx >> 3) / (DP / 4)) * 8 + (idx & 7);
        const int c = ((idx >> 3) % (DP / 4)) * 4;
        load4(kr + r * LDR + c, xk[it], false);
        const int d = idx % DP, j = (idx / DP) >> 1, par = (idx / DP) & 1;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xv[it][i] = widen(vr[(8 * j + 2 * i + par) * LDR + d]);
      }
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int idx = tid + it * kThreads;
        const int r = ((idx >> 3) / (DP / 4)) * 8 + (idx & 7);
        const int c = ((idx >> 3) % (DP / 4)) * 4;
        const int kofs = core<DP>(r, c);
        const int d = idx % DP, j = (idx / DP) >> 1, par = (idx / DP) & 1;
        const int vofs = core<BK>(d, 8 * j + 4 * par);
        if constexpr (kF32) {
          float4 hi, lo;
          split(xk[it][0], hi.x, lo.x), split(xk[it][1], hi.y, lo.y);
          split(xk[it][2], hi.z, lo.z), split(xk[it][3], hi.w, lo.w);
          *reinterpret_cast<float4*>(Kh + kofs) = hi;
          *reinterpret_cast<float4*>(Kl + kofs) = lo;
          split(xv[it][0], hi.x, lo.x), split(xv[it][1], hi.y, lo.y);
          split(xv[it][2], hi.z, lo.z), split(xv[it][3], hi.w, lo.w);
          *reinterpret_cast<float4*>(Vh + vofs) = hi;
          *reinterpret_cast<float4*>(Vl + vofs) = lo;
        } else {
          *reinterpret_cast<float4*>(Kh + kofs) =
              make_float4(xk[it][0], xk[it][1], xk[it][2], xk[it][3]);
          *reinterpret_cast<float4*>(Vh + vofs) =
              make_float4(xv[it][0], xv[it][1], xv[it][2], xv[it][3]);
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    mark(mk + 1);
    // The warpgroups run staggered: 1 starts its S once 0's S is done, so
    // one's softmax overlaps the other's products.  Meanwhile warpgroup 1
    // issues tile kt + 2 into the stage just split.
    if (kt + 2 < nkb) {
      if (wg == 1) issue(Half(), kt + 2, tid - kThreads / 2);
      cp_async_commit();  // warpgroup 0's group is empty
    }
    if (wg == 1) bar_wait();
    if (!wg_live) continue;  // every row of this warpgroup is past Tq

    // S = Q K^T for this warpgroup's 64 rows x BK keys
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
    if constexpr (kF32) {
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk)
        wgmma_ss(s, dql + kk * kDescStep, dkh + kk * kDescStep);
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk)
        wgmma_ss(s, dqh + kk * kDescStep, dkl + kk * kDescStep);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      wgmma_ss(s, dqh + kk * kDescStep, dkh + kk * kDescStep);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    if (wg == 0) bar_arrive();
    mark(mk + 2);

    // online softmax: s[4j + e] is row (e < 2 ? r0 : r1), key
    // kt*BK + 8j + 2t + (e & 1); a row's keys live on the 4 lanes of t
    // (a tile that every row of the warpgroup sees whole needs no mask)
    const int last = (kt + 1) * BK - 1;
    const bool whole = last < Tk && (!causal || last <= q0 + wg * kWG + off);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * BK + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool live =  // no short circuits: no branch per element
            whole | ((key < Tk) & (!causal | (key <= row + off)));
        const float x = live ? s[4 * j + e] * scale : -INFINITY;
        s[4 * j + e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    float safe[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      // rows with no live key yet keep m = -inf and stay inert
      safe[r] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[r] = m[r] == -INFINITY ? 0.0f : expf(m[r] - safe[r]);
      m[r] = m_new;
      l[r] *= alpha[r];  // this lane's share; the 4 lanes are summed at the end
    }
    uint32_t ph[kSteps][4], pl[kSteps][4];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      // A fragment of k8 step j: (g, t), (g+8, t), (g, t+4), (g+8, t+4),
      // with logical key t <- key 2t and t+4 <- key 2t+1 (V^T's order)
      const int from[4] = {0, 2, 1, 3};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[4 * j + from[e]] - safe[from[e] >> 1]);  // masked: 0
        l[from[e] >> 1] += p;
        ph[j][e] = rna_tf32(p);
        pl[j][e] = rna_tf32(p - __uint_as_float(ph[j][e]));
      }
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    mark(mk + 3);
    // O += P V: lo*hi, hi*lo (f32), then hi*hi
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) wgmma_rs(acc, pl[j], dvh + j * kDescStep);
    if constexpr (kF32) {
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
        wgmma_rs(acc, ph[j], dvl + j * kDescStep);
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) wgmma_rs(acc, ph[j], dvh + j * kDescStep);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    mark(mk + 4);
  }
  mark(60);

  // acc[i] is row (i & 2 ? r1 : r0), column 8 (i / 4) + 2t + (i & 1).
  // The normalised rows go through shared memory (over the Q tiles, no
  // longer read) so that the stores to o are whole 16-byte chunks.
  float denom[2], rcp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], kLFloor);
    rcp[r] = __frcp_rn(denom[r]);
  }
  constexpr int LDO = DP + 8;  // float2 writes of a half-warp hit 32 banks
  static_assert(kBQ * LDO <= (kF32 ? 2 * kQ : kQ + kOp), "output tile");
  float* Os = Qh;
  __syncthreads();  // every warpgroup is done with the Q tiles
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int row = (i & 2) ? r1 : r0;
    const int col = 8 * (i >> 2) + 2 * t;
    *reinterpret_cast<float2*>(Os + (row - q0) * LDO + col) =
        make_float2(div_rn(acc[i], denom[(i >> 1) & 1], rcp[(i >> 1) & 1]),
                    div_rn(acc[i + 1], denom[(i >> 1) & 1], rcp[(i >> 1) & 1]));
  }
  mark(61);
  __syncthreads();
  T* ob = o + static_cast<long long>(bh) * Tq * D;
  const bool vec = aligned(ob, D, 4 * sizeof(T));
  constexpr int kIt = kBQ * DP / 4 / kThreads;
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / (DP / 4), c = (idx % (DP / 4)) * 4, row = q0 + r;
    if (row >= Tq || c >= D) continue;
    const float4 x = *reinterpret_cast<const float4*>(Os + r * LDO + c);
    T* p = ob + static_cast<long long>(row) * D + c;
    if (vec && c + 4 <= D) {
      store4(p, x);
    } else {
      const float xs[4] = {x.x, x.y, x.z, x.w};
      for (int e = 0; e < 4 && c + e < D; ++e) store(p + e, xs[e]);
    }
  }
  mark(62);
}

template <typename T, int DP, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides sq, Strides sk, Strides sv, int BH, int H, int Tq,
                   int Tk, int D, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, DP, BK>();
  static bool configured = false;  // idempotent, so a race is harmless
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<T, DP, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((Tq + kBQ - 1) / kBQ));
  flash_attn_kernel<T, DP, BK><<<grid, kThreads, bytes, stream>>>(
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
    e = D <= 64 ? launch<float, 64, 64>(q, k, v, o, sq, sk, sv, n, H, Tq, Tk,
                                        D, scale, causal, st)
                : launch<float, 128, 16>(q, k, v, o, sq, sk, sv, n, H, Tq, Tk,
                                         D, scale, causal, st);
  else if (dtype == 1)
    e = D <= 64 ? launch<uint16_t, 64, 64>(q, k, v, o, sq, sk, sv, n, H, Tq,
                                           Tk, D, scale, causal, st)
                : launch<uint16_t, 128, 64>(q, k, v, o, sq, sk, sv, n, H, Tq,
                                            Tk, D, scale, causal, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}

extern "C" const char* defer_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef DEFER_FLASH_TIMELINE
// the marks of the last launch ([2][64] clock64 values, 0 = not reached),
// and their reset; both synchronise with the device
extern "C" int defer_flash_timeline_read(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks)));
}
extern "C" int defer_flash_timeline_clear() {
  static const long long zero[2][kMarks] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_marks, zero, sizeof(zero)));
}
#endif
