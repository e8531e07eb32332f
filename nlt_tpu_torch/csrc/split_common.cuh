// Device pieces shared by the split stage kernels (csrc/expand_split.cu,
// csrc/contract_split.cu): the block size, the cp.async ring depth, the
// per-phase clock slots, bf16/f32 conversions, four-channel loads and
// multiply-adds, the 16-byte cp.async copy, and ldmatrix / mma.sync for
// the bf16 products on the tensor cores. ops/_build.py hashes
// this header into both libraries' names, so an edit rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace nlt_split {

constexpr int kThreads = 256;
constexpr int kStages = 3;  // cp.async ring depth (_SPLIT_STAGES mirrors it)
constexpr int kMaxR = 4;    // pixels per thread item
// Clock slots a block writes when asked (nlt_*_split_clocks): global ns at
// start; clock64 at start, loop entry, phase 1's last product, first
// cluster barrier, exchange done, end; the cycles thread 0 spent waiting
// for chunks in phase 1 and in phase 2; global ns at the end; the cycles
// thread 0 spent issuing chunk copies in phase 1 and 2.
constexpr int kClockSlots = 12;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive elements as float32 (16 bytes of float, 8 of bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// acc[j] += a.x b[0][j] + a.y b[1][j] + a.z b[2][j] + a.w b[3][j], one
// FMA at a time in that order: four consecutive input channels.
__device__ __forceinline__ void fma4x4(float* acc, float4 a,
                                       const float4* b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    acc[0] = fmaf(av[u], b[u].x, acc[0]);
    acc[1] = fmaf(av[u], b[u].y, acc[1]);
    acc[2] = fmaf(av[u], b[u].z, acc[2]);
    acc[3] = fmaf(av[u], b[u].w, acc[3]);
  }
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Tensor-core pieces of the bf16 products. ldsm4 loads four 8 x 8 bf16
// matrices, lane l giving the row address of row l % 8 of matrix l / 8
// (.trans: each matrix transposed on the way, for an operand whose rows
// run along K); mma16816 is acc += A (16 x 16) B (16 x 8) in float32.
template <bool kTrans>
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace nlt_split
