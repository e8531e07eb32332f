// Device pieces shared by the split stage kernels (csrc/expand_split.cu,
// csrc/contract_split.cu): the block size, the cp.async ring depth, the
// per-phase clock slots, bf16/f32 conversions, four-channel loads and
// multiply-adds, and the 16-byte cp.async copy. ops/_build.py hashes
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

}  // namespace nlt_split
