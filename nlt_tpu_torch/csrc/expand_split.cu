// The fused expanding U-Net stage (K3) for the deep, low-resolution
// stages, as a thread-block cluster per tile, for Hopper (sm_90a), bound
// through a plain C interface (ctypes; nlt_tpu_torch/ops/fused_stage.py).
//
// It replaces, for the stages the wrapper routes here, the Pallas kernel
// _expand_kernel of nlt_tpu/ops/fused_stage.py (and its lane-packed twin
// _expand_kernel_packed, both launched by _expand_fwd_pallas):
//   y1 = lrelu(deconv_k2s2(x) + b1)
//   y2 = lrelu(deconv_k2s1(y1) + b2)   taps look up-left, zero before the
//                                      top/left edge
// Activations NHWC, kernels HWIO, float32 or bfloat16. Products accumulate
// in float32 with FMA, in the order of csrc/fused_stage.cu's expand_kernel
// (input channels ascending; taps, then channels, in phase 2), the bias
// (already in the activation type) is added in float32, and y1 and y2 are
// rounded to the activation type once each, after the activation.
//
// What bounds it on the H100. The deep stages of the flagship U-Net (8^2
// x 1024 -> 128, 16^2 x 640 -> 64, 32^2 x 320 -> 32 at bs 1) do 17-70M
// multiply-adds, about 1.5 us of the card's float32 CUDA-core rate, and
// read under 3 MB. They are bound by latency: csrc/fused_stage.cu runs
// one 256-thread block per input tile (8 to 64 blocks on 132 SMs), and
// each block walks C in 16-channel chunks, every chunk waiting on its
// scalar weight loads, two barriers apart.
//
// Design. A cluster of S blocks (1, 2, 4 or 8) owns a TH x TW input tile
// of one image; rank r owns output channels [r O/S, (r+1) O/S), so a
// stage with few tiles still fills the card (clusters x S blocks).
//  - Phase 1 (k2s2 deconv) runs per rank over its channel slice only: y1
//    at every pixel of the tile and its top/left halo, all four parities
//    (di, dj), from the whole input tile and the rank's slice of w1 (B
//    rows of O/S contiguous elements; no reduction across blocks).
//  - Input and weight chunks (CH channels of the tile's pixels; CH rows of
//    w1[di, dj] for the four parities) stream through a ring of kStages
//    buffers in shared memory by cp.async (16-byte copies, zero-filled
//    past the image and past C), so the copies of chunks k+1 and k+2 are
//    in flight while chunk k is multiplied; one barrier per chunk.
//  - Each rank keeps its y1 slice, rounded, in its own full y1 tile, then
//    (cluster barrier) copies the peers' slices in through distributed
//    shared memory (map_shared_rank), and a second cluster barrier keeps
//    every block alive until its peers have read it.
//  - Phase 2 (k2s1 deconv) per rank over its y2 channel slice, from the
//    full y1 tile, with w2's slice streamed through the same ring (its
//    first chunks are in flight during the exchange).
// Each thread owns R pixels x 4 channels of the current product (R is 1,
// 2 or 4, the least that lets 256 threads cover it) and takes four input
// channels a step; its pixels are strided so that neighbouring threads
// read neighbouring pixels' rows, which the padded row strides spread
// over the banks.
//
// Measured (chip_smoke.py's per-phase clocks): phase 1 takes two thirds
// of a deep stage's cycles, the wait for chunks almost none. A rank
// streams its whole w1 slice (256 KB at 8^2 in float32) for few FMAs per
// byte, so the SM's load/store pipe, shared by the cp.async issue and
// the shared-memory loads of the products, sets the pace; sharing one
// weight slice across the clusters of several tiles (TMA multicast) is
// what would cut it. ops/fused_stage.py::_split_plan routes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;  // cp.async ring depth (_SPLIT_STAGES mirrors it)
constexpr int kMaxR = 4;    // pixels per thread item
// Clock slots a block writes when asked (nlt_expand_split_clocks): global
// ns at start; clock64 at start, loop entry, phase 1's last product,
// first cluster barrier, exchange done, end; the cycles thread 0 spent
// waiting for chunks in phase 1 and in phase 2; global ns at the end;
// the cycles thread 0 spent issuing chunk copies in phase 1 and 2.
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

// The launch's geometry, shared by the host (shared-memory size, thread
// items) and the kernel. ops/fused_stage.py::_split_geometry mirrors it.
struct Geo {
  int th, tw, o, s, ch, item;
  int os;    // O / S: the rank's channel slice
  int ve;    // elements per 16-byte copy
  int m1;    // input pixels of the tile with its halo: (TH+1)(TW+1)
  int yw;    // y1 tile width 2TW+1
  int ny1;   // y1 tile pixels (2TH+1)(2TW+1)
  int ldx;   // x chunk row stride: CH + one 16-byte pad
  int ys;    // y1 tile pixel stride: O + one 16-byte pad
  int ch2;   // w2 rows per phase-2 chunk: min(O, 4 CH)
  size_t stage_elems, y1_bytes, stage_bytes, smem;

  __host__ __device__ Geo(int th_, int tw_, int o_, int s_, int ch_,
                          int item_)
      : th(th_), tw(tw_), o(o_), s(s_), ch(ch_), item(item_) {
    os = o / s;
    ve = 16 / item;
    m1 = (th + 1) * (tw + 1);
    yw = 2 * tw + 1;
    ny1 = (2 * th + 1) * yw;
    ldx = ch + ve;
    ys = o + ve;
    ch2 = o < 4 * ch ? o : 4 * ch;
    stage_elems = (size_t)m1 * ldx + (size_t)4 * ch * os;
    stage_bytes = stage_elems * item;
    y1_bytes = ((size_t)ny1 * ys * item + 15) / 16 * 16;
    smem = kStages * stage_bytes + y1_bytes + ((size_t)m1 * 4 + 15) / 16 * 16;
  }
  // Pixel groups of the phase-1 product: parity q = 2 di + dj covers the
  // (TH + di) x (TW + dj) input pixels whose y1 lies in the tile.
  __host__ __device__ int groups1(int r) const {
    int g = 0;
    for (int q = 0; q < 4; ++q) {
      const int mq = (th + (q >> 1)) * (tw + (q & 1));
      g += (mq + r - 1) / r;
    }
    return g;
  }
  __host__ __device__ int items1(int r) const { return groups1(r) * (os / 4); }
  __host__ __device__ int items2(int r) const {
    return (4 * th * tw + r - 1) / r * (os / 4);
  }
};

template <typename T, int R1, int R2>
__global__ void __launch_bounds__(kThreads)
    expand_split_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                        const T* __restrict__ b1, const T* __restrict__ w2,
                        const T* __restrict__ b2, T* __restrict__ y2,
                        T* __restrict__ y1, int H, int W, int C, int O,
                        int TH, int TW, int S, int CH, float slope,
                        long long* __restrict__ clk) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Geo g(TH, TW, O, S, CH, (int)sizeof(T));
  T* ring = reinterpret_cast<T*>(smem);
  T* y1s = reinterpret_cast<T*>(smem + kStages * g.stage_bytes);
  int* pix = reinterpret_cast<int*>(smem + kStages * g.stage_bytes +
                                    g.y1_bytes);

  const int tid = threadIdx.x;
  // Per-phase clocks of thread 0 (clk != NULL; kClockSlots per block).
  const bool timed = clk != nullptr && tid == 0;
  long long* ck = timed ? clk + ((size_t)(blockIdx.z * gridDim.y +
                                           blockIdx.y) * gridDim.x +
                                 blockIdx.x) * kClockSlots
                        : nullptr;
  long long wait1 = 0, wait2 = 0, issue1 = 0, issue2 = 0;
  if (timed) {
    ck[0] = globaltimer();
    ck[1] = clock64();
  }
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.z;
  const int i0 = blockIdx.y * TH, j0 = (blockIdx.x / S) * TW;
  const int os = g.os, og_n = os / 4, c0 = rank * os;
  const T* xn = x + (size_t)img * H * W * C;
  const int TWp = TW + 1;

  // Input pixel offsets of the tile with its top/left halo (-1 outside).
  for (int m = tid; m < g.m1; m += kThreads) {
    const int i = i0 - 1 + m / TWp, j = j0 - 1 + m % TWp;
    pix[m] = (i >= 0 && i < H && j >= 0 && j < W) ? (i * W + j) * C : -1;
  }

  // This thread's phase-1 item: parity q, R1 input pixels (tile rows
  // 1 - di .. TH, cols 1 - dj .. TW; strided by the parity's group count),
  // output channels c0 + 4 og .. + 3.
  const int it1 = tid / og_n, og1 = tid % og_n;
  const bool act1 = tid < g.items1(R1);
  int q = 0, mq = 1, gq = 1, g1 = it1;
  if (act1) {
    for (q = 0; q < 4; ++q) {
      mq = (TH + (q >> 1)) * (TW + (q & 1));
      gq = (mq + R1 - 1) / R1;
      if (g1 < gq) break;
      g1 -= gq;
    }
  }
  const int di = q >> 1, dj = q & 1, qw = TW + dj;
  int xrow[R1];  // x chunk row of each pixel
  int ypos[R1];  // y1 tile pixel, or -1 for an empty slot
#pragma unroll
  for (int i = 0; i < R1; ++i) {
    const int p = g1 + i * gq;
    if (act1 && p < mq) {
      const int ii = p / qw + 1 - di, jj = p % qw + 1 - dj;
      xrow[i] = ii * TWp + jj;
      ypos[i] = (2 * ii + di - 1) * g.yw + 2 * jj + dj - 1;
    } else {
      xrow[i] = 0;
      ypos[i] = -1;
    }
  }

  // This thread's phase-2 item: R2 y2 pixels of the 2TH x 2TW tile.
  const int it2 = tid / og_n, og2 = tid % og_n;
  const int m2 = 4 * TH * TW, gp2 = (m2 + R2 - 1) / R2;
  const bool act2 = tid < g.items2(R2);
  // y1 tile offset of each pixel's own position (an empty slot reads the
  // first pixel's and writes nothing).
  int ybase[R2];
  bool yok[R2];
#pragma unroll
  for (int i = 0; i < R2; ++i) {
    const int p = it2 + i * gp2;
    yok[i] = act2 && p < m2;
    const int pp = yok[i] ? p : 0;
    ybase[i] = ((pp / (2 * TW) + 1) * g.yw + pp % (2 * TW) + 1) * g.ys;
  }
  __syncthreads();

  const int n1 = (C + CH - 1) / CH;
  const int per_tap = (O + g.ch2 - 1) / g.ch2;
  const int total = n1 + 4 * per_tap;
  const int gx = CH / g.ve;  // 16-byte copies per pixel row of a chunk
  const int gwr = os / g.ve; // 16-byte copies per weight row

  // The loader's copy indices advance by a fixed stride of kThreads
  // copies: (row, v) with v < gwr carried, no division per copy. CH and
  // gx are powers of two.
  const int lch = 31 - __clz(CH), lgx = 31 - __clz(gx);
  const int drow = kThreads / gwr, dv = kThreads - drow * gwr;
  const int row0 = tid / gwr, v0 = tid - row0 * gwr;
  auto load = [&](int step) {
    T* st = ring + (size_t)(step % kStages) * g.stage_elems;
    if (step < n1) {
      const int k0 = step * CH;
      for (int e = tid; e < g.m1 * gx; e += kThreads) {
        const int m = e >> lgx, k = k0 + (e & (gx - 1)) * g.ve;
        const int p = pix[m];
        const bool ok = p >= 0 && k < C;
        cp_async16(st + m * g.ldx + (k - k0), ok ? xn + p + k : x,
                   ok ? 16 : 0);
      }
      T* ws = st + g.m1 * g.ldx;
      for (int row = row0, v = v0; row < 4 * CH;) {
        const int qq = row >> lch, k = k0 + (row & (CH - 1));
        const bool ok = k < C;
        cp_async16(ws + row * os + v * g.ve,
                   ok ? w1 + ((size_t)(qq * C + k) * O + c0 + v * g.ve) : w1,
                   ok ? 16 : 0);
        row += drow;
        v += dv;
        if (v >= gwr) {
          v -= gwr;
          ++row;
        }
      }
    } else {
      const int s2 = step - n1, tap = s2 / per_tap;
      const int k0 = (s2 - tap * per_tap) * g.ch2;
      const int rows = O - k0 < g.ch2 ? O - k0 : g.ch2;
      for (int row = row0, v = v0; row < rows;) {
        cp_async16(st + row * os + v * g.ve,
                   w2 + ((size_t)(tap * O + k0 + row) * O + c0 + v * g.ve),
                   16);
        row += drow;
        v += dv;
        if (v >= gwr) {
          v -= gwr;
          ++row;
        }
      }
    }
  };

  float acc1[R1][4], acc2[R2][4];
#pragma unroll
  for (int i = 0; i < R1; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc1[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < R2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;

#pragma unroll
  for (int s0 = 0; s0 < kStages - 1; ++s0) {
    if (s0 < total) load(s0);
    cp_async_commit();
  }

  if (timed) ck[2] = clock64();
  for (int step = 0; step < total; ++step) {
    const long long tw0 = timed ? clock64() : 0;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (timed) (step < n1 ? wait1 : wait2) += clock64() - tw0;
    const long long ti0 = timed ? clock64() : 0;
    if (step + kStages - 1 < total) load(step + kStages - 1);
    cp_async_commit();
    if (timed) (step < n1 ? issue1 : issue2) += clock64() - ti0;
    const T* st = ring + (size_t)(step % kStages) * g.stage_elems;

    if (step < n1) {
      // Phase 1: acc1 += x chunk (R1 pixels) x w1[q] chunk (4 channels).
      if (act1) {
        const T* wq = st + g.m1 * g.ldx + q * CH * os + og1 * 4;
        const int kc = C - step * CH < CH ? C - step * CH : CH;
        const T* xp[R1];
#pragma unroll
        for (int i = 0; i < R1; ++i) xp[i] = st + xrow[i] * g.ldx;
        // Four channels a step (kc is a multiple of 4): the loads of a
        // step issue together, the FMAs keep channel order.
#pragma unroll 2
        for (int k = 0; k < kc; k += 4) {
          float4 b[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) b[u] = load4(wq + (k + u) * os);
#pragma unroll
          for (int i = 0; i < R1; ++i) fma4x4(acc1[i], load4(xp[i] + k), b);
        }
      }
      if (step == n1 - 1) {
        if (timed) ck[3] = clock64();
        // y1 of this rank's slice: own y1 tile (and device memory when
        // asked), zero where the input pixel lies outside the image.
        if (act1) {
#pragma unroll
          for (int i = 0; i < R1; ++i) {
            if (ypos[i] < 0) continue;
            const int yr = ypos[i] / g.yw, yc = ypos[i] - yr * g.yw;
            const bool ok = pix[xrow[i]] >= 0;
            const int gy = 2 * i0 - 1 + yr, gc = 2 * j0 - 1 + yc;
            const bool out = y1 != nullptr && ok && yr > 0 && yc > 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = c0 + og1 * 4 + j;
              const T v = ok ? from_f32<T>(lrelu(acc1[i][j] + to_f32(b1[c]),
                                                 slope))
                             : from_f32<T>(0.f);
              y1s[ypos[i] * g.ys + c] = v;
              if (out)
                y1[(((size_t)img * 2 * H + gy) * 2 * W + gc) * O + c] = v;
            }
          }
        }
        // Exchange: the peers' slices into this block's y1 tile.
        cluster.sync();
        if (timed) ck[4] = clock64();
        const int vpp = os / g.ve;  // 16-byte vectors per pixel slice
        for (int e = tid; e < (S - 1) * g.ny1 * vpp; e += kThreads) {
          const int pr = e / (g.ny1 * vpp), rest = e - pr * g.ny1 * vpp;
          const int peer = pr < rank ? pr : pr + 1;
          const int p = rest / vpp, v = rest - p * vpp;
          const size_t off = (size_t)p * g.ys + peer * os + v * g.ve;
          const T* src = cluster.map_shared_rank(y1s, peer);
          *reinterpret_cast<int4*>(y1s + off) =
              *reinterpret_cast<const int4*>(src + off);
        }
        cluster.sync();
        if (timed) ck[5] = clock64();
      }
    } else if (act2) {
      // Phase 2: acc2 += y1 (R2 pixels, tap-shifted) x w2[tap] chunk.
      const int s2 = step - n1, tap = s2 / per_tap;
      const int k0 = (s2 - tap * per_tap) * g.ch2;
      const int rows = O - k0 < g.ch2 ? O - k0 : g.ch2;
      const int toff = -((tap >> 1) * g.yw + (tap & 1)) * g.ys + k0;
      const T* wb = st + og2 * 4;
#pragma unroll 2
      for (int k = 0; k < rows; k += 4) {
        float4 b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) b[u] = load4(wb + (k + u) * os);
#pragma unroll
        for (int i = 0; i < R2; ++i)
          fma4x4(acc2[i], load4(y1s + ybase[i] + toff + k), b);
      }
    }
  }
  cp_async_wait<0>();

  if (act2) {
#pragma unroll
    for (int i = 0; i < R2; ++i) {
      if (!yok[i]) continue;
      const int p = it2 + i * gp2;
      const int rr = p / (2 * TW), ss = p % (2 * TW);
      const int gy = 2 * i0 + rr, gc = 2 * j0 + ss;
      if (gy >= 2 * H || gc >= 2 * W) continue;
      T* out = y2 + (((size_t)img * 2 * H + gy) * 2 * W + gc) * O + c0 +
               og2 * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[j] = from_f32<T>(
            lrelu(acc2[i][j] + to_f32(b2[c0 + og2 * 4 + j]), slope));
    }
  }
  if (timed) {
    ck[6] = clock64();
    ck[7] = wait1;
    ck[8] = wait2;
    ck[9] = globaltimer();
    ck[10] = issue1;
    ck[11] = issue2;
  }
}

// The least R in {1, 2, 4} whose items fit the block, or 0.
int pick_r(const Geo& g, bool phase1) {
  for (int r = 1; r <= kMaxR; r *= 2)
    if ((phase1 ? g.items1(r) : g.items2(r)) <= kThreads) return r;
  return 0;
}

template <typename T, int R1, int R2>
cudaError_t launch_r(const Geo& g, const void* x, const void* w1,
                     const void* b1, const void* w2, const void* b2, void* y2,
                     void* y1, int n, int h, int w, int c, float slope,
                     long long* clk, cudaStream_t stream) {
  auto kern = expand_split_kernel<T, R1, R2>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.s * ((w + g.tw - 1) / g.tw), (h + g.th - 1) / g.th, n);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y2), static_cast<T*>(y1), h,
      w, c, g.o, g.th, g.tw, g.s, g.ch, slope, clk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int R1>
cudaError_t launch_r1(int r2, const Geo& g, const void* x, const void* w1,
                      const void* b1, const void* w2, const void* b2,
                      void* y2, void* y1, int n, int h, int w, int c,
                      float slope, long long* clk, cudaStream_t s) {
  switch (r2) {
    case 1:
      return launch_r<T, R1, 1>(g, x, w1, b1, w2, b2, y2, y1, n, h, w, c,
                                slope, clk, s);
    case 2:
      return launch_r<T, R1, 2>(g, x, w1, b1, w2, b2, y2, y1, n, h, w, c,
                                slope, clk, s);
    default:
      return launch_r<T, R1, 4>(g, x, w1, b1, w2, b2, y2, y1, n, h, w, c,
                                slope, clk, s);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* y2, void* y1, int n,
                   int h, int w, int c, int o, int th, int tw, int s, int ch,
                   float slope, long long* clk, cudaStream_t stream) {
  const Geo g(th, tw, o, s, ch, (int)sizeof(T));
  // Every copy is 16 bytes: rows of x (C), of the channel slice (O/S) and
  // chunks (CH) must be whole 16-byte vectors, and the slice whole float4
  // groups of channels.
  if (th < 1 || tw < 1 || (s != 1 && s != 2 && s != 4 && s != 8) ||
      o % s != 0 || g.os % g.ve != 0 || g.os % 4 != 0 || c % g.ve != 0 ||
      ch < g.ve || (ch & (ch - 1)) != 0 || !aligned16(x) || !aligned16(w1) ||
      !aligned16(w2))
    return cudaErrorInvalidValue;
  const int r1 = pick_r(g, true), r2 = pick_r(g, false);
  if (r1 == 0 || r2 == 0) return cudaErrorInvalidValue;
  switch (r1) {
    case 1:
      return launch_r1<T, 1>(r2, g, x, w1, b1, w2, b2, y2, y1, n, h, w, c,
                             slope, clk, stream);
    case 2:
      return launch_r1<T, 2>(r2, g, x, w1, b1, w2, b2, y2, y1, n, h, w, c,
                             slope, clk, stream);
    default:
      return launch_r1<T, 4>(r2, g, x, w1, b1, w2, b2, y2, y1, n, h, w, c,
                             slope, clk, stream);
  }
}

}  // namespace

extern "C" {

// nlt_expand_split, with each block's per-phase clocks written to clk
// (kClockSlots int64 per block, blocks in launch order) when it is not
// NULL.
int nlt_expand_split_clocks(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* y2,
                            void* y1, int n, int h, int w, int c, int o,
                            int th, int tw, int s, int ch, float slope,
                            int is_bf16, void* clk, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto ck = static_cast<long long*>(clk);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, w1, b1, w2, b2, y2, y1, n,
                                               h, w, c, o, th, tw, s, ch,
                                               slope, ck, st)
                       : launch<float>(x, w1, b1, w2, b2, y2, y1, n, h, w, c,
                                       o, th, tw, s, ch, slope, ck, st));
}

// Returns the cudaError_t of the launch (0 = launched); the kernel runs
// asynchronously on `stream`. y1 may be NULL (not written). Tensors are
// contiguous NHWC / HWIO of one type (float32, or bfloat16 if is_bf16);
// x, w1 and w2 16-byte aligned. s: blocks per cluster (1, 2, 4, 8) and
// divisor of o; ch: input channels per chunk.
int nlt_expand_split(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* y2, void* y1,
                     int n, int h, int w, int c, int o, int th, int tw, int s,
                     int ch, float slope, int is_bf16, void* stream) {
  return nlt_expand_split_clocks(x, w1, b1, w2, b2, y2, y1, n, h, w, c, o,
                                 th, tw, s, ch, slope, is_bf16, nullptr,
                                 stream);
}

// Dynamic shared memory of one launch, as the launch computes it.
long long nlt_expand_split_smem_bytes(int th, int tw, int o, int s, int ch,
                                      int itemsize) {
  return (long long)Geo(th, tw, o, s, ch, itemsize).smem;
}

// Pixels per thread item of the launch's two products (R1, R2; 0 = does
// not fit 256 threads), as the launch picks them.
int nlt_expand_split_items(int th, int tw, int o, int s, int ch,
                           int itemsize, int phase) {
  const Geo g(th, tw, o, s, ch, itemsize);
  return pick_r(g, phase == 1);
}

const char* nlt_expand_split_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
