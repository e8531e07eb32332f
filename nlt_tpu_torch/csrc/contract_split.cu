// The fused contracting U-Net stage (K2) for the deep, low-resolution
// stages, as a thread-block cluster per tile, for Hopper (sm_90a), bound
// through a plain C interface (ctypes; nlt_tpu_torch/ops/fused_stage.py).
//
// It replaces, for the stages the wrapper routes here, the Pallas kernel
// _contract_kernel of nlt_tpu/ops/fused_stage.py (launched by
// _contract_fwd_pallas):
//   y1 = lrelu(conv_k2s2(x) + b1)
//   y2 = lrelu(conv_k2s1_SAME(y1) + b2)   taps look down-right, zero past
//                                         the bottom/right edge
// Activations NHWC, kernels HWIO, float32 or bfloat16. Products accumulate
// in float32 with FMA, in the order of csrc/fused_stage.cu's
// contract_kernel (phase 1: w1's rows (di, dj, c) ascending; phase 2: the
// taps, then channels), the bias (already in the activation type) is added
// in float32, and y1 and y2 are rounded to the activation type once each,
// after the activation. So the two routes agree bit for bit.
//
// What bounds it on the H100. The deep stages of the flagship U-Net
// (16^2 x 512 -> 256, 32^2 x 256 -> 256, 64^2 x 128 -> 128 at bs 1) do
// 17-50M multiply-adds, about 1.5 us of the card's float32 CUDA-core
// rate, and read under 3 MB. They are bound by latency: contract_kernel
// runs one 256-thread block per 2 x 4 tile of y2 (8 to 128 blocks on 132
// SMs), each block walks K = 4C in 16-wide chunks of scalar loads, two
// barriers apart, and recomputes the tile's y1 halo at the full K.
//
// Design. A cluster of S blocks (1, 2, 4, 8, or 16 where the card allows
// it) owns a TH x TW tile of y2 in one image; rank r owns output channels
// [r O/S, (r+1) O/S), so a stage with few tiles still fills the card.
//  - Phase 1 (k2s2 conv) runs per rank over its channel slice: y1 at the
//    tile and its bottom/right halo, (TH+1) x (TW+1) pixels, of which
//    only those inside the image are computed (the rest are zero). The
//    input of a y1 pixel is two rows of 2C contiguous elements of x (one
//    per di), so its K = 4C runs through w1's rows in order.
//  - Input and weight chunks (CH elements of K for the tile's pixels; CH
//    rows of the rank's w1 slice) stream through a ring of kStages
//    buffers in shared memory by cp.async (16-byte copies, zero-filled
//    past 4C), so the copies of chunks k+1 and k+2 are in flight while
//    chunk k is multiplied; one barrier per chunk.
//  - Each rank keeps its y1 slice, rounded, in its own full y1 tile, then
//    (cluster barrier) copies the peers' slices in through distributed
//    shared memory (map_shared_rank), and a second cluster barrier keeps
//    every block alive until its peers have read it.
//  - Phase 2 (k2s1 conv) per rank over its y2 channel slice, from the
//    full y1 tile, with w2's slice streamed through the same ring (its
//    first chunks are in flight during the exchange).
// Each thread owns R pixels x 4 channels of the current product (R is 1,
// 2 or 4, the least that lets 256 threads cover the full tile) and takes
// four input channels a step. A halo pixel costs a full 4C reduction, so
// the tile size trades clusters against recomputation (ops/
// fused_stage.py::_contract_split_plan routes the measured plans).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "split_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace nlt_split;

constexpr int kMaxS = 16;  // non-portable cluster size, where allowed

// The launch's geometry, shared by the host (shared-memory size, thread
// items) and the kernel. ops/fused_stage.py::_contract_split_geometry
// mirrors it.
struct Geo {
  int th, tw, o, s, ch, item;
  int os;    // O / S: the rank's channel slice
  int ve;    // elements per 16-byte copy
  int twp;   // y1 tile width TW + 1
  int m1;    // y1 tile pixels with the halo: (TH+1)(TW+1)
  int ldx;   // x chunk row stride: CH + one 16-byte pad
  int ys;    // y1 tile pixel stride: O + one 16-byte pad
  int ch2;   // w2 rows per phase-2 chunk: what a ring buffer holds
  size_t stage_elems, stage_bytes, y1_bytes, smem;

  __host__ __device__ Geo(int th_, int tw_, int o_, int s_, int ch_,
                          int item_)
      : th(th_), tw(tw_), o(o_), s(s_), ch(ch_), item(item_) {
    os = o / s;
    ve = 16 / item;
    twp = tw + 1;
    m1 = (th + 1) * twp;
    ldx = ch + ve;
    ys = o + ve;
    stage_elems = (size_t)m1 * ldx + (size_t)ch * os;
    const int rows = (int)(stage_elems / os) & ~3;
    ch2 = o < rows ? o : rows;
    stage_bytes = stage_elems * item;
    y1_bytes = ((size_t)m1 * ys * item + 15) / 16 * 16;
    smem = kStages * stage_bytes + y1_bytes + ((size_t)m1 * 4 + 15) / 16 * 16;
  }
  __host__ __device__ int items1(int r) const {
    return (m1 + r - 1) / r * (os / 4);
  }
  __host__ __device__ int items2(int r) const {
    return (th * tw + r - 1) / r * (os / 4);
  }
};

template <typename T, int R1, int R2>
__global__ void __launch_bounds__(kThreads)
    contract_split_kernel(const T* __restrict__ x, const T* __restrict__ w1,
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
  const int H2 = H / 2, W2 = W / 2;
  const int r0 = blockIdx.y * TH, q0 = (blockIdx.x / S) * TW;
  const int os = g.os, og_n = os / 4, c0 = rank * os;
  const int TWp = g.twp;
  const T* xn = x + (size_t)img * H * W * C;

  // The part of the y1 tile (with its halo) and of the y2 tile inside
  // the image: nh x nw pixels each, numbered row-major. Only these are
  // computed.
  const int nh1 = min(TH + 1, H2 - r0), nw1 = min(TWp, W2 - q0);
  const int nh2 = min(TH, H2 - r0), nw2 = min(TW, W2 - q0);
  const int nv1 = nh1 * nw1, nv2 = nh2 * nw2;
  // x offset of each computed y1 pixel's 2 x 2 patch.
  for (int m = tid; m < nv1; m += kThreads) {
    const int r = m / nw1, c = m - r * nw1;
    pix[m] = (2 * (r0 + r) * W + 2 * (q0 + c)) * C;
  }
  // The halo pixels outside the image read as zero in phase 2.
  if (nv1 < g.m1) {
    const int vpr = O / g.ve;
    for (int e = tid; e < g.m1 * vpr; e += kThreads) {
      const int p = e / vpr, v = e - p * vpr;
      const int r = p / TWp, c = p - r * TWp;
      if (r >= nh1 || c >= nw1)
        *reinterpret_cast<int4*>(y1s + (size_t)p * g.ys + v * g.ve) =
            make_int4(0, 0, 0, 0);
    }
  }

  // This thread's phase-1 item: R1 computed y1 pixels (strided by the
  // item count, so neighbouring threads take neighbouring pixels),
  // output channels c0 + 4 og .. + 3.
  const int gq1 = (nv1 + R1 - 1) / R1;
  const int it1 = tid / og_n, og1 = tid % og_n;
  const bool act1 = it1 < gq1;
  int xrow[R1];  // x chunk row of each pixel
  int ypos[R1];  // y1 tile pixel, or -1 for an empty slot
#pragma unroll
  for (int i = 0; i < R1; ++i) {
    const int p = it1 + i * gq1;
    if (act1 && p < nv1) {
      const int r = p / nw1;
      xrow[i] = p;
      ypos[i] = r * TWp + p - r * nw1;
    } else {
      xrow[i] = 0;
      ypos[i] = -1;
    }
  }

  // This thread's phase-2 item: R2 computed y2 pixels; y1 tile offset of
  // each pixel's own position (an empty slot reads the first pixel's and
  // writes nothing).
  const int gp2 = (nv2 + R2 - 1) / R2;
  const int it2 = tid / og_n, og2 = tid % og_n;
  const bool act2 = it2 < gp2;
  int ybase[R2];
  bool yok[R2];
#pragma unroll
  for (int i = 0; i < R2; ++i) {
    const int p = it2 + i * gp2;
    yok[i] = act2 && p < nv2;
    const int pp = yok[i] ? p : 0;
    const int r = pp / nw2;
    ybase[i] = (r * TWp + pp - r * nw2) * g.ys;
  }
  __syncthreads();

  const int K1 = 4 * C;  // phase 1's depth: w1's rows (di, dj, c)
  const int n1 = (K1 + CH - 1) / CH;
  const int per_tap = (O + g.ch2 - 1) / g.ch2;
  const int total = n1 + 4 * per_tap;
  const int gx = CH / g.ve;   // 16-byte copies per pixel row of a chunk
  const int gwr = os / g.ve;  // 16-byte copies per weight row
  // Row di = 1 of a patch starts W C - 2C elements after row di = 0 ends.
  const int two_c = 2 * C, jump = W * C - two_c;

  // The loader's copy indices advance by a fixed stride of kThreads
  // copies: (row, v) with v < gwr carried, no division per copy. gx is a
  // power of two.
  const int lgx = 31 - __clz(gx);
  const int drow = kThreads / gwr, dv = kThreads - drow * gwr;
  const int row0 = tid / gwr, v0 = tid - row0 * gwr;
  auto load = [&](int step) {
    T* st = ring + (size_t)(step % kStages) * g.stage_elems;
    if (step < n1) {
      const int k0 = step * CH;
      for (int e = tid; e < nv1 * gx; e += kThreads) {
        const int m = e >> lgx, k = k0 + (e & (gx - 1)) * g.ve;
        const bool ok = k < K1;
        cp_async16(st + m * g.ldx + (k - k0),
                   ok ? xn + pix[m] + k + (k >= two_c ? jump : 0) : x,
                   ok ? 16 : 0);
      }
      T* ws = st + g.m1 * g.ldx;
      for (int row = row0, v = v0; row < CH;) {
        const int k = k0 + row;
        const bool ok = k < K1;
        cp_async16(ws + row * os + v * g.ve,
                   ok ? w1 + ((size_t)k * O + c0 + v * g.ve) : w1,
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
      // Phase 1: acc1 += x chunk (R1 pixels) x w1 chunk (4 channels).
      if (act1) {
        const T* wq = st + g.m1 * g.ldx + og1 * 4;
        const int kc = K1 - step * CH < CH ? K1 - step * CH : CH;
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
        // y1 of this rank's slice: own y1 tile, and device memory when
        // asked (the tile's own pixels, not its halo).
        if (act1) {
#pragma unroll
          for (int i = 0; i < R1; ++i) {
            if (ypos[i] < 0) continue;
            const int r = ypos[i] / TWp, c = ypos[i] - r * TWp;
            const bool out = y1 != nullptr && r < TH && c < TW;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int ch = c0 + og1 * 4 + j;
              const T v =
                  from_f32<T>(lrelu(acc1[i][j] + to_f32(b1[ch]), slope));
              y1s[ypos[i] * g.ys + ch] = v;
              if (out)
                y1[(((size_t)img * H2 + r0 + r) * W2 + q0 + c) * O + ch] = v;
            }
          }
        }
        // Exchange: the peers' slices of the computed pixels into this
        // block's y1 tile.
        cluster.sync();
        if (timed) ck[4] = clock64();
        const int vpp = os / g.ve;  // 16-byte vectors per pixel slice
        for (int e = tid; e < (S - 1) * nv1 * vpp; e += kThreads) {
          const int pr = e / (nv1 * vpp), rest = e - pr * nv1 * vpp;
          const int peer = pr < rank ? pr : pr + 1;
          const int p = rest / vpp, v = rest - p * vpp;
          const int r = p / nw1;
          const size_t off = (size_t)(r * TWp + p - r * nw1) * g.ys +
                             peer * os + v * g.ve;
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
      const int toff = ((tap >> 1) * TWp + (tap & 1)) * g.ys + k0;
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
      const int r = p / nw2, c = p - r * nw2;
      T* out = y2 + (((size_t)img * H2 + r0 + r) * W2 + q0 + c) * O + c0 +
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

// The least R in {1, 2, 4} whose items fit the block, or 0. Phase 1's
// tile holds more pixels than phase 2's, so R2 <= R1; the launch has an
// instance for every pair a tile of powers of two gives.
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
  auto kern = contract_split_kernel<T, R1, R2>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
  if (err != cudaSuccess) return err;
  if (g.s > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.s * ((w / 2 + g.tw - 1) / g.tw),
                     (h / 2 + g.th - 1) / g.th, n);
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

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* y2, void* y1, int n,
                   int h, int w, int c, int o, int th, int tw, int s, int ch,
                   float slope, long long* clk, cudaStream_t stream) {
  const Geo g(th, tw, o, s, ch, (int)sizeof(T));
  // Every copy is 16 bytes: rows of x (C), of the channel slice (O/S) and
  // chunks (CH) must be whole 16-byte vectors, the slice whole float4
  // groups of channels, and one weight row at most one copy per thread.
  if (th < 1 || tw < 1 || h < 2 || w < 2 || h % 2 || w % 2 || s < 1 ||
      s > kMaxS || (s & (s - 1)) != 0 || o % s != 0 || g.os % g.ve != 0 ||
      g.os % 4 != 0 || g.os / g.ve > kThreads || c % g.ve != 0 ||
      ch < g.ve || (ch & (ch - 1)) != 0 || !aligned16(x) || !aligned16(w1) ||
      !aligned16(w2))
    return cudaErrorInvalidValue;
  const int r1 = pick_r(g, true), r2 = pick_r(g, false);
  auto go = [&](auto fn) {
    return fn(g, x, w1, b1, w2, b2, y2, y1, n, h, w, c, slope, clk, stream);
  };
  switch (r1 * 8 + r2) {
    case 1 * 8 + 1:
      return go(&launch_r<T, 1, 1>);
    case 2 * 8 + 1:
      return go(&launch_r<T, 2, 1>);
    case 2 * 8 + 2:
      return go(&launch_r<T, 2, 2>);
    case 4 * 8 + 1:
      return go(&launch_r<T, 4, 1>);
    case 4 * 8 + 2:
      return go(&launch_r<T, 4, 2>);
    default:  // R = 0: the product does not fit the block's threads; R2
              // = 4 needs a tile that is no power of two (6 x 6 at O/S =
              // 64), which no plan uses
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// nlt_contract_split, with each block's per-phase clocks written to clk
// (kClockSlots int64 per block, blocks in launch order) when it is not
// NULL.
int nlt_contract_split_clocks(const void* x, const void* w1, const void* b1,
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
// x, w1 and w2 16-byte aligned; h and w even. s: blocks per cluster (1,
// 2, 4, 8, 16) and divisor of o; ch: elements of K = 4c per chunk.
int nlt_contract_split(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* y2, void* y1,
                       int n, int h, int w, int c, int o, int th, int tw,
                       int s, int ch, float slope, int is_bf16,
                       void* stream) {
  return nlt_contract_split_clocks(x, w1, b1, w2, b2, y2, y1, n, h, w, c, o,
                                   th, tw, s, ch, slope, is_bf16, nullptr,
                                   stream);
}

// Dynamic shared memory of one launch, as the launch computes it.
long long nlt_contract_split_smem_bytes(int th, int tw, int o, int s, int ch,
                                        int itemsize) {
  return (long long)Geo(th, tw, o, s, ch, itemsize).smem;
}

// Pixels per thread item of the launch's two products (R1, R2; 0 = does
// not fit 256 threads), as the launch picks them.
int nlt_contract_split_items(int th, int tw, int o, int s, int ch,
                             int itemsize, int phase) {
  const Geo g(th, tw, o, s, ch, itemsize);
  return pick_r(g, phase == 1);
}

const char* nlt_contract_split_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
