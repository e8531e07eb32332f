// 2x2 stride-2 convolution + bias + LeakyReLU on Hopper (sm_90a), bound
// through a plain C interface (ctypes; nlt_tpu_torch/ops/conv_stage.py).
//
// It replaces the Pallas kernel of nlt_tpu/ops/conv_stage_pallas.py
// (_kernel, launched by conv2x2s2_lrelu):
//   y[n,i,j,o] = lrelu(b[o] + sum_{di,dj,c} x[n,2i+di,2j+dj,c] w[di,dj,c,o])
// with x (N, H, W, C) NHWC float32 (H, W even), w (2, 2, C, O) HWIO, b (O,)
// and y (N, H/2, W/2, O). It is a matrix product with no im2col copy:
// [N H/2 W/2, 4C] x [4C, O], where row k = (2 di + dj) C + c of a pixel's
// patch sits in one of two contiguous runs of 2C floats (one per di):
//   x_base(pixel) + (k < 2C ? k : W C + k - 2C).
//
// Bound on the card. nlt_tpu's shapes (bs 4): 512^2 C 32 -> O 16 moves
// 151 MB for 1.07 GFLOP and 256^2 C 32 -> O 32 42 MB for 0.54 GFLOP, both
// bound by bytes (3.35 TB/s); 128^2 C 64 -> O 64 moves 21 MB for 0.54
// GFLOP and is bound by float32 operations (67 TFLOP/s; no tensor cores,
// as nlt_tpu's float32 contract asks).
//
// Design. The Pallas kernel splits the four taps with 4-D reshapes and
// sums four MXU products over a VMEM row block, a TPU layout device. Here
// persistent blocks of 256 threads (as many as the SMs hold) each walk
// pixel tiles of TP pixels x TO = 4 OG output channels (TO <= 64, so for
// O <= 64 one block covers O and x is read from device memory once):
// - w, the block's (4C, TO) slice, is staged in shared memory once per
//   block, with zeros past C and O ("resident"); where it does not fit
//   beside the ring, each ring stage carries its 32 K rows of w instead;
// - each tile's patch rows stream in K chunks through a 3-stage cp.async
//   ring, 16-byte copies where 2C is a multiple of 4 floats, 8- or 4-byte
//   copies otherwise (odd C, an x off a 16-byte boundary), zero-filled
//   past K and past the last pixel; the ring runs across tiles, so the
//   next tile's loads fly under this tile's FMAs. A chunk is 64 K rows
//   (at C = 32 a pixel's whole 256-byte run in one stage, and half the
//   barriers) unless its larger stages would cut the blocks an SM holds,
//   then 32;
// - a thread holds PM pixels x 4 channels in registers (PM = 8 at TO = 64,
//   4 at TO = 16, 32): one float4 of x from shared memory feeds 16 FMAs,
//   one float4 of w feeds 4 PM; the one division per pixel (its row) is
//   taken once per stage by one thread, its base offset kept beside the
//   stage;
// - bias and LeakyReLU in registers, each output written once, float4
//   stores where O is a multiple of 4.
// Each output's sum is one thread's FMAs in K order (k = 0 .. 4C-1), as
// conv2x2s2_lrelu_ref's product is defined.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kSmemMax = 232448;   // a block's shared memory on the H100
constexpr int kSmemSM = 233472;    // an SM's, 1 KB of it reserved per block
// Clock slots a block writes when asked (nlt_conv2x2s2_lrelu_clocks):
// global ns at start; clock64 at start and at loop entry (w staging and
// the first stages issued); cycles thread 0 spent waiting for stages,
// issuing copies, in FMAs and in epilogues; clock64 and global ns at end.
constexpr int kClockSlots = 9;

// The launch plan; ops/conv_stage.py::launch_plan mirrors it.
struct Plan {
  int og;         // 4-channel groups per block (threads along O)
  int pm;         // pixels per thread
  int tp;         // pixels per tile (256 / og threads along pixels x pm)
  int vw;         // floats per x copy: 4, 2 or 1
  int kc;         // K rows per ring stage: 32 or 64
  int nkc;        // K chunks of kc rows
  int resident;   // w staged whole (else one K slice per ring stage)
  int o_tiles;    // blocks along O (grid.y)
  int pix_tiles;  // pixel tiles
  int smem;       // dynamic shared memory bytes
};

// The K chunk's share of the plan: chunks, the K-slice rule (w resident
// where it fits beside the ring) and the shared memory.
void set_chunk(Plan& p, int c, int kc) {
  p.kc = kc;
  p.nkc = (4 * c + kc - 1) / kc;
  if (p.nkc < 1) p.nkc = 1;
  const long long to = 4 * p.og;
  const long long stage =
      (long long)p.tp * (kc + 4) * 4 + (long long)p.tp * 8;
  const long long w_res = (long long)p.nkc * kc * to * 4;
  p.resident = w_res + kStages * stage <= kSmemMax;
  p.smem = static_cast<int>(p.resident ? w_res + kStages * stage
                                       : kStages * (stage + kc * to * 4));
}

int blocks_per_sm(int smem) {  // by shared memory, at most 2 (registers)
  const int b = kSmemSM / (smem + 1024);
  return b < 2 ? b : 2;
}

Plan make_plan(long long n_pix, int c, int o, uintptr_t x_addr) {
  Plan p;
  const int groups = (o + 3) / 4;
  p.og = 1;
  while (p.og < groups && p.og < 16) p.og *= 2;
  p.pm = p.og == 16 ? 8 : p.og >= 4 ? 4 : p.og;
  p.tp = kThreads / p.og * p.pm;
  p.vw = (2 * c) % 4 == 0 && x_addr % 16 == 0 ? 4 : x_addr % 8 == 0 ? 2 : 1;
  // Chunks of 64 K rows (a whole run of 2C floats at C = 32, half the
  // barriers) where K has more than 32 rows and an SM holds as many
  // blocks as with 32; else 32.
  set_chunk(p, c, 32);
  if (4 * c > 32) {
    Plan q = p;
    set_chunk(q, c, 64);
    if (blocks_per_sm(q.smem) >= blocks_per_sm(p.smem)) p = q;
  }
  const long long to = 4 * p.og;
  p.o_tiles = static_cast<int>((o + to - 1) / to);
  p.pix_tiles = static_cast<int>((n_pix + p.tp - 1) / p.tp);
  return p;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}
__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int OG, int PM, int VW, int KC>
__global__ void __launch_bounds__(kThreads, 2)
    conv2x2s2_lrelu_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ b,
                           float* __restrict__ y, int n_pix, int wo, int wd,
                           int c, int o, int nkc, int resident, int w_vec,
                           int y_vec, float slope, long long* clk) {
  constexpr int TO = 4 * OG;           // output channels per block
  constexpr int PT = kThreads / OG;    // threads along pixels
  constexpr int TP = PT * PM;          // pixels per tile
  constexpr int ROW = KC + 4;          // floats per staged pixel row
  constexpr int CPV = KC / VW;         // copies per staged pixel row
  constexpr int XS_BYTES = TP * ROW * 4;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int tx = tid % OG, ty = tid / OG;
  const bool timed = clk != nullptr && tid == 0;
  long long* ck = timed ? clk + (size_t)(blockIdx.y * gridDim.x + blockIdx.x)
                                    * kClockSlots
                        : nullptr;
  long long t_wait = 0, t_issue = 0, t_fma = 0, t_epi = 0, t0 = 0;
  if (timed) {
    ck[0] = globaltimer();
    ck[1] = clock64();
  }

  const int k_total = 4 * c, two_c = 2 * c;
  const long long row_stride = static_cast<long long>(wd) * c;
  const int o0 = blockIdx.y * TO;
  const int pix_tiles = static_cast<int>((n_pix + (long long)TP - 1) / TP);
  const int my_tiles =
      (int)blockIdx.x < pix_tiles
          ? (pix_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  const int total = my_tiles * nkc;
  const int w_bytes = resident ? nkc * KC * TO * 4 : 0;
  const int stage_bytes = XS_BYTES + (resident ? 0 : KC * TO * 4) + TP * 8;
  float* wres = reinterpret_cast<float*>(smem);
  auto stage = [&](int slot) { return smem + w_bytes + slot * stage_bytes; };
  auto tile_of = [&](int step) {
    return (int)blockIdx.x + (step / nkc) * (int)gridDim.x;
  };

  // K rows [k0, k0 + rows) of the block's w slice into dst (rows x TO),
  // zeros past K and O.
  auto load_w = [&](float* dst, int k0, int rows) {
    if (w_vec) {
      for (int e = tid; e < rows * OG; e += kThreads) {
        const int kk = e / OG, g = e % OG;
        const int k = k0 + kk, oc = o0 + 4 * g;
        const bool ok = k < k_total && oc < o;
        cp_async<16>(dst + kk * TO + 4 * g,
                     ok ? w + (long long)k * o + oc : w, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < rows * TO; e += kThreads) {
        const int kk = e / TO, oo = e % TO;
        const int k = k0 + kk, oc = o0 + oo;
        const bool ok = k < k_total && oc < o;
        cp_async<4>(dst + kk * TO + oo, ok ? w + (long long)k * o + oc : w,
                    ok ? 4 : 0);
      }
    }
  };
  // The base offset of each pixel of step's tile (-1 past the last).
  auto set_bases = [&](int step) {
    long long* pb =
        reinterpret_cast<long long*>(stage(step % kStages) + stage_bytes -
                                     TP * 8);
    const int tile = tile_of(step);
    for (int p = tid; p < TP; p += kThreads) {
      const int pix = tile * TP + p;
      long long base = -1;
      if (pix < n_pix) {
        const int r = pix / wo, j = pix - r * wo;
        base = (2LL * r * wd + 2LL * j) * c;
      }
      pb[p] = base;
    }
  };
  // Issue step's copies: the tile's K chunk (and w's K slice).
  auto issue = [&](int step) {
    unsigned char* st = stage(step % kStages);
    float* xs = reinterpret_cast<float*>(st);
    const long long* pb =
        reinterpret_cast<const long long*>(st + stage_bytes - TP * 8);
    const int k0 = (step % nkc) * KC;
    const int v = tid % CPV;
    const int k = k0 + v * VW;
    const bool kin = k < k_total;
    const long long koff = k < two_c ? k : row_stride + (k - two_c);
#pragma unroll
    for (int m = 0; m < TP * CPV / kThreads; ++m) {
      const int p = tid / CPV + m * (kThreads / CPV);
      const long long base = pb[p];
      const bool ok = kin && base >= 0;
      cp_async<VW * 4>(xs + p * ROW + v * VW, ok ? x + base + koff : x,
                       ok ? VW * 4 : 0);
    }
    if (!resident)
      load_w(reinterpret_cast<float*>(st + XS_BYTES), k0, KC);
  };

  float bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int oc = o0 + 4 * tx + j;
    bias[j] = oc < o ? __ldg(b + oc) : 0.f;
  }
  float acc[PM][4];
#pragma unroll
  for (int q = 0; q < PM; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[q][j] = 0.f;

  // Prologue: w (resident) joins the first group; kStages - 1 stages.
  if (resident && total > 0) load_w(wres, 0, nkc * KC);
  for (int s = 0; s < kStages - 1; ++s)
    if (s < total) set_bases(s);
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) issue(s);
    cp_async_commit();
  }
  if (timed) ck[2] = clock64();

  for (int step = 0; step < total; ++step) {
    if (timed) t0 = clock64();
    const bool ahead = step + kStages - 1 < total;
    if (ahead) set_bases(step + kStages - 1);
    if (timed) t_issue += clock64() - t0, t0 = clock64();
    cp_async_wait_one();
    __syncthreads();
    if (timed) t_wait += clock64() - t0, t0 = clock64();
    if (ahead) issue(step + kStages - 1);
    cp_async_commit();
    if (timed) t_issue += clock64() - t0, t0 = clock64();

    const int chunk = step % nkc;
    const unsigned char* st = stage(step % kStages);
    const float* xs = reinterpret_cast<const float*>(st);
    const float* ws = resident ? wres + chunk * KC * TO
                               : reinterpret_cast<const float*>(st + XS_BYTES);
#pragma unroll 2
    for (int kk = 0; kk < KC; kk += 4) {
      float4 wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wv[u] = *reinterpret_cast<const float4*>(ws + (kk + u) * TO + 4 * tx);
#pragma unroll
      for (int q = 0; q < PM; ++q) {
        const float4 a =
            *reinterpret_cast<const float4*>(xs + (ty + q * PT) * ROW + kk);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[q][0] = fmaf(av[u], wv[u].x, acc[q][0]);
          acc[q][1] = fmaf(av[u], wv[u].y, acc[q][1]);
          acc[q][2] = fmaf(av[u], wv[u].z, acc[q][2]);
          acc[q][3] = fmaf(av[u], wv[u].w, acc[q][3]);
        }
      }
    }
    if (timed) t_fma += clock64() - t0, t0 = clock64();

    if (chunk == nkc - 1) {
      const int tile = tile_of(step);
      const int oc = o0 + 4 * tx;
#pragma unroll
      for (int q = 0; q < PM; ++q) {
        const int pix = tile * TP + ty + q * PT;
        float r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = acc[q][j] + bias[j];
          r[j] = v >= 0.f ? v : slope * v;
          acc[q][j] = 0.f;
        }
        if (pix >= n_pix) continue;
        float* dst = y + (long long)pix * o + oc;
        if (y_vec && oc + 3 < o) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(r[0], r[1], r[2], r[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (oc + j < o) dst[j] = r[j];
        }
      }
      if (timed) t_epi += clock64() - t0;
    }
  }
  if (timed) {
    ck[3] = t_wait;
    ck[4] = t_issue;
    ck[5] = t_fma;
    ck[6] = t_epi;
    ck[7] = clock64();
    ck[8] = globaltimer();
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// One launch's operands.
struct Args {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  long long n_pix;
  int wd, c, o;
  float slope;
  long long* clk;
  cudaStream_t s;
};

template <int OG, int PM, int VW, int KC>
int launch_t(const Plan& p, const Args& a) {
  auto kernel = conv2x2s2_lrelu_kernel<OG, PM, VW, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Persistent blocks: as many as the SMs hold, none without a tile.
  long long gx = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                 sm_count() / p.o_tiles;
  if (gx < 1) gx = 1;
  if (gx > p.pix_tiles) gx = p.pix_tiles;
  const bool w_vec = a.o % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  const bool y_vec = a.o % 4 == 0 && reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  kernel<<<dim3(static_cast<unsigned>(gx), p.o_tiles), kThreads, p.smem,
           a.s>>>(a.x, a.w, a.b, a.y, static_cast<int>(a.n_pix), a.wd / 2,
                  a.wd, a.c, a.o, p.nkc, p.resident, w_vec, y_vec, a.slope,
                  a.clk);
  return static_cast<int>(cudaGetLastError());
}

template <int OG, int PM, int KC>
int launch_vw(const Plan& p, const Args& a) {
  if (p.vw == 4) return launch_t<OG, PM, 4, KC>(p, a);
  if (p.vw == 2) return launch_t<OG, PM, 2, KC>(p, a);
  return launch_t<OG, PM, 1, KC>(p, a);
}

template <int OG, int PM>
int launch_kc(const Plan& p, const Args& a) {
  if (p.kc == 64) return launch_vw<OG, PM, 64>(p, a);
  return launch_vw<OG, PM, 32>(p, a);
}

int launch(const void* x, const void* w, const void* b, void* y, int n,
           int h, int wd, int c, int o, float slope, long long* clk,
           cudaStream_t s) {
  const long long n_pix = static_cast<long long>(n) * (h / 2) * (wd / 2);
  if (n_pix == 0 || o == 0) return 0;
  const Plan p = make_plan(n_pix, c, o, reinterpret_cast<uintptr_t>(x));
  const Args a = {static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(b), static_cast<float*>(y),
                  n_pix, wd, c, o, slope, clk, s};
  switch (p.og) {  // pm as make_plan picks it for each og
    case 1: return launch_kc<1, 1>(p, a);
    case 2: return launch_kc<2, 2>(p, a);
    case 4: return launch_kc<4, 4>(p, a);
    case 8: return launch_kc<8, 4>(p, a);
    default: return launch_kc<16, 8>(p, a);
  }
}

}  // namespace

extern "C" {

// x: (n, h, wd, c) float32; w: (2, 2, c, o) float32; b: (o,) float32;
// y: (n, h/2, wd/2, o) float32; all contiguous on the device, x at least
// 4-byte aligned; h and wd even, n (h/2) (wd/2) < 2^31. Launches on
// `stream`; returns the cudaError_t of the launch (0 = launched).
int nlt_conv2x2s2_lrelu(const void* x, const void* w, const void* b, void* y,
                        int n, int h, int wd, int c, int o, float slope,
                        void* stream) {
  return launch(x, w, b, y, n, h, wd, c, o, slope, nullptr,
                static_cast<cudaStream_t>(stream));
}

// nlt_conv2x2s2_lrelu with thread 0 of every block writing kClockSlots
// int64 to clk at (blockIdx.y gridDim.x + blockIdx.x) kClockSlots; clk
// holds o_tiles x pix_tiles rows (a block past the grid writes none).
int nlt_conv2x2s2_lrelu_clocks(const void* x, const void* w, const void* b,
                               void* y, int n, int h, int wd, int c, int o,
                               float slope, void* clk, void* stream) {
  return launch(x, w, b, y, n, h, wd, c, o, slope,
                static_cast<long long*>(clk),
                static_cast<cudaStream_t>(stream));
}

// The launch plan for n_pix output pixels, C, O and x's address, as 11
// ints: og, pm, tp, vw, nkc, resident, o_tiles, pix_tiles, smem, ring
// stages, K rows per stage.
void nlt_conv_plan(long long n_pix, int c, int o, unsigned long long x_addr,
                   int* out) {
  const Plan p = make_plan(n_pix, c, o, static_cast<uintptr_t>(x_addr));
  const int v[11] = {p.og,     p.pm,      p.tp,        p.vw,
                     p.nkc,    p.resident, p.o_tiles,  p.pix_tiles,
                     p.smem,   kStages,    p.kc};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

const char* nlt_conv_stage_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
