// 2x2 stride-2 convolution + bias + LeakyReLU on Hopper (sm_90a), bound
// through a plain C interface (ctypes; nlt_tpu_torch/ops/conv_stage.py).
//
// It replaces the Pallas kernel of nlt_tpu/ops/conv_stage_pallas.py
// (_kernel, launched by conv2x2s2_lrelu):
//   y[n,i,j,o] = lrelu(b[o] + sum_{di,dj,c} x[n,2i+di,2j+dj,c] w[di,dj,c,o])
// with x (N, H, W, C) NHWC float32 (H, W even), w (2, 2, C, O) HWIO, b (O,)
// and y (N, H/2, W/2, O). Viewed as a matmul, each output pixel's 2x2
// patch is a row of K = 4C inputs and w is a (K, O) matrix whose row
// k = (2 di + dj) C + c; for a fixed di the patch's 2C inputs (dj, c) are
// contiguous in memory, so row k of a pixel sits at
//   x_base(pixel) + (k / 2C) W C + k % 2C.
//
// Design. The Pallas kernel splits the four taps with 4-D reshapes and
// sums four MXU matmuls over a VMEM row block; that is a TPU layout device
// and does not carry over. Here a block of 256 threads computes a tile of
// 64 output pixels x TO output channels (TO = 8, 16 or 32, the least that
// covers O, so thin outputs leave no thread idle), walking K in chunks of
// 32: the chunk's patch rows (64 x 32) and weight rows (32 x TO) are
// staged in shared memory with loads that run along C (coalesced), then
// every thread accumulates 64 TO / 256 outputs in float32 registers with
// FMAs, reading its weight column and broadcasting the patch row. Bias and
// LeakyReLU are applied in registers and the tile is written once. Any C
// and O work (C = 5, which Mosaic cannot tile, included); out-of-range
// pixels, channels and K rows are masked.
//
// Bound on the card. Each input element is read once and each output
// written once when O <= TO (one channel tile); at nlt_tpu's shapes
// (bs 4): 512^2 C 32 -> O 16 moves 151 MB for 1.07 GFLOP and 256^2 C 32 ->
// O 32 42 MB for 0.54 GFLOP, so both are bound by bytes (3.35 TB/s);
// 128^2 C 64 -> O 64 moves 21 MB for 0.54 GFLOP and is bound by float32
// operations (67 TFLOP/s; tensor cores are not used, as nlt_tpu's float32
// contract asks). The shared-memory staging makes every patch element
// reach the FMAs from one device-memory read per channel tile.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 64;   // output pixels per block
constexpr int kChunk = 32; // K rows per shared-memory stage

template <int TO>
__global__ void __launch_bounds__(kThreads)
    conv2x2s2_lrelu_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ b,
                           float* __restrict__ y, int n_pix, int h, int wd,
                           int c, int o, float slope) {
  constexpr int kRowsPerThread = kPix * TO / kThreads;  // pixels per thread
  constexpr int kPixStride = kThreads / TO;
  __shared__ float xs[kPix][kChunk + 1];
  __shared__ float ws[kChunk][TO];
  __shared__ long long pbase[kPix];

  const int tid = threadIdx.x;
  const int tx = tid % TO;  // output channel within the tile
  const int ty = tid / TO;  // first pixel row of this thread
  const int pix0 = blockIdx.x * kPix;
  const int o0 = blockIdx.y * TO;
  const int ho = h / 2, wo = wd / 2;
  const int k_total = 4 * c;
  const int two_c = 2 * c;
  const long long row_stride = static_cast<long long>(wd) * c;

  if (tid < kPix) {
    const int p = pix0 + tid;
    long long base = -1;
    if (p < n_pix) {
      const int nn = p / (ho * wo);
      const int r = p - nn * ho * wo;
      const int i = r / wo, j = r - (r / wo) * wo;
      base = ((static_cast<long long>(nn) * h + 2 * i) * wd + 2 * j) * c;
    }
    pbase[tid] = base;
  }

  float acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += kChunk) {
    __syncthreads();  // pbase ready / previous chunk consumed
    for (int e = tid; e < kPix * kChunk; e += kThreads) {
      const int p = e / kChunk, kk = e - p * kChunk;
      const int k = k0 + kk;
      const long long base = pbase[p];
      float v = 0.f;
      if (base >= 0 && k < k_total) {
        const int di = k / two_c;
        v = __ldg(x + base + di * row_stride + (k - di * two_c));
      }
      xs[p][kk] = v;
    }
    for (int e = tid; e < kChunk * TO; e += kThreads) {
      const int kk = e / TO, oo = e - kk * TO;
      const int k = k0 + kk;
      ws[kk][oo] = (k < k_total && o0 + oo < o)
                       ? __ldg(w + static_cast<long long>(k) * o + o0 + oo)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      const float wv = ws[kk][tx];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q)
        acc[q] = fmaf(xs[ty + q * kPixStride][kk], wv, acc[q]);
    }
  }

  const int oc = o0 + tx;
  if (oc >= o) return;
  const float bias = __ldg(b + oc);
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int p = pix0 + ty + q * kPixStride;
    if (p >= n_pix) continue;
    const float v = acc[q] + bias;
    y[static_cast<long long>(p) * o + oc] = v >= 0.f ? v : slope * v;
  }
}

template <int TO>
int launch(const float* x, const float* w, const float* b, float* y, int n,
           int h, int wd, int c, int o, float slope, cudaStream_t s) {
  const long long n_pix = static_cast<long long>(n) * (h / 2) * (wd / 2);
  if (n_pix == 0 || o == 0) return 0;
  dim3 grid(static_cast<unsigned>((n_pix + kPix - 1) / kPix),
            static_cast<unsigned>((o + TO - 1) / TO));
  conv2x2s2_lrelu_kernel<TO><<<grid, kThreads, 0, s>>>(
      x, w, b, y, static_cast<int>(n_pix), h, wd, c, o, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (n, h, wd, c) float32; w: (2, 2, c, o) float32; b: (o,) float32;
// y: (n, h/2, wd/2, o) float32; all contiguous on the device; h and wd
// even, n (h/2) (wd/2) < 2^31. Launches on `stream`; returns the
// cudaError_t of the launch (0 = launched).
int nlt_conv2x2s2_lrelu(const void* x, const void* w, const void* b, void* y,
                        int n, int h, int wd, int c, int o, float slope,
                        void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (o <= 8) return launch<8>(xp, wp, bp, yp, n, h, wd, c, o, slope, s);
  if (o <= 16) return launch<16>(xp, wp, bp, yp, n, h, wd, c, o, slope, s);
  return launch<32>(xp, wp, bp, yp, n, h, wd, c, o, slope, s);
}

const char* nlt_conv_stage_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
