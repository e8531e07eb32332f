// Fused U-Net stage kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; nlt_tpu_torch/ops/fused_stage.py).
//
// They replace the Pallas kernels of nlt_tpu/ops/fused_stage.py:
//   contract: _contract_kernel (launched by _contract_fwd_pallas)
//     y1 = lrelu(conv_k2s2(x) + b1)
//     y2 = lrelu(conv_k2s1_SAME(y1) + b2)   taps look down-right, zero past
//                                           the bottom/right edge
//   expand: _expand_kernel and _expand_kernel_packed (_expand_fwd_pallas)
//     y1 = lrelu(deconv_k2s2(x) + b1)
//     y2 = lrelu(deconv_k2s1(y1) + b2)      taps look up-left, zero before
//                                           the top/left edge
// Activations NHWC, kernels HWIO, float32 or bfloat16. Products accumulate
// in float32, the bias (already in the activation type) is added in
// float32, and y1 and y2 are rounded to the activation type once each,
// after the activation, where the Pallas kernels round them.
//
// Design. One block owns a TH x TW tile of one image: y2 pixels for
// contract, input pixels (2TH x 2TW y2 pixels) for expand. Phase 1
// computes y1 for the tile plus its one-pixel halo (the next row and
// column for contract, the previous ones for expand; zero outside the
// image) and keeps it, rounded, in shared memory. Phase 2 runs the four
// k2s1 taps from there and writes y2; y1 goes to device memory only when
// the caller asks for it. Both phases are one block-wide tiled product
// (tile_gemm): operand chunks of K = 16 staged in shared memory as
// float32, 4 x 4 outputs per thread accumulated in registers with FMA on
// the CUDA cores. BN (output channels per pass) and the tile are chosen
// per stage by the wrapper (ops/fused_stage.py::_plan); the input's
// channel depth is streamed through the K chunks, so a 1024-channel input
// costs no more shared memory than a 16-channel one.
//
// Bound on the card: per y2 pixel a contract stage reads 4C inputs and
// does 4CO + 4OO multiply-adds, so in bf16 its intensity is about
// O + O^2/C FLOP per byte. Against the H100's ~295 FLOP/byte ridge the
// thin high-resolution stages (O <= 64) are bound by bytes and the deep
// ones (O >= 256) by operations; expand stages are alike. This first
// version keeps y1 out of device memory, which is what the Pallas kernel
// exists for, and runs its products on the CUDA cores in float32: it is
// far from either bound. Tensor cores (mma/wgmma), TMA and cp.async
// pipelining are later work; chip_smoke.py prints each stage's time
// beside its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 16;               // K chunk staged per iteration
constexpr int kTile = kThreads * 16;  // BM * BN: 4 x 4 outputs per thread
constexpr int kPadA = 4;              // As row padding (bank spread)

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

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : slope * v;
}

__host__ __device__ inline int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

// Block-wide product over a pixel tile, BN = 1 << lbn output channels per
// pass (16 <= BN <= 1024, a power of two) and BM = kTile / BN pixels:
//   acc(m, n) = sum_s sum_{k < seglen} A(m, s, k) * b[bidx(s, k, n)]
//   A(m, s, k) = pix[m] < 0 ? 0 : a[pix[m] + seg[s] + k]
// for m < M, n < N; then epi(m, n, acc) for every output. `a` is device or
// shared memory; pix and seg hold element offsets.
template <int NSEG, typename T, typename BIdx, typename Epi>
__device__ __forceinline__ void tile_gemm(const T* a, const int* pix,
                                          const int* seg, int seglen, int M,
                                          const T* __restrict__ b, BIdx bidx,
                                          int N, int lbn, float* As,
                                          float* Bs, Epi epi) {
  const int BN = 1 << lbn;
  const int BM = kTile >> lbn;
  const int LDA = BM + kPadA;
  const int ltx = lbn - 2;  // TX = BN / 4 threads along N
  const int tid = threadIdx.x;
  const int tx = tid & ((1 << ltx) - 1), ty = tid >> ltx;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < NSEG; ++s) {
        const int sofs = seg[s];
        for (int k0 = 0; k0 < seglen; k0 += kKC) {
          for (int e = tid; e < BM * kKC; e += kThreads) {
            const int mm = e >> 4, kk = e & (kKC - 1);
            const int m = m0 + mm, k = k0 + kk;
            float v = 0.f;
            if (m < M && k < seglen) {
              const int p = pix[m];
              if (p >= 0) v = to_f32(a[p + sofs + k]);
            }
            As[kk * LDA + mm] = v;
          }
          for (int e = tid; e < kKC * BN; e += kThreads) {
            const int kk = e >> lbn, nn = e & (BN - 1);
            const int k = k0 + kk, n = n0 + nn;
            float v = 0.f;
            if (k < seglen && n < N) v = to_f32(b[bidx(s, k, n)]);
            Bs[kk * BN + nn] = v;
          }
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < kKC; ++kk) {
            const float4 av =
                *reinterpret_cast<const float4*>(&As[kk * LDA + ty * 4]);
            const float4 bv =
                *reinterpret_cast<const float4*>(&Bs[kk * BN + tx * 4]);
            const float ar[4] = {av.x, av.y, av.z, av.w};
            const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
          }
          __syncthreads();
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
          if (m < M && n < N) epi(m, n, acc[i][j]);
        }
    }
  }
}

// Shared memory: As | Bs | pix1 | pix2 | (16-byte aligned) y1 tile.
// ops/fused_stage.py::_smem_bytes mirrors this layout.
__host__ __device__ inline size_t head_bytes(int lbn1, int lbn2, int m1,
                                             int m2) {
  const int lmin = lbn1 < lbn2 ? lbn1 : lbn2;
  const int lmax = lbn1 < lbn2 ? lbn2 : lbn1;
  const size_t floats =
      (size_t)kKC * ((kTile >> lmin) + kPadA) + (size_t)kKC * (1 << lmax);
  const size_t head = 4 * (floats + m1 + m2);
  return (head + 15) / 16 * 16;
}

struct Smem {
  float* As;
  float* Bs;
  int* pix1;
  int* pix2;
  unsigned char* y1;
};

__device__ inline Smem carve(unsigned char* smem, int lbn1, int lbn2, int m1,
                             int m2) {
  const int lmin = lbn1 < lbn2 ? lbn1 : lbn2;
  Smem s;
  s.As = reinterpret_cast<float*>(smem);
  s.Bs = s.As + kKC * ((kTile >> lmin) + kPadA);
  s.pix1 = reinterpret_cast<int*>(
      s.Bs + kKC * (1 << (lbn1 < lbn2 ? lbn2 : lbn1)));
  s.pix2 = s.pix1 + m1;
  s.y1 = smem + head_bytes(lbn1, lbn2, m1, m2);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    contract_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const T* __restrict__ b1, const T* __restrict__ w2,
                    const T* __restrict__ b2, T* __restrict__ y2,
                    T* __restrict__ y1, int H, int W, int C, int O, int TH,
                    int TW, int lbn1, int lbn2, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H2 = H / 2, W2 = W / 2;
  const int TWp = TW + 1;
  const int M1 = (TH + 1) * TWp;  // y1 tile with its bottom/right halo
  const int M2 = TH * TW;         // y2 tile
  const Smem sm = carve(smem, lbn1, lbn2, M1, M2);
  T* y1s = reinterpret_cast<T*>(sm.y1);

  const int img = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const T* xn = x + (size_t)img * H * W * C;
  for (int m = threadIdx.x; m < M1; m += kThreads) {
    const int i = r0 + m / TWp, j = c0 + m % TWp;
    sm.pix1[m] = (i < H2 && j < W2) ? (2 * i * W + 2 * j) * C : -1;
  }
  for (int m = threadIdx.x; m < M2; m += kThreads) {
    const int r = m / TW, c = m % TW;
    sm.pix2[m] = (r0 + r < H2 && c0 + c < W2) ? (r * TWp + c) * O : -1;
  }
  __syncthreads();

  // k2s2 conv: w1 rows are (di, dj, c); for row parity di the (dj, c)
  // run of the 2x2 patch is 2C contiguous elements of x.
  const int seg1[2] = {0, W * C};
  tile_gemm<2>(
      xn, sm.pix1, seg1, 2 * C, M1, w1,
      [=](int s, int k, int n) { return (size_t)(s * 2 * C + k) * O + n; },
      O, lbn1, sm.As, sm.Bs, [&](int m, int o, float acc) {
        const bool ok = sm.pix1[m] >= 0;
        const T v = ok ? from_f32<T>(lrelu(acc + to_f32(b1[o]), slope))
                       : from_f32<T>(0.f);
        y1s[m * O + o] = v;
        if (y1 != nullptr && ok) {
          const int r = m / TWp, c = m % TWp;
          if (r < TH && c < TW)
            y1[(((size_t)img * H2 + r0 + r) * W2 + c0 + c) * O + o] = v;
        }
      });
  __syncthreads();

  // k2s1 SAME conv: taps (ei, ej) in w2's row order read y1[i+ei, j+ej].
  const int seg2[4] = {0, O, TWp * O, (TWp + 1) * O};
  tile_gemm<4>(
      y1s, sm.pix2, seg2, O, M2, w2,
      [=](int s, int k, int n) { return (size_t)(s * O + k) * O + n; }, O,
      lbn2, sm.As, sm.Bs, [&](int m, int p, float acc) {
        if (sm.pix2[m] < 0) return;
        const int r = m / TW, c = m % TW;
        y2[(((size_t)img * H2 + r0 + r) * W2 + c0 + c) * O + p] =
            from_f32<T>(lrelu(acc + to_f32(b2[p]), slope));
      });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    expand_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ b1, const T* __restrict__ w2,
                  const T* __restrict__ b2, T* __restrict__ y2,
                  T* __restrict__ y1, int H, int W, int C, int O, int TH,
                  int TW, int lbn1, int lbn2, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TWp = TW + 1;
  const int YW = 2 * TW + 1;      // y1 tile width: y2 columns + left halo
  const int M1 = (TH + 1) * TWp;  // input pixels incl. the top/left halo
  const int M2 = 4 * TH * TW;     // y2 tile (2TH x 2TW)
  const Smem sm = carve(smem, lbn1, lbn2, M1, M2);
  T* y1s = reinterpret_cast<T*>(sm.y1);

  const int img = blockIdx.z;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const T* xn = x + (size_t)img * H * W * C;
  for (int m = threadIdx.x; m < M1; m += kThreads) {
    const int i = i0 - 1 + m / TWp, j = j0 - 1 + m % TWp;
    sm.pix1[m] = (i >= 0 && i < H && j >= 0 && j < W) ? (i * W + j) * C : -1;
  }
  for (int m = threadIdx.x; m < M2; m += kThreads) {
    const int r = m / (2 * TW), s = m % (2 * TW);
    sm.pix2[m] = (2 * i0 + r < 2 * H && 2 * j0 + s < 2 * W)
                     ? ((r + 1) * YW + s + 1) * O
                     : -1;
  }
  __syncthreads();

  // k2s2 deconv: input pixel (i, j) emits y1[2i + di, 2j + dj] through
  // w1[di, dj]; the product's columns are n = (2 di + dj) O + o. The y1
  // tile starts one row and one column before the block's first y2 pixel,
  // so the halo input pixels contribute only their di = 1 / dj = 1 taps.
  const int seg1[1] = {0};
  tile_gemm<1>(
      xn, sm.pix1, seg1, C, M1, w1,
      [=](int, int k, int n) {
        const int q = n / O;
        return (size_t)(q * C + k) * O + (n - q * O);
      },
      4 * O, lbn1, sm.As, sm.Bs, [&](int m, int n, float acc) {
        const int q = n / O, o = n - q * O;
        const int di = q >> 1, dj = q & 1;
        const int r = m / TWp, c = m % TWp;
        const int yr = 2 * r + di - 1, yc = 2 * c + dj - 1;
        if (yr < 0 || yc < 0) return;
        const bool ok = sm.pix1[m] >= 0;
        const T v = ok ? from_f32<T>(lrelu(acc + to_f32(b1[o]), slope))
                       : from_f32<T>(0.f);
        y1s[(yr * YW + yc) * O + o] = v;
        if (y1 != nullptr && ok && r > 0 && c > 0)
          y1[(((size_t)img * 2 * H + 2 * (i0 - 1 + r) + di) * 2 * W +
              2 * (j0 - 1 + c) + dj) *
                 O +
             o] = v;
      });
  __syncthreads();

  // k2s1 deconv: taps (ei, ej) in w2's row order read y1[R - ei, S - ej].
  const int seg2[4] = {0, -O, -YW * O, -(YW + 1) * O};
  tile_gemm<4>(
      y1s, sm.pix2, seg2, O, M2, w2,
      [=](int s, int k, int n) { return (size_t)(s * O + k) * O + n; }, O,
      lbn2, sm.As, sm.Bs, [&](int m, int p, float acc) {
        if (sm.pix2[m] < 0) return;
        const int r = m / (2 * TW), s = m % (2 * TW);
        y2[(((size_t)img * 2 * H + 2 * i0 + r) * 2 * W + 2 * j0 + s) * O +
           p] = from_f32<T>(lrelu(acc + to_f32(b2[p]), slope));
      });
}

size_t smem_bytes(bool contract, int th, int tw, int o, int lbn1, int lbn2,
                  int itemsize) {
  const int m1 = (th + 1) * (tw + 1);
  const int m2 = contract ? th * tw : 4 * th * tw;
  const int my = contract ? m1 : (2 * th + 1) * (2 * tw + 1);
  return head_bytes(lbn1, lbn2, m1, m2) + (size_t)my * o * itemsize;
}

template <typename T, bool kContract>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* y2, void* y1, int n, int h, int w, int c,
           int o, int th, int tw, int bn1, int bn2, float slope,
           cudaStream_t stream) {
  const int lbn1 = ilog2(bn1), lbn2 = ilog2(bn2);
  if ((1 << lbn1) != bn1 || (1 << lbn2) != bn2 || bn1 < 16 || bn2 < 16 ||
      bn1 > 1024 || bn2 > 1024 || th < 1 || tw < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(kContract, th, tw, o, lbn1, lbn2, (int)sizeof(T));
  auto kern = kContract ? contract_kernel<T> : expand_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int gh = kContract ? h / 2 : h, gw = kContract ? w / 2 : w;
  const dim3 grid((gw + tw - 1) / tw, (gh + th - 1) / th, n);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y2), static_cast<T*>(y1), h,
      w, c, o, th, tw, lbn1, lbn2, slope);
  return (int)cudaGetLastError();
}

template <bool kContract>
int run(const void* x, const void* w1, const void* b1, const void* w2,
        const void* b2, void* y2, void* y1, int n, int h, int w, int c, int o,
        int th, int tw, int bn1, int bn2, float slope, int is_bf16,
        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16, kContract>(x, w1, b1, w2, b2, y2,
                                                    y1, n, h, w, c, o, th, tw,
                                                    bn1, bn2, slope, s)
                 : launch<float, kContract>(x, w1, b1, w2, b2, y2, y1, n, h,
                                            w, c, o, th, tw, bn1, bn2, slope,
                                            s);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = launched); the kernel runs
// asynchronously on `stream`. y1 may be NULL (not written). Tensors are
// contiguous NHWC / HWIO of one type (float32, or bfloat16 if is_bf16).
int nlt_contract_stage(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* y2, void* y1,
                       int n, int h, int w, int c, int o, int th, int tw,
                       int bn1, int bn2, float slope, int is_bf16,
                       void* stream) {
  return run<true>(x, w1, b1, w2, b2, y2, y1, n, h, w, c, o, th, tw, bn1, bn2,
                   slope, is_bf16, stream);
}

int nlt_expand_stage(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* y2, void* y1,
                     int n, int h, int w, int c, int o, int th, int tw,
                     int bn1, int bn2, float slope, int is_bf16,
                     void* stream) {
  return run<false>(x, w1, b1, w2, b2, y2, y1, n, h, w, c, o, th, tw, bn1,
                    bn2, slope, is_bf16, stream);
}

// Dynamic shared memory of one launch, as the launch computes it.
long long nlt_stage_smem_bytes(int contract, int th, int tw, int o, int bn1,
                               int bn2, int itemsize) {
  return (long long)smem_bytes(contract != 0, th, tw, o, ilog2(bn1),
                               ilog2(bn2), itemsize);
}

const char* nlt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
