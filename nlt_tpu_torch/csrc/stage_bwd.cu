// Backward of the fused U-Net stages (csrc/fused_stage.cu and the split
// kernels) for Hopper (sm_90a), bound through a plain C interface (ctypes;
// nlt_tpu_torch/ops/fused_stage.py, ContractStage / ExpandStage).
//
// nlt_tpu has no kernel here: its backward is XLA (_contract_bwd_xla /
// _expand_bwd_xla of nlt_tpu/ops/fused_stage.py), which the port's plain
// version (contract_stage_bwd / expand_stage_bwd) follows op for op. These
// kernels compute the same gradients from the tensors the forward saved
// (x, w1, w2, y1, y2) and the incoming gradient g:
//   dz2 = g * mask(y2)                    rounded to the activation type
//   dy1 = sum_taps shift(dz2) w2[tap]^T   (the forward's k2s1 adjoint)
//   dz1 = dy1 * mask(y1)                  float32
//   dx  = dz1 w1^T in the stage's index map, rounded to x's type
//   dw2[tap] = sum_pixels shift(y1)^T dz2, dw1[tap] = sum x^T dz1,
//   db2 = sum dz2, db1 = sum dz1          rounded to the params' type
// with mask(y) = y > 0 ? 1 : slope (slope in the activation type).
//
// Four to six launches a stage, on the caller's stream:
//   stage_dz1_kernel    a 64-pixel tile of y1's grid per block, an
//                       output-channel slice of dy1: dz2 on its tile and
//                       one-pixel halo, computed from g and y2 as it is
//                       staged, then the four taps' product, then the
//                       mask; writes dz1 (float32). dz2 and dy1 never go
//                       to device memory.
//   stage_dz1_sum_kernel  where the deep stages' few pixels leave the card
//                       idle, the dz1 product's K chunks are split over
//                       blocks (K slices) whose float32 shares of dy1 this
//                       adds in slice order before the mask.
//   stage_dx_kernel     dx = dz1 w1^T on a 64-pixel tile, an input-channel
//                       slice per block: the deep stages (1024-4096
//                       channels on 2^2-16^2 grids) spread over channels,
//                       which a launch that also formed dz1 could not.
//   stage_dx_sum_kernel the same K slices for dx, added in slice order.
//   stage_wgrad_kernel  the eight weight-gradient products (four taps of
//                       dw2, four of dw1), reduced over the pixels of a
//                       chunk of 64-pixel tiles, dz2 recomputed from g and
//                       y2; the column sums of dz2 and dz1 (db2, db1) on
//                       the way. One chunk writes the params' type
//                       directly; several write float32 partials.
//   stage_wgrad_sum_kernel  sums the partials in a fixed order and writes
//                       dw2, dw1, db2, db1 in the params' type.
// No floating-point atomics: two calls give the same bits.
//
// Arithmetic. Every product is the float32 product the plain version
// forms; only the order of the float32 sums differs. In bfloat16 the
// products run on the tensor cores (mma.sync m16n8k16, float32
// accumulators): x, y1, dz2, w1 and w2 hold bf16 values and enter as they
// are; the float32 operand dz1 enters as three bf16 terms hi + mid + lo
// (hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)), which carry
// all 24 bits, so each product with a bf16 operand is exact in float32.
// In float32 the same tiles run on the CUDA cores (FMA). No TF32.
//
// Staging. Every operand tile in shared memory is a set of rows, each a
// contiguous channel slice of one pixel (or of one weight row). A product
// reads its operand rows through a row map, so a tap's shifted view, a
// halo and the stride-2 index maps cost nothing but an index: ldmatrix
// takes one row address per lane (.trans where the rows run along K, the
// pixel dimension of the weight gradients).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps
constexpr int kBM = 64;        // pixels per tile (M of the data gradients,
                               // K of the weight gradients)
constexpr int kBK = 32;        // channels per K chunk of the data gradients
constexpr int kWM = 32;        // A channels per weight-gradient block

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int kPad = 4;    // row padding (16 bytes)
  static constexpr int kTerms = 1;  // terms a float32 operand enters as
  static constexpr int kMaxVec = 4;
};
template <>
struct Traits<bf16> {
  static constexpr int kPad = 8;
  static constexpr int kTerms = 3;
  static constexpr int kMaxVec = 8;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Geometry of one stage, by value to every kernel.
struct Geo {
  int n, h, w, c, o;  // x: (n, h, w, c); O output channels
  int hy, wy;         // y1 / y2 grid of one image
  int th, tw;         // 64-pixel tile of the y grid (rows of n * hy)
  int xth, xtw;       // 64-pixel tile of the x grid (expand)
  int vc, vo, vf;     // elements per copy: C rows, O rows, dz1 rows
  int gs;             // elements between two pixels of g (O if contiguous)
  float slope;        // the mask's slope, rounded to the activation type
};

// ---------------------------------------------------------------------------
// Copies of V elements (V * sizeof(T) bytes, aligned to that size up to 16)
// ---------------------------------------------------------------------------

template <int B>
struct Word;
template <>
struct Word<2> {
  using type = unsigned short;
};
template <>
struct Word<4> {
  using type = unsigned;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<16> {
  using type = uint4;
};

template <int V, typename T>
__device__ __forceinline__ void copy_vec(T* dst, const T* src) {
  constexpr int B = V * (int)sizeof(T);
  if constexpr (B > 16) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    using W = typename Word<B>::type;
    *reinterpret_cast<W*>(dst) = *reinterpret_cast<const W*>(src);
  }
}

// Calls f(V) with V a compile-time copy width: v in {8, 4, 2, 1}, at most
// Traits<T>::kMaxVec (the host checks both).
template <typename T, typename F>
__device__ __forceinline__ void by_vec(int v, F f) {
  if (v == 8 && Traits<T>::kMaxVec >= 8)
    f(std::integral_constant<int, (Traits<T>::kMaxVec >= 8 ? 8 : 1)>());
  else if (v == 4)
    f(std::integral_constant<int, 4>());
  else if (v == 2)
    f(std::integral_constant<int, 2>());
  else
    f(std::integral_constant<int, 1>());
}

// ---------------------------------------------------------------------------
// Staging: fill `rows` shared-memory rows of L elements (row r at dst + r *
// ld) with channels [c0, c0 + L) of the global row at element offset
// src_of(r) (-1: a zero row); channels at or past `lim` are zero. A thread
// keeps one column slice across calls (kThreads is a multiple of L / V), so
// `cs` (per-thread column sums, V used) stays its own.
// ---------------------------------------------------------------------------

template <int V, typename F>
__device__ __forceinline__ void for_vectors(int rows, int L, F f) {
  const int per = L / V, lp = __ffs(per) - 1;  // per: a power of two
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * per; e += kThreads)
    f(e >> lp, (e & (per - 1)) * V);
}

// Plain copy of a T tensor's rows.
template <int V, typename T, typename Src>
__device__ __forceinline__ void fill_plain(T* dst, int ld, int rows, int L,
                                           const T* __restrict__ src,
                                           Src src_of, int c0, int lim) {
  for_vectors<V>(rows, L, [&](int r, int cv) {
    alignas(16) T v[V];
    const long long off = src_of(r);
    if (off >= 0 && c0 + cv < lim) {
      copy_vec<V>(v, src + off + c0 + cv);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = from_f32<T>(0.f);
    }
    copy_vec<V>(dst + r * ld + cv, v);
  });
}

// dz2 = T(g * mask(y2)), as the plain version rounds it, from the pixel
// pix_of(r) (-1: a zero row) of y2 (O channels a pixel) and g (q.gs apart);
// column sums of the rounded values into cs when `sum`.
template <int V, typename T, typename Src>
__device__ __forceinline__ void fill_dz2(T* dst, int ld, int rows, int L,
                                         const T* __restrict__ g,
                                         const T* __restrict__ y2,
                                         const Geo& q, Src pix_of, int c0,
                                         bool sum, float (&cs)[8]) {
  const float slope = q.slope;
  for_vectors<V>(rows, L, [&](int r, int cv) {
    alignas(16) T gv[V], yv[V], d[V];
    const long long p = pix_of(r);
    if (p >= 0 && c0 + cv < q.o) {
      copy_vec<V>(gv, g + p * q.gs + c0 + cv);
      copy_vec<V>(yv, y2 + p * q.o + c0 + cv);
#pragma unroll
      for (int u = 0; u < V; ++u)
        d[u] = from_f32<T>(to_f32(gv[u]) * (to_f32(yv[u]) > 0.f ? 1.f : slope));
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) d[u] = from_f32<T>(0.f);
    }
    copy_vec<V>(dst + r * ld + cv, d);
    if (sum) {
#pragma unroll
      for (int u = 0; u < V; ++u) cs[u] += to_f32(d[u]);
    }
  });
}

// dz1 (float32) as Traits<T>::kTerms tiles `tstride` elements apart: itself
// in float32, hi / mid / lo in bf16. Column sums of the float32 values.
template <int V, typename T, typename Src>
__device__ __forceinline__ void fill_dz1(T* dst, int ld, int tstride, int rows,
                                         int L, const float* __restrict__ src,
                                         Src src_of, int c0, int lim, bool sum,
                                         float (&cs)[8]) {
  for_vectors<V>(rows, L, [&](int r, int cv) {
    alignas(16) float v[V];
    const long long off = src_of(r);
    if (off >= 0 && c0 + cv < lim) {
      copy_vec<V>(v, src + off + c0 + cv);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = 0.f;
    }
    if constexpr (Traits<T>::kTerms == 1) {
      copy_vec<V>(dst + r * ld + cv, reinterpret_cast<T*>(v));
    } else {
      alignas(16) T hi[V], mid[V], lo[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        hi[u] = __float2bfloat16_rn(v[u]);
        const float r1 = v[u] - __bfloat162float(hi[u]);
        mid[u] = __float2bfloat16_rn(r1);
        lo[u] = __float2bfloat16_rn(r1 - __bfloat162float(mid[u]));
      }
      copy_vec<V>(dst + r * ld + cv, hi);
      copy_vec<V>(dst + tstride + r * ld + cv, mid);
      copy_vec<V>(dst + 2 * tstride + r * ld + cv, lo);
    }
    if (sum) {
#pragma unroll
      for (int u = 0; u < V; ++u) cs[u] += v[u];
    }
  });
}

// ---------------------------------------------------------------------------
// One warp's k16 step: acc[nf] (16 x 8 outputs each) += A (16 x 16) B (16 x
// 8 NF). pa(m, k) / pb(k, n) give the shared-memory address of an element
// (m < 16, k < 16, n < 8 NF, all warp-local). kAT: A's rows run along k (m
// contiguous), else along m (k contiguous); kBT: B's rows run along k (n
// contiguous), else along n. A has kTA term tiles `ta` elements apart, B
// kTB tiles `tb` apart; every pair of terms is multiplied.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm2(unsigned (&r)[2], const void* p) {
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NF, bool kAT, bool kBT, int kTA, int kTB, typename T,
          typename PA, typename PB>
__device__ __forceinline__ void warp_k16(float (&acc)[NF][4], PA pa, PB pb,
                                         int ta, int tb) {
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
    // ldmatrix: lane l gives row l % 8 of 8x8 matrix l / 8.
    const int i = lane & 7, j = lane >> 3;
    unsigned a[kTA][4];
    const T* ap = kAT ? pa((j & 1) * 8, i + (j >> 1) * 8)
                      : pa(i + (j & 1) * 8, (j >> 1) * 8);
#pragma unroll
    for (int s = 0; s < kTA; ++s) ldsm4<kAT>(a[s], ap + s * ta);
    if constexpr (NF == 1) {
      const int jj = j & 1;
      const T* bp = kBT ? pb(i + jj * 8, 0) : pb(jj * 8, i);
#pragma unroll
      for (int s = 0; s < kTB; ++s) {
        unsigned b[2];
        ldsm2<kBT>(b, bp + s * tb);
#pragma unroll
        for (int u = 0; u < kTA; ++u) mma_bf16(acc[0], a[u], b[0], b[1]);
      }
    } else {
#pragma unroll
      for (int nf = 0; nf < NF; nf += 2) {
        const T* bp = kBT ? pb(i + (j & 1) * 8, nf * 8 + (j >> 1) * 8)
                          : pb((j & 1) * 8, nf * 8 + i + (j >> 1) * 8);
#pragma unroll
        for (int s = 0; s < kTB; ++s) {
          unsigned b[4];
          ldsm4<kBT>(b, bp + s * tb);
#pragma unroll
          for (int u = 0; u < kTA; ++u) {
            mma_bf16(acc[nf], a[u], b[0], b[1]);
            mma_bf16(acc[nf + 1], a[u], b[2], b[3]);
          }
        }
      }
    }
  } else {
    // float32: the same outputs per lane as the mma's accumulator layout
    // (rows lane/4 and lane/4 + 8, columns 2 (lane % 4) and the next).
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const float a0 = *pa(gq, k), a1 = *pa(gq + 8, k);
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) {
        const float b0 = *pb(k, nf * 8 + 2 * tq);
        const float b1 = *pb(k, nf * 8 + 2 * tq + 1);
        acc[nf][0] = fmaf(a0, b0, acc[nf][0]);
        acc[nf][1] = fmaf(a0, b1, acc[nf][1]);
        acc[nf][2] = fmaf(a1, b0, acc[nf][2]);
        acc[nf][3] = fmaf(a1, b1, acc[nf][3]);
      }
    }
  }
}

// Offset of pixel (R, j) of a grid of `cols` columns, times `ch`; -1 if the
// pixel is outside rows [0, rows) or columns [0, cols).
__device__ __forceinline__ long long pixel_off(int R, int j, int rows,
                                               int cols, int ch) {
  if (R < 0 || R >= rows || j < 0 || j >= cols) return -1;
  return ((long long)R * cols + j) * ch;
}

// r / d by a multiply and a shift, exact for 2 <= d <= 65 and 0 <= r < 1024
// (a halo tile's rows over its width plus one).
struct SmallDiv {
  int d, m;
  __device__ __forceinline__ explicit SmallDiv(int d_)
      : d(d_), m(65536 / d_ + 1) {}
  __device__ __forceinline__ int div(int r) const { return (r * m) >> 16; }
  __device__ __forceinline__ int mod(int r) const { return r - div(r) * d; }
};

// (i0 + d) mod hy for 0 <= i0 < hy, d >= 0: a subtraction where d < hy (one
// is true), else a division.
__device__ __forceinline__ int wrap(int i, int hy, bool one) {
  return one ? (i >= hy ? i - hy : i) : i % hy;
}

// The block's 64 x BN float32 results into shared memory (row m at st + m *
// ldst), from the accumulators of four warps of 16 rows each, for stores
// of whole rows.
template <int NF>
__device__ __forceinline__ void stage_acc(float* st, int ldst,
                                          const float (&acc)[NF][4]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int mb = (threadIdx.x >> 5) * 16;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(st + (mb + gq + 8 * hh) * ldst + f * 8 +
                                 2 * tq) =
          make_float2(acc[f][2 * hh], acc[f][2 * hh + 1]);
}

// ---------------------------------------------------------------------------
// dz1 = mask(y1) * sum_taps shift(dz2) w2[tap]^T: one 64-pixel tile of the
// y grid (rows of n * hy; a tile may hold rows of several images), BN
// channels of dz1 and one slice of the K chunks (blockIdx.z of gridDim.z)
// per block.
//   contract: dy1[i, j] = sum dz2[i - ei, j - ej] w2[ei, ej]^T (zero before
//             the top/left edge); the halo is the previous row and column.
//   expand:   dy1[i, j] = sum dz2[i + ei, j + ej] w2[ei, ej]^T (zero past
//             the bottom/right edge); the halo is the next row and column.
// With one slice the block writes dz1; with several (the deep stages, whose
// few pixels leave the card idle otherwise) it writes its slice's share of
// dy1 to dy1p, and stage_dz1_sum_kernel adds the slices and masks.
// ---------------------------------------------------------------------------

template <bool kContract, typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    stage_dz1_kernel(const T* __restrict__ g, const T* __restrict__ y2,
                     const T* __restrict__ y1, const T* __restrict__ w2,
                     float* __restrict__ dz1, float* __restrict__ dy1p,
                     Geo q) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = kBK + Traits<T>::kPad;
  constexpr int NF = BN / 8;
  const int TH = q.th, TW = q.tw, HW = TW + 1, O = q.o;
  const int nh = (TH + 1) * HW;  // halo rows; row nh is a zero row
  const int rows_y = q.n * q.hy;
  T* ah = reinterpret_cast<T*>(smem);
  T* bw = ah + (nh + 1) * LD;
  const int lt = __ffs(TW) - 1;  // TW: a power of two
  const int ntc = (q.wy + TW - 1) >> lt;
  const int R0 = (blockIdx.x / ntc) * TH, j0 = (blockIdx.x % ntc) * TW;
  const int i0 = R0 % q.hy;
  const bool one = q.hy >= TH;
  const int nb = blockIdx.y * BN;
  const int hr0 = kContract ? R0 - 1 : R0, hc0 = kContract ? j0 - 1 : j0;
  auto halo_pix = [&](int r) -> long long {
    if (r >= nh) return -1;
    return pixel_off(hr0 + r / HW, hc0 + r % HW, rows_y, q.wy, 1);
  };
  auto w_src = [&](int r) -> long long {
    const int t = r / BN, nn = nb + r % BN;
    return nn < O ? ((long long)t * O + nn) * O : -1;
  };
  // The halo row tap t reads for tile pixel m (nh: zero).
  auto arow = [&](int m, int t) -> int {
    const int mr = m >> lt, mc = m & (TW - 1), R = R0 + mr, j = j0 + mc;
    const int ei = t >> 1, ej = t & 1;
    if (R >= rows_y || j >= q.wy) return nh;
    const int i = wrap(i0 + mr, q.hy, one);
    if (kContract) {
      if (i - ei < 0 || j - ej < 0) return nh;
      return (mr + 1 - ei) * HW + mc + 1 - ej;
    }
    if (i + ei >= q.hy || j + ej >= q.wy) return nh;
    return (mr + ei) * HW + mc + ej;
  };
  const int mb = (threadIdx.x >> 5) * 16;
  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[f][u] = 0.f;
  float cs[8];
  const int nkc = (O + kBK - 1) / kBK, ks = gridDim.z, z = blockIdx.z;
  for (int kc = nkc * z / ks; kc < nkc * (z + 1) / ks; ++kc) {
    const int k0 = kc * kBK;
    by_vec<T>(q.vo, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      fill_dz2<V>(ah, LD, nh + 1, kBK, g, y2, q, halo_pix, k0, false, cs);
      fill_plain<V>(bw, LD, 4 * BN, kBK, w2, w_src, k0, O);
    });
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      for (int kb = 0; kb < kBK && k0 + kb < O; kb += 16) {
        warp_k16<NF, false, false, 1, 1, T>(
            acc,
            [&](int m, int k) { return ah + arow(mb + m, t) * LD + kb + k; },
            [&](int k, int n) { return bw + (t * BN + n) * LD + kb + k; }, 0,
            0);
      }
    }
    __syncthreads();
  }
  constexpr int LDS = BN + 4;
  float* st = reinterpret_cast<float*>(smem);
  stage_acc<NF>(st, LDS, acc);
  __syncthreads();
  const long long PO = (long long)rows_y * q.wy * O;
  by_vec<float>(q.vf, [&](auto vc) {
    constexpr int V = decltype(vc)::value;
    for_vectors<V>(kBM, BN, [&](int m, int cv) {
      const long long p =
          pixel_off(R0 + (m >> lt), j0 + (m & (TW - 1)), rows_y, q.wy, O);
      const int n = nb + cv;
      if (p < 0 || n >= O) return;
      alignas(16) float v[V];
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = st[m * LDS + cv + u];
      if (ks > 1) {
        copy_vec<V>(dy1p + z * PO + p + n, v);
        return;
      }
      alignas(16) T yv[V];
      copy_vec<V>(yv, y1 + p + n);
#pragma unroll
      for (int u = 0; u < V; ++u)
        v[u] *= to_f32(yv[u]) > 0.f ? 1.f : q.slope;
      copy_vec<V>(dz1 + p + n, v);
    });
  });
}

// dz1 = mask(y1) * the sum of the K slices' dy1, in slice order.
template <typename T>
__global__ void __launch_bounds__(256)
    stage_dz1_sum_kernel(const float* __restrict__ dy1p,
                         const T* __restrict__ y1, float* __restrict__ dz1,
                         long long po, int ks, float slope) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < po;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < ks; ++z) s += dy1p[z * po + e];
    dz1[e] = s * (to_f32(y1[e]) > 0.f ? 1.f : slope);
  }
}

// ---------------------------------------------------------------------------
// dx = dz1 w1^T: 64 pixels, BN input channels (of 4C for contract, of C for
// expand) and one slice of the K chunks (blockIdx.z of gridDim.z) per block.
//   contract: dx[2i + r, 2j + q, c] = sum_o dz1[i, j, o] w1[r, q, c, o];
//             a tile of the y grid, N = (r, q, c), K = O.
//   expand:   dx[i, j, c] = sum_{p, q, o} dz1[2i + p, 2j + q, o]
//             w1[p, q, c, o];
//             a tile of the x grid, its 2x2 y pixels staged, K = (p, q, o).
// With several K slices (the deep stages) a block writes its slice's share
// of dx in float32 to dxp, and stage_dx_sum_kernel adds the slices.
// ---------------------------------------------------------------------------

template <bool kContract, typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    stage_dx_kernel(const float* __restrict__ dz1, const T* __restrict__ w1,
                    T* __restrict__ dx, float* __restrict__ dxp, Geo q) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = kBK + Traits<T>::kPad;
  constexpr int NT = Traits<T>::kTerms;
  constexpr int NF = BN / 8;
  constexpr int ROWS = kContract ? kBM : 4 * kBM;  // dz1 rows staged
  constexpr int NB = kContract ? BN : 4 * BN;      // w1 rows staged
  const int O = q.o, C = q.c;
  const int rows_y = q.n * q.hy;
  const int TH = kContract ? q.th : q.xth, TW = kContract ? q.tw : q.xtw;
  const int gcols = kContract ? q.wy : q.w;
  T* at = reinterpret_cast<T*>(smem);
  T* bt = at + NT * ROWS * LD;
  const int lt = __ffs(TW) - 1;  // TW: a power of two
  const int ntc = (gcols + TW - 1) >> lt;
  const int R0 = (blockIdx.x / ntc) * TH, j0 = (blockIdx.x % ntc) * TW;
  const int nb = blockIdx.y * BN;
  const int ncols = kContract ? 4 * C : C;
  auto a_src = [&](int r) -> long long {
    if (kContract)
      return pixel_off(R0 + (r >> lt), j0 + (r & (TW - 1)), rows_y, q.wy, O);
    return pixel_off(2 * R0 + (r >> (lt + 1)), 2 * j0 + (r & (2 * TW - 1)),
                     rows_y,
                     q.wy, O);
  };
  auto b_src = [&](int r) -> long long {
    if (kContract) {
      const int nn = nb + r;
      return nn < ncols ? (long long)nn * O : -1;
    }
    const int t = r / BN, nn = nb + r % BN;
    return nn < C ? ((long long)t * C + nn) * O : -1;
  };
  // The staged dz1 row of tap t for tile pixel m.
  auto arow = [&](int m, int t) -> int {
    if (kContract) return m;
    return (2 * (m >> lt) + (t >> 1)) * (2 * TW) + 2 * (m & (TW - 1)) +
           (t & 1);
  };
  const int mb = (threadIdx.x >> 5) * 16;
  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[f][u] = 0.f;
  float cs[8];
  const int nkc = (O + kBK - 1) / kBK, ks = gridDim.z, z = blockIdx.z;
  for (int kc = nkc * z / ks; kc < nkc * (z + 1) / ks; ++kc) {
    const int k0 = kc * kBK;
    by_vec<float>(q.vf, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      fill_dz1<V, T>(at, LD, ROWS * LD, ROWS, kBK, dz1, a_src, k0, O, false,
                     cs);
    });
    by_vec<T>(q.vo, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      fill_plain<V>(bt, LD, NB, kBK, w1, b_src, k0, O);
    });
    __syncthreads();
#pragma unroll
    for (int t = 0; t < (kContract ? 1 : 4); ++t) {
      for (int kb = 0; kb < kBK && k0 + kb < O; kb += 16) {
        warp_k16<NF, false, false, NT, 1, T>(
            acc,
            [&](int m, int k) { return at + arow(mb + m, t) * LD + kb + k; },
            [&](int k, int n) { return bt + (t * BN + n) * LD + kb + k; },
            ROWS * LD, 0);
      }
    }
    __syncthreads();
  }
  // Whole rows of dx from shared memory: vc elements a copy (C % vc == 0,
  // so a copy never crosses from one (r, q) block of 4C into the next).
  constexpr int LDS = BN + 4;
  float* st = reinterpret_cast<float*>(smem);
  stage_acc<NF>(st, LDS, acc);
  __syncthreads();
  const int rows = kContract ? rows_y : q.n * q.h;
  const long long xel = (long long)q.n * q.h * q.w * C;
  by_vec<T>(q.vc, [&](auto vc) {
    constexpr int V = decltype(vc)::value;
    for_vectors<V>(kBM, BN, [&](int m, int cv) {
      const int R = R0 + (m >> lt), j = j0 + (m & (TW - 1)), nn = nb + cv;
      if (R >= rows || j >= gcols || nn >= ncols) return;
      long long off;
      if (kContract) {
        // x row 2R + r of the n * h rows (h = 2 hy).
        const int t = nn / C, c = nn - t * C;
        off = (((long long)2 * R + (t >> 1)) * q.w + 2 * j + (t & 1)) * C +
              c;
      } else {
        off = ((long long)R * q.w + j) * C + nn;
      }
      if (ks > 1) {
        alignas(16) float v[V];
#pragma unroll
        for (int u = 0; u < V; ++u) v[u] = st[m * LDS + cv + u];
        copy_vec<V>(dxp + z * xel + off, v);
        return;
      }
      alignas(16) T v[V];
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = from_f32<T>(st[m * LDS + cv + u]);
      copy_vec<V>(dx + off, v);
    });
  });
}

// dx = the sum of the K slices' shares, in slice order, in x's type.
template <typename T>
__global__ void __launch_bounds__(256)
    stage_dx_sum_kernel(const float* __restrict__ dxp, T* __restrict__ dx,
                        long long xel, int ks) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < xel; e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < ks; ++z) s += dxp[z * xel + e];
    dx[e] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// Weight gradients: C[t](m, n) = sum over the pixels of a chunk of 64-pixel
// tiles of A[t](pixel, m) B[t](pixel, n), for the four taps t at once.
//   which 0, dw2 (O x O): A = y1 at the forward's tap shift (contract:
//     y1[i + ei, j + ej], zero past the bottom/right; expand: y1[i - ei,
//     j - ej], zero before the top/left), B = dz2; pixels of the y grid.
//   which 1, dw1 (C x O): contract: A = x[2i + r, 2j + q], B = dz1[i, j]
//     (pixels of the y grid); expand: A = x[i, j], B = dz1[2i + p, 2j + q]
//     (pixels of the x grid).
// Blocks: (which, 32 A channels, BN B channels, chunk); a block of the first
// A-channel slice also sums B's columns (db2 for which 0, db1 for which 1).
// ---------------------------------------------------------------------------

template <int kWhich, bool kContract, typename T, int BN>
__device__ __forceinline__ void wgrad_block(
    unsigned char* smem, const T* __restrict__ x, const T* __restrict__ y1,
    const T* __restrict__ y2, const T* __restrict__ g,
    const float* __restrict__ dz1, T* __restrict__ dw, float* __restrict__ part,
    float* __restrict__ partb, const Geo& q, int tile, int chunk,
    int chunks) {
  constexpr int PAD = Traits<T>::kPad;
  constexpr int LDA = kWM + PAD, LDB = BN + PAD;
  constexpr int NT = Traits<T>::kTerms;
  constexpr int NTB = kWhich == 0 ? 1 : NT;
  constexpr int NF = BN / 16;
  // Staged rows: A (x region for contract dw1, y1 halo for dw2, own pixels
  // for expand dw1), B (dz1 region for expand dw1, own pixels otherwise).
  constexpr bool kARegion = kWhich == 1 && kContract;
  constexpr bool kBRegion = kWhich == 1 && !kContract;
  const int O = q.o, C = q.c;
  const int M = kWhich == 0 ? O : C;
  const int rows_y = q.n * q.hy;
  const bool xgrid = kWhich == 1 && !kContract;
  const int UT = xgrid ? q.xth : q.th, UW = xgrid ? q.xtw : q.tw;
  const int urows = xgrid ? q.n * q.h : rows_y, ucols = xgrid ? q.w : q.wy;
  const int HW = UW + 1;
  const int nh = (UT + 1) * HW;  // dw2's halo rows; row nh is a zero row
  const int arows = kWhich == 0 ? nh + 1 : (kARegion ? 4 * kBM : kBM);
  const int brows = kBRegion ? 4 * kBM : kBM;
  T* at = reinterpret_cast<T*>(smem);
  T* bt = at + arows * LDA;
  const int ntn = (O + BN - 1) / BN;
  const int m0 = (tile / ntn) * kWM, n0 = (tile % ntn) * BN;
  const int lu = __ffs(UW) - 1;  // UW: a power of two
  const int ntc = (ucols + UW - 1) >> lu;
  const int ntiles = ((urows + UT - 1) / UT) * ntc;
  const bool one = q.hy >= UT;
  const int kt0 = (int)((long long)ntiles * chunk / chunks);
  const int kt1 = (int)((long long)ntiles * (chunk + 1) / chunks);
  const bool sum = m0 == 0;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 16, wn = (warp >> 1) * (BN / 2);
  float acc[4][NF][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[t][f][u] = 0.f;
  float cs[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) cs[u] = 0.f;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int R0 = (kt / ntc) * UT, j0 = (kt % ntc) * UW;
    const int i0 = kWhich == 0 ? R0 % q.hy : 0;
    // Sources.
    auto own = [&](int r) -> long long {  // the tile's pixels
      return pixel_off(R0 + (r >> lu), j0 + (r & (UW - 1)), urows, ucols,
                       kWhich == 1 && !kContract ? C : O);
    };
    if (kWhich == 0) {
      const int hr0 = kContract ? R0 : R0 - 1, hc0 = kContract ? j0 : j0 - 1;
      const SmallDiv hw(HW);
      auto halo = [&](int r) -> long long {
        if (r >= nh) return -1;
        return pixel_off(hr0 + hw.div(r), hc0 + hw.mod(r), rows_y, q.wy, O);
      };
      auto own_pix = [&](int r) -> long long {
        return pixel_off(R0 + (r >> lu), j0 + (r & (UW - 1)), rows_y, q.wy,
                         1);
      };
      by_vec<T>(q.vo, [&](auto vc) {
        constexpr int V = decltype(vc)::value;
        fill_plain<V>(at, LDA, arows, kWM, y1, halo, m0, O);
        fill_dz2<V>(bt, LDB, brows, BN, g, y2, q, own_pix, n0, sum, cs);
      });
    } else if (kContract) {
      auto region = [&](int r) -> long long {  // x pixels of the tile
        return pixel_off(2 * R0 + (r >> (lu + 1)), 2 * j0 + (r & (2 * UW - 1)),
                         q.n * q.h, q.w, C);
      };
      auto own_o = [&](int r) -> long long {
        return pixel_off(R0 + (r >> lu), j0 + (r & (UW - 1)), rows_y, q.wy,
                         O);
      };
      by_vec<T>(q.vc, [&](auto vc) {
        constexpr int V = decltype(vc)::value;
        fill_plain<V>(at, LDA, arows, kWM, x, region, m0, C);
      });
      by_vec<float>(q.vf, [&](auto vc) {
        constexpr int V = decltype(vc)::value;
        fill_dz1<V, T>(bt, LDB, brows * LDB, brows, BN, dz1, own_o, n0, O, sum,
                       cs);
      });
    } else {
      auto region = [&](int r) -> long long {  // y pixels of the tile
        return pixel_off(2 * R0 + (r >> (lu + 1)), 2 * j0 + (r & (2 * UW - 1)),
                         rows_y, q.wy, O);
      };
      by_vec<T>(q.vc, [&](auto vc) {
        constexpr int V = decltype(vc)::value;
        fill_plain<V>(at, LDA, arows, kWM, x, own, m0, C);
      });
      by_vec<float>(q.vf, [&](auto vc) {
        constexpr int V = decltype(vc)::value;
        fill_dz1<V, T>(bt, LDB, brows * LDB, brows, BN, dz1, region, n0, O,
                       sum, cs);
      });
    }
    __syncthreads();
    // Row maps: the staged A / B row of tile pixel k at tap t.
    auto arow = [&](int k, int t) -> int {
      const int kr = k >> lu, kc = k & (UW - 1);
      if (kWhich == 1) {
        if (!kContract) return k;
        return (2 * kr + (t >> 1)) * (2 * UW) + 2 * kc + (t & 1);
      }
      const int R = R0 + kr, j = j0 + kc, ei = t >> 1, ej = t & 1;
      if (R >= rows_y || j >= q.wy) return nh;
      const int i = wrap(i0 + kr, q.hy, one);
      if (kContract) {
        if (i + ei >= q.hy || j + ej >= q.wy) return nh;
        return (kr + ei) * HW + kc + ej;
      }
      if (i - ei < 0 || j - ej < 0) return nh;
      return (kr + 1 - ei) * HW + kc + 1 - ej;
    };
    auto brow = [&](int k, int t) -> int {
      if (!kBRegion) return k;
      return (2 * (k >> lu) + (t >> 1)) * (2 * UW) + 2 * (k & (UW - 1)) +
             (t & 1);
    };
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int kb = 0; kb < kBM; kb += 16) {
        warp_k16<NF, true, true, 1, NTB, T>(
            acc[t],
            [&](int m, int k) { return at + arow(kb + k, t) * LDA + wm + m; },
            [&](int k, int n) { return bt + brow(kb + k, t) * LDB + wn + n; },
            0, brows * LDB);
      }
    }
    __syncthreads();
  }
  // The weight gradient (or this chunk's partial), a tap at a time through
  // shared memory, in whole rows of BN channels.
  const bool direct = chunks == 1;
  const long long E = 4LL * M * O;
  constexpr int LDS = BN + 4;
  float* st = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(st + (wm + gq + 8 * hh) * LDS + wn + f * 8 +
                                   2 * tq) =
            make_float2(acc[t][f][2 * hh], acc[t][f][2 * hh + 1]);
    __syncthreads();
    by_vec<T>(q.vo, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      for_vectors<V>(kWM, BN, [&](int r, int cv) {
        const int m = m0 + r, n = n0 + cv;
        if (m >= M || n >= O) return;
        const long long off = ((long long)t * M + m) * O + n;
        if (direct) {
          alignas(16) T v[V];
#pragma unroll
          for (int u = 0; u < V; ++u) v[u] = from_f32<T>(st[r * LDS + cv + u]);
          copy_vec<V>(dw + off, v);
        } else {
          alignas(16) float v[V];
#pragma unroll
          for (int u = 0; u < V; ++u) v[u] = st[r * LDS + cv + u];
          copy_vec<V>(part + chunk * E + off, v);
        }
      });
    });
    __syncthreads();
  }
  if (!sum) return;
  // B's column sums: thread th holds columns (th % per) * V ... + V - 1.
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int u = 0; u < 8; ++u) red[threadIdx.x * 8 + u] = cs[u];
  __syncthreads();
  const int v = kWhich == 0 ? q.vo : q.vf;
  const int per = BN / v;
  if (threadIdx.x < BN) {
    const int nn = threadIdx.x, col = nn / v, u = nn % v;
    float s = 0.f;
    for (int th = col; th < kThreads; th += per) s += red[th * 8 + u];
    if (n0 + nn < O)
      partb[(long long)chunk * O + n0 + nn] = s;
  }
}

// Blocks: tiles2 * chunks2 of dw2 first, then those of dw1. Partials, each
// chunk-major: part holds dw2's (chunks2 x 4 O O) then dw1's (chunks1 x
// 4 C O); partb db2's (chunks2 x O) then db1's (chunks1 x O).
template <bool kContract, typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    stage_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ y1,
                       const T* __restrict__ y2, const T* __restrict__ g,
                       const float* __restrict__ dz1, T* __restrict__ dw1,
                       T* __restrict__ dw2, float* __restrict__ part,
                       float* __restrict__ partb, Geo q, int tiles2,
                       int chunks2, int chunks1) {
  extern __shared__ __align__(16) unsigned char smem[];
  int b = blockIdx.x;
  if (b < tiles2 * chunks2) {
    wgrad_block<0, kContract, T, BN>(smem, x, y1, y2, g, dz1, dw2, part, partb,
                                     q, b / chunks2, b % chunks2, chunks2);
  } else {
    b -= tiles2 * chunks2;
    wgrad_block<1, kContract, T, BN>(
        smem, x, y1, y2, g, dz1, dw1,
        part == nullptr ? nullptr : part + chunks2 * 4LL * q.o * q.o,
        partb + (long long)chunks2 * q.o, q, b / chunks1, b % chunks1,
        chunks1);
  }
}

// Sums the partials in a fixed order: dw2 (if chunks2 > 1), dw1 (if chunks1
// > 1), db2 and db1, each in the params' type. 64 outputs a block; thread
// group k (of four) adds chunks k, k + 4, ... in order, then the four sums
// are added in group order.
template <typename T>
__global__ void __launch_bounds__(256)
    stage_wgrad_sum_kernel(const float* __restrict__ part,
                           const float* __restrict__ partb,
                           T* __restrict__ dw2, T* __restrict__ dw1,
                           T* __restrict__ db2, T* __restrict__ db1, int O,
                           int C, int chunks2, int chunks1) {
  __shared__ float red[4][64];
  const long long e2 = 4LL * O * O, e1 = 4LL * C * O;
  const long long s2 = chunks2 > 1 ? e2 : 0, s1 = chunks1 > 1 ? e1 : 0;
  const long long total = s2 + s1 + 2LL * O;
  const int lane = threadIdx.x & 63, grp = threadIdx.x >> 6;
  for (long long base = blockIdx.x * 64LL; base < total;
       base += gridDim.x * 64LL) {
    const long long e = base + lane;
    const float* src = nullptr;
    long long stride = 0, i = 0;
    int nch = 0, seg = 0;
    if (e < s2) {
      src = part, stride = e2, i = e, nch = chunks2, seg = 0;
    } else if (e < s2 + s1) {
      i = e - s2;
      src = part + chunks2 * e2, stride = e1, nch = chunks1, seg = 1;
    } else if (e < s2 + s1 + O) {
      i = e - s2 - s1;
      src = partb, stride = O, nch = chunks2, seg = 2;
    } else if (e < total) {
      i = e - s2 - s1 - O;
      src = partb + (long long)chunks2 * O, stride = O, nch = chunks1,
      seg = 3;
    }
    float s = 0.f;
#pragma unroll 4
    for (int c = grp; c < nch; c += 4) s += src[c * stride + i];
    red[grp][lane] = s;
    __syncthreads();
    if (grp == 0 && e < total) {
      const float v =
          ((red[0][lane] + red[1][lane]) + red[2][lane]) + red[3][lane];
      if (seg == 0)
        dw2[i] = from_f32<T>(v);
      else if (seg == 1)
        dw1[i] = from_f32<T>(v);
      else if (seg == 2)
        db2[i] = from_f32<T>(v);
      else
        db1[i] = from_f32<T>(v);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Dynamic shared memory of each kernel (0: dz1, 1: dx, 2: weight gradients)
// under a plan: the staged operands or the staged results, whichever is
// larger.
size_t smem_bytes(int kernel, bool contract, int itemsize, int th, int tw,
                  int bn) {
  const bool b16 = itemsize == 2;
  const int pad = b16 ? 8 : 4, nt = b16 ? 3 : 1;
  const size_t ld = kBK + pad;
  size_t s, out;
  if (kernel == 0) {
    s = ((size_t)(th + 1) * (tw + 1) + 1 + 4 * bn) * ld * itemsize;
    out = (size_t)kBM * (bn + 4) * sizeof(float);
  } else if (kernel == 1) {
    s = contract ? ((size_t)nt * kBM + bn) * ld * itemsize
                 : ((size_t)nt * 4 * kBM + 4 * bn) * ld * itemsize;
    out = (size_t)kBM * (bn + 4) * sizeof(float);
  } else {
    const size_t lda = kWM + pad, ldb = bn + pad;
    const size_t w2 = ((size_t)(th + 1) * (tw + 1) + 1) * lda + kBM * ldb;
    const size_t w1 = contract ? 4 * kBM * lda + (size_t)nt * kBM * ldb
                               : kBM * lda + (size_t)nt * 4 * kBM * ldb;
    s = (w2 > w1 ? w2 : w1) * itemsize;
    const size_t rows = (size_t)kWM * (bn + 4) * sizeof(float);
    const size_t red = kThreads * 8 * sizeof(float);
    out = rows > red ? rows : red;
  }
  s = (s + 15) / 16 * 16;
  return s > out ? s : out;
}

template <typename K, typename... A>
cudaError_t launch_k(K kern, dim3 grid, size_t smem, cudaStream_t s,
                     A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

struct Bufs {
  const void *x, *w1, *w2, *y1, *y2, *g;
  void *dx, *dw1, *db1, *dw2, *db2;
  float *dz1, *dy1p, *dxp, *part, *partb;
};

struct Plan {
  int bn_dz1, bn_dx, bn_w, ks, ksx, chunks2, chunks1;
};

int blocks_for(long long elems, int per_block) {
  const long long b = (elems + per_block - 1) / per_block;
  return (int)(b < 8 * 132 ? (b > 0 ? b : 1) : 8 * 132);
}

template <bool kContract, typename T, int BN>
cudaError_t run_dz1(const Bufs& p, const Geo& q, int ks, cudaStream_t s) {
  const int tiles =
      ((q.n * q.hy + q.th - 1) / q.th) * ((q.wy + q.tw - 1) / q.tw);
  const dim3 grid(tiles, (q.o + BN - 1) / BN, ks);
  return launch_k(stage_dz1_kernel<kContract, T, BN>, grid,
                  smem_bytes(0, kContract, sizeof(T), q.th, q.tw, BN), s,
                  static_cast<const T*>(p.g), static_cast<const T*>(p.y2),
                  static_cast<const T*>(p.y1), static_cast<const T*>(p.w2),
                  p.dz1, p.dy1p, q);
}

template <bool kContract, typename T, int BN>
cudaError_t run_dx(const Bufs& p, const Geo& q, int ksx, cudaStream_t s) {
  const int tiles =
      kContract
          ? ((q.n * q.hy + q.th - 1) / q.th) * ((q.wy + q.tw - 1) / q.tw)
          : ((q.n * q.h + q.xth - 1) / q.xth) * ((q.w + q.xtw - 1) / q.xtw);
  const int ncols = kContract ? 4 * q.c : q.c;
  const dim3 grid(tiles, (ncols + BN - 1) / BN, ksx);
  return launch_k(stage_dx_kernel<kContract, T, BN>, grid,
                  smem_bytes(1, kContract, sizeof(T), q.th, q.tw, BN), s,
                  static_cast<const float*>(p.dz1),
                  static_cast<const T*>(p.w1), static_cast<T*>(p.dx), p.dxp,
                  q);
}

template <bool kContract, typename T, int BN>
cudaError_t run_wgrad(const Bufs& p, const Geo& q, const Plan& pl,
                      cudaStream_t s) {
  const int ntn = (q.o + BN - 1) / BN;
  const int tiles2 = ((q.o + kWM - 1) / kWM) * ntn;
  const int tiles1 = ((q.c + kWM - 1) / kWM) * ntn;
  const dim3 grid(tiles2 * pl.chunks2 + tiles1 * pl.chunks1);
  return launch_k(stage_wgrad_kernel<kContract, T, BN>, grid,
                  smem_bytes(2, kContract, sizeof(T), q.th, q.tw, BN), s,
                  static_cast<const T*>(p.x), static_cast<const T*>(p.y1),
                  static_cast<const T*>(p.y2), static_cast<const T*>(p.g),
                  static_cast<const float*>(p.dz1), static_cast<T*>(p.dw1),
                  static_cast<T*>(p.dw2), p.part, p.partb, q, tiles2,
                  pl.chunks2, pl.chunks1);
}

template <bool kContract, typename T>
cudaError_t run(const Bufs& p, const Geo& q, const Plan& pl, cudaStream_t s) {
  cudaError_t err;
  switch (pl.bn_dz1) {
    case 16: err = run_dz1<kContract, T, 16>(p, q, pl.ks, s); break;
    case 32: err = run_dz1<kContract, T, 32>(p, q, pl.ks, s); break;
    default: err = run_dz1<kContract, T, 64>(p, q, pl.ks, s); break;
  }
  if (err != cudaSuccess) return err;
  if (pl.ks > 1) {
    const long long po = (long long)q.n * q.hy * q.wy * q.o;
    stage_dz1_sum_kernel<T><<<blocks_for(po, 256), 256, 0, s>>>(
        p.dy1p, static_cast<const T*>(p.y1), p.dz1, po, pl.ks, q.slope);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  switch (pl.bn_dx) {
    case 16: err = run_dx<kContract, T, 16>(p, q, pl.ksx, s); break;
    case 32: err = run_dx<kContract, T, 32>(p, q, pl.ksx, s); break;
    default: err = run_dx<kContract, T, 64>(p, q, pl.ksx, s); break;
  }
  if (err != cudaSuccess) return err;
  if (pl.ksx > 1) {
    const long long xel = (long long)q.n * q.h * q.w * q.c;
    stage_dx_sum_kernel<T><<<blocks_for(xel, 256), 256, 0, s>>>(
        p.dxp, static_cast<T*>(p.dx), xel, pl.ksx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = pl.bn_w == 16 ? run_wgrad<kContract, T, 16>(p, q, pl, s)
                      : run_wgrad<kContract, T, 32>(p, q, pl, s);
  if (err != cudaSuccess) return err;
  const long long total = (pl.chunks2 > 1 ? 4LL * q.o * q.o : 0) +
                          (pl.chunks1 > 1 ? 4LL * q.c * q.o : 0) +
                          2LL * q.o;
  stage_wgrad_sum_kernel<T><<<blocks_for(total, 64), 256, 0, s>>>(
      p.part, p.partb, static_cast<T*>(p.dw2), static_cast<T*>(p.dw1),
      static_cast<T*>(p.db2), static_cast<T*>(p.db1), q.o, q.c, pl.chunks2,
      pl.chunks1);
  return cudaGetLastError();
}

bool pow2_in(int v, int lo, int hi) {
  return v >= lo && v <= hi && (v & (v - 1)) == 0;
}

}  // namespace

extern "C" {

// The backward of one fused stage (contract != 0: contract_stage, else
// expand_stage) from the forward's saved tensors x, w1, w2, y1, y2 and the
// gradient g of y2: contiguous NHWC / HWIO of one type (float32, or
// bfloat16 if is_bf16), but g, whose pixels may lie gs >= O elements apart
// (a channel slice of a wider tensor). Writes dx, dw1, db1, dw2, db2 in
// that type. Float32 scratch: dz1 (y1's shape); dy1p (ks of y1's shape;
// NULL if ks == 1); dxp (ksx of x's shape; NULL if ksx == 1); part
// (chunks2 * 4 O O + chunks1 * 4 C O; NULL if both are 1); partb (chunks2
// * O + chunks1 * O).
// The plan (ops/fused_stage.py::bwd_plan): th x tw and xth x xtw tiles of 64
// pixels, the channel slices of the three products, the K slices of the
// dz1 and dx products, the weight gradients' pixel chunks, and the elements
// per copy of C rows, O rows and dz1 rows. Returns the cudaError_t of the
// launches on `stream` (0 = launched).
int nlt_stage_bwd(int contract, const void* x, const void* w1, const void* w2,
                  const void* y1, const void* y2, const void* g, void* dx,
                  void* dw1, void* db1, void* dw2, void* db2, void* dz1,
                  void* dy1p, void* dxp, void* part, void* partb, int n, int h,
                  int w, int c, int o, int gs, int th, int tw, int xth,
                  int xtw, int bn_dz1, int bn_dx, int bn_w, int ks, int ksx,
                  int chunks2, int chunks1, int vc, int vo, int vf,
                  float slope, int is_bf16, void* stream) {
  const int maxv = is_bf16 ? 8 : 4;
  if (th * tw != kBM || !pow2_in(tw, 1, kBM) || xth * xtw != kBM ||
      !pow2_in(xtw, 1, kBM) || !pow2_in(bn_dz1, 16, 64) ||
      !pow2_in(bn_dx, 16, 64) || !pow2_in(bn_w, 16, 32) || ks < 1 ||
      ksx < 1 || chunks2 < 1 || chunks1 < 1 || !pow2_in(vc, 1, maxv) ||
      !pow2_in(vo, 1, maxv) || !pow2_in(vf, 1, 4) || c % vc || o % vo ||
      gs % vo || o % vf || gs < o || n < 1 || h < 1 || w < 1 || c < 1 ||
      o < 1 || (contract && (h % 2 || w % 2)) ||
      (ks > 1 && dy1p == nullptr) || (ksx > 1 && dxp == nullptr) ||
      ((chunks2 > 1 || chunks1 > 1) && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Geo q;
  q.n = n;
  q.h = h;
  q.w = w;
  q.c = c;
  q.o = o;
  q.hy = contract ? h / 2 : 2 * h;
  q.wy = contract ? w / 2 : 2 * w;
  q.th = th;
  q.tw = tw;
  q.xth = xth;
  q.xtw = xtw;
  q.vc = vc;
  q.vo = vo;
  q.vf = vf;
  q.gs = gs;
  q.slope = is_bf16 ? __bfloat162float(__float2bfloat16_rn(slope)) : slope;
  Bufs p{x,
         w1,
         w2,
         y1,
         y2,
         g,
         dx,
         dw1,
         db1,
         dw2,
         db2,
         static_cast<float*>(dz1),
         static_cast<float*>(dy1p),
         static_cast<float*>(dxp),
         static_cast<float*>(part),
         static_cast<float*>(partb)};
  const Plan pl{bn_dz1, bn_dx, bn_w, ks, ksx, chunks2, chunks1};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (contract)
    err = is_bf16 ? run<true, bf16>(p, q, pl, s)
                  : run<true, float>(p, q, pl, s);
  else
    err = is_bf16 ? run<false, bf16>(p, q, pl, s)
                  : run<false, float>(p, q, pl, s);
  return (int)err;
}

// Dynamic shared memory of kernel 0 (dz1), 1 (dx) or 2 (weight gradients)
// for a plan, as the launches compute it.
long long nlt_stage_bwd_smem_bytes(int kernel, int contract, int itemsize,
                                   int th, int tw, int bn) {
  return (long long)smem_bytes(kernel, contract != 0, itemsize, th, tw, bn);
}

const char* nlt_stage_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
