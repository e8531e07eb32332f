// Row scatter-add for the resampler's backward on Hopper (sm_90a), bound
// through a plain C interface (ctypes; nlt_tpu_torch/ops/scatter.py).
//
// It replaces the Pallas kernel of nlt_tpu/ops/scatter_pallas.py (_kernel,
// launched by _scatter_planned_local):
//   out = zeros((n_rows, W), float32); out[idx[r]] += upd[r] for every r
//   with 0 <= idx[r] < n_rows (make_plan marks dead updates with -1).
// The sum over duplicate rows is taken in no fixed order, as nlt_tpu's
// contract allows ("up to accumulation order"); rows hit once are exact.
//
// Bound on the card: bytes. Each update's index is read once, each live
// update's values once, each table element written once; at the flagship
// training shape (1,048,576 updates of 12 floats into as many rows, half
// of them dead) that is ~80 MB, 23.8 us at 3.35 TB/s. There is no
// arithmetic to speak of.
//
// Design. The Pallas kernel keeps a piece of the table in VMEM and walks
// the updates in order on the scalar core, with the routing (pieces,
// chunks, dump rows, scan bounds) precomputed to fit VMEM and SMEM. None
// of that carries over: here the table is zeroed in device memory
// (cudaMemsetAsync) and one thread per update row (a grid-stride loop)
// loads the row's index once; a dead row costs that one 4-byte load. A
// live row's values are loaded as float4s and added with Hopper's vector
// atomic, atomicAdd(float4*, float4) (RED.ADD.F32x4, resolved in L2):
// W/4 atomics per row instead of W. The float4 count per row, W/4, is a
// template parameter, W/4 in 1..4 (nlt_tpu's W is 12), so the loop has no
// division and all loads issue before the atomics. A row whose W is no
// multiple of 4 or above 16, or whose table or updates are off a 16-byte
// boundary, takes the kernel's scalar path: one float atomic per element,
// the index still loaded once per row.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // SMs x resident blocks

// WV: float4s per row (the float4 path, w = 4 WV); 0: the scalar path,
// one float atomic per element.
template <int WV>
__global__ void __launch_bounds__(kThreads)
    scatter_add_rows_kernel(const int* __restrict__ idx,
                            const float* __restrict__ upd,
                            float* __restrict__ out, long long r, int w,
                            int n_rows) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < r; i += stride) {
    const int row = __ldg(idx + i);
    if (static_cast<unsigned>(row) >= static_cast<unsigned>(n_rows)) continue;
    const float* src = upd + i * w;
    float* dst = out + static_cast<long long>(row) * w;
    if constexpr (WV > 0) {
      float4 v[WV];
#pragma unroll
      for (int q = 0; q < WV; ++q)
        v[q] = __ldg(reinterpret_cast<const float4*>(src) + q);
#pragma unroll
      for (int q = 0; q < WV; ++q)
        atomicAdd(reinterpret_cast<float4*>(dst) + q, v[q]);
    } else {
      for (int j = 0; j < w; ++j) atomicAdd(dst + j, __ldg(src + j));
    }
  }
}

constexpr int kMaxWV = 4;  // the widest row of the float4 path, in float4s

struct Plan {
  int wv;      // float4s per row (0: the scalar path)
  int blocks;  // grid
};

Plan make_plan(long long r, int w, uintptr_t upd, uintptr_t out) {
  Plan p;
  const bool vec =
      w % 4 == 0 && w / 4 <= kMaxWV && upd % 16 == 0 && out % 16 == 0;
  p.wv = vec ? w / 4 : 0;
  const long long blocks = (r + kThreads - 1) / kThreads;
  p.blocks = static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  return p;
}

template <int WV>
void launch_t(const Plan& p, const int* idx, const float* upd, float* out,
              long long r, int w, int n_rows, cudaStream_t s) {
  scatter_add_rows_kernel<WV><<<p.blocks, kThreads, 0, s>>>(
      idx, upd, out, r, w, n_rows);
}

}  // namespace

extern "C" {

// idx: (r,) int32; upd: (r, w) float32; out: (n_rows, w) float32, all
// contiguous on the device, upd and out at least 4-byte aligned. parts:
// 1 zeroes out, 2 launches the kernel, 3 both (the op); all on `stream`.
// Returns the cudaError_t of the two (0 = launched).
int nlt_scatter_add_rows_parts(const void* idx, const void* upd, void* out,
                               long long r, int w, int n_rows, int parts,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts & 1) {
    const long long table = static_cast<long long>(n_rows) * w;
    cudaError_t err = cudaMemsetAsync(out, 0, table * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!(parts & 2) || r == 0 || w == 0) return 0;
  const Plan p = make_plan(r, w, reinterpret_cast<uintptr_t>(upd),
                           reinterpret_cast<uintptr_t>(out));
  const int* ip = static_cast<const int*>(idx);
  const float* up = static_cast<const float*>(upd);
  float* op = static_cast<float*>(out);
  switch (p.wv) {
    case 1: launch_t<1>(p, ip, up, op, r, w, n_rows, s); break;
    case 2: launch_t<2>(p, ip, up, op, r, w, n_rows, s); break;
    case 3: launch_t<3>(p, ip, up, op, r, w, n_rows, s); break;
    case 4: launch_t<4>(p, ip, up, op, r, w, n_rows, s); break;
    default: launch_t<0>(p, ip, up, op, r, w, n_rows, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Zeroes out, then launches the kernel: the op.
int nlt_scatter_add_rows(const void* idx, const void* upd, void* out,
                         long long r, int w, int n_rows, void* stream) {
  return nlt_scatter_add_rows_parts(idx, upd, out, r, w, n_rows, 3, stream);
}

// The launch plan for r rows of w floats at the two addresses, as 2
// ints: float4s per row (0: the scalar path), blocks.
void nlt_scatter_plan(long long r, int w, unsigned long long upd,
                      unsigned long long out, int* res) {
  const Plan p = make_plan(r, w, static_cast<uintptr_t>(upd),
                           static_cast<uintptr_t>(out));
  res[0] = p.wv;
  res[1] = p.blocks;
}

const char* nlt_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
