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
// Design. The Pallas kernel keeps a piece of the table in VMEM and walks
// the updates in order on the scalar core, with the routing (pieces,
// chunks, dump rows, scan bounds) precomputed to fit VMEM and SMEM. None
// of that carries over: here the table is zeroed in device memory and one
// thread per update element (a grid-stride loop over R * W) adds its value
// with a float atomicAdd, which compiles to RED.ADD.F32 and resolves in
// L2. Consecutive threads read consecutive update elements and write
// consecutive columns of a row, so the loads are coalesced.
//
// Bound on the card: bytes. Each update is read once (4 B + its row
// index), each table element is zeroed and written once; at the flagship
// training shape (1,048,576 rows of 12 floats) that is ~150 MB, ~46 us at
// 3.35 TB/s. There is no arithmetic to speak of. Duplicate rows contend
// on their L2 lines; dead updates cost one index load and no atomic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // SMs x resident blocks

// I: 32-bit offsets when R * W and n_rows * W fit, else 64-bit.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    scatter_add_rows_kernel(const int* __restrict__ idx,
                            const float* __restrict__ upd,
                            float* __restrict__ out, I total, int w,
                            int n_rows) {
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  for (I e = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += stride) {
    const I r = e / w;
    const int row = __ldg(idx + r);
    if (static_cast<unsigned>(row) >= static_cast<unsigned>(n_rows)) continue;
    const int j = static_cast<int>(e - r * w);
    atomicAdd(out + static_cast<I>(row) * w + j, __ldg(upd + e));
  }
}

}  // namespace

extern "C" {

// idx: (r,) int32; upd: (r, w) float32; out: (n_rows, w) float32, all
// contiguous on the device. Zeroes out, then launches the kernel on
// `stream`; returns the cudaError_t of the two (0 = launched).
int nlt_scatter_add_rows(const void* idx, const void* upd, void* out,
                         long long r, int w, int n_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long table = static_cast<long long>(n_rows) * w;
  cudaError_t err = cudaMemsetAsync(out, 0, table * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = r * w;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int* ip = static_cast<const int*>(idx);
  const float* up = static_cast<const float*>(upd);
  float* op = static_cast<float*>(out);
  if (total < (1LL << 31) && table < (1LL << 31)) {
    scatter_add_rows_kernel<int><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        ip, up, op, static_cast<int>(total), w, n_rows);
  } else {
    scatter_add_rows_kernel<long long>
        <<<static_cast<int>(blocks), kThreads, 0, s>>>(ip, up, op, total, w,
                                                       n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* nlt_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
