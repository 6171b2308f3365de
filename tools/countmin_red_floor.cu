// The floor of any CountMin design that keeps one global atomic per
// increment: the increments of a CountMin epilogue with nothing else, built
// for Hopper (sm_90a). Measurement only: chip_smoke.py builds it beside the
// port's kernels and times it against the plan kernel's CountMin epilogue
// (src/repro_torch/kernels/csrc/sketch_plan.cu) on the same columns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// cols is (depth, n) uint32, the precomputed columns of n windows in the
// table's depth-major layout; one thread a window, one atomicAdd a row.
__global__ void __launch_bounds__(kThreads)
countmin_red_floor_kernel(const uint32_t* __restrict__ cols, long long n,
                          int depth, int lw, int* table) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (j >= n) return;
  for (int d = 0; d < depth; ++d)
    atomicAdd(table + (static_cast<size_t>(d) << lw) + cols[d * n + j], 1);
}

}  // namespace

// Plain C interface, bound with ctypes. Device pointers: cols (depth, n)
// uint32 column indices below 2^lw, table (depth, 2^lw) int32; adds one at
// every (d, cols[d, j]). Runs on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int countmin_red_floor(const void* cols, long long n, int depth,
                                  int lw, void* table, void* stream) {
  if (n < 0 || depth < 1 || lw < 1 || lw > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int grid =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  countmin_red_floor_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cols), n, depth, lw,
      static_cast<int*>(table));
  return static_cast<int>(cudaGetLastError());
}
