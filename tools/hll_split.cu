// The HLL update's time split, built for Hopper (sm_90a). Measurement only:
// chip_smoke.py builds it beside the port's kernels and times it against
// csrc/hll.cu on the same hashes, so that the kernel's time splits into
// the stream, the register raises and the flush.
//
// Two variants, each on csrc/hll.cu's grid (one 1,024-thread block an SM,
// each thread four loads in flight), for b <= 14:
//
//   mode 0  the stream floor: every hash loaded and ranked, no register
//           touched;
//   mode 1  one register file a block in shared memory, raised as the
//           kernel raises it, and no flush (the kernel with its
//           end-of-launch flush cut out).
//
// What each computes is kept live by a store that no rank can reach (a
// rank is at most 33); the registers are left as they were.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kNever = 64;        // above any rank

__device__ __forceinline__ int rank_of(uint32_t h, int b, int rank_bits) {
  const uint32_t rest = h >> b;
  const int tz = rest ? __ffs(static_cast<int>(rest)) - 1 : 32;
  return min(tz, rank_bits) + 1;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
split_kernel(const uint32_t* __restrict__ h, long long N, int b,
             int rank_bits, int* regs) {
  extern __shared__ int sregs[];
  const uint32_t idx_mask = (1u << b) - 1u;
  if constexpr (kMode == 1) {
    for (int i = threadIdx.x; i <= static_cast<int>(idx_mask); i += kThreads)
      sregs[i] = 0;
    __syncthreads();
  }
  int live = 0;
  uint32_t where = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < N; e += kUnroll * stride) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = e + u * stride < N ? h[e + u * stride] : 0u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (e + u * stride < N) {
        const int r = rank_of(v[u], b, rank_bits);
        if constexpr (kMode == 0) {
          live = max(live, r);
          where ^= v[u] & idx_mask;
        } else {
          int* reg = sregs + (v[u] & idx_mask);
          if (r > *reg) atomicMax(reg, r);
        }
      }
    }
  }
  if constexpr (kMode == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i <= static_cast<int>(idx_mask); i += kThreads)
      if (sregs[i] > kNever) regs[i] = sregs[i];
  } else if (live > kNever) {
    regs[where] = live;
  }
}

}  // namespace

// hashes (N,) uint32 and regs (2^b,) int32, device pointers; b in [1, 14];
// mode 0 or 1 as above. Runs on `stream`; returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments out of range.
extern "C" int hll_split(const void* hashes, long long N, int b,
                         int rank_bits, void* regs, int mode, void* stream) {
  if (N < 1 || b < 1 || b > 14 || rank_bits < 0 || mode < 0 || mode > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  rank_bits = rank_bits < 32 ? rank_bits : 32;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need =
      (N + 1LL * kThreads * kUnroll - 1) / (1LL * kThreads * kUnroll);
  const unsigned int grid =
      static_cast<unsigned int>(need < sms ? need : sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const uint32_t*>(hashes);
  auto* r = static_cast<int*>(regs);
  if (mode == 0) {
    split_kernel<0><<<grid, kThreads, 0, st>>>(h, N, b, rank_bits, r);
  } else {
    const size_t smem = sizeof(int) << b;
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    split_kernel<1><<<grid, kThreads, smem, st>>>(h, N, b, rank_bits, r);
  }
  return static_cast<int>(cudaGetLastError());
}
