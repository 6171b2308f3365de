// HyperLogLog register update from a hash stream, hand-written for Hopper
// (sm_90a): the distinct-n-gram count of the paper's §2.
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/hll.py::hll_update (_hll_kernel). It maps N uint32 hashes
// to 2^b int32 registers, b in [1, 31]:
//
//   index = h & (2^b - 1),  rank = min(ctz(h >> b), rank_bits) + 1,
//   ctz(0) = 32,            register = max over its hashes' ranks (from 0).
//
// The TPU reduced each tile with a one-hot max on its matrix unit and
// padded the stream with 0xFFFFFFFF, repairing register 2^b - 1 afterwards;
// here the grid-stride loop simply stops at N, so no repair is needed.
//
// Design: registers only rise, so every update is "raise if larger": read
// the register, and issue an atomicMax only when the rank is larger. For
// b <= 14 (64 KiB of int32 registers) each block keeps its own register
// file in shared memory and raises it there; at the end the block raises
// each global register it touched, at most one global atomicMax each. From
// b = 15 (128 KiB) a block's file would leave at most one block an SM, or
// not fit in the 227 KB a block may use at all, so those raise the global
// registers directly (up to b = 23 they stay in L2). Each thread keeps
// four loads in flight (a grid-stride loop unrolled by four), so two
// blocks an SM still read at the memory's rate.
//
// What bounds it: 4 bytes read a hash and the registers written once,
// against some six integer instructions and one register read a hash, and
// the atomics, which the data decides (many while the registers are low,
// few once they are high).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kMaxSharedB = 14;

__device__ __forceinline__ int rank_of(uint32_t h, int b, int rank_bits) {
  const uint32_t rest = h >> b;
  const int tz = rest ? __ffs(static_cast<int>(rest)) - 1 : 32;
  return min(tz, rank_bits) + 1;
}

// Raise a register to r. A stale read can only be lower than the register
// (registers never fall), so skipping when r is not larger is exact.
__device__ __forceinline__ void raise_to(int* reg, int r) {
  if (r > *reg) atomicMax(reg, r);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
hll_kernel(const uint32_t* __restrict__ h, long long N, int b, int rank_bits,
           int* regs) {
  extern __shared__ int sregs[];
  // b <= 31: the mask is formed in 32 unsigned bits (1 << 31 overflows int)
  const uint32_t idx_mask = (1u << b) - 1u;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i <= static_cast<int>(idx_mask); i += kThreads)
      sregs[i] = 0;
    __syncthreads();
  }
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
        if constexpr (kShared)
          raise_to(sregs + (v[u] & idx_mask), r);
        else
          raise_to(regs + (v[u] & idx_mask), r);
      }
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i <= static_cast<int>(idx_mask); i += kThreads)
      if (sregs[i] > 0) raise_to(regs + i, sregs[i]);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace

// Plain C interface, bound with ctypes. Device pointers: hashes (N,)
// uint32; regs (2^b,) int32, zeroed by the caller and raised in place.
// Runs on `stream` and does not synchronise. Returns cudaGetLastError()
// after the launch (0 = success), or cudaErrorInvalidValue for arguments
// out of range.
extern "C" int hll_update(const void* hashes, long long N, int b,
                          int rank_bits, void* regs, void* stream) {
  if (N < 0 || b < 1 || b > 31 || rank_bits < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  rank_bits = rank_bits < 32 ? rank_bits : 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const uint32_t*>(hashes);
  auto* r = static_cast<int*>(regs);
  const long long need =
      (N + 1LL * kThreads * kUnroll - 1) / (1LL * kThreads * kUnroll);
  // two blocks an SM: each block's register file is flushed once, so
  // fewer, longer-lived blocks flush fewer atomics
  const long long cap = 2LL * sm_count();
  const unsigned int grid =
      static_cast<unsigned int>(need < cap ? need : cap);
  if (b <= kMaxSharedB) {
    const size_t smem = sizeof(int) << b;
    cudaFuncSetAttribute(hll_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    hll_kernel<true><<<grid, kThreads, smem, st>>>(h, N, b, rank_bits, r);
  } else {
    hll_kernel<false><<<grid, kThreads, 0, st>>>(h, N, b, rank_bits, r);
  }
  return static_cast<int>(cudaGetLastError());
}
