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
// file in shared memory and raises it there, then flushes it: one global
// atomicMax for each register the block raised, skipped when an L2 read
// (__ldcg) shows the register high enough already. One 1,024-thread block
// runs on each SM, so 132 files are flushed; each block starts its flush at
// another line of the registers, so that blocks do not queue on the same
// L2 lines; and a thread issues the reads of all its registers (four at
// b = 12) before any of its atomics, so the flush waits on one L2 round
// trip, not on one a register. (Merging 8 blocks' files through a
// cluster's distributed shared memory before one flush a cluster was
// slower: PERF.md.)
//
// From b = 15 (128 KiB; from b = 16 a file does not fit in the 227 KB a
// block may use) the kernel raises the global registers directly (up to
// b = 23 they stay in L2). Each thread keeps four loads in flight (a
// grid-stride loop unrolled by four), so one 1,024-thread block an SM
// still reads at the memory's rate.
//
// What bounds it: 4 bytes read a hash and the registers written once,
// against some six integer instructions and one register read a hash, and
// the atomics, which the data decides (many while the registers are low,
// few once they are high).

#include <cstdint>
#include <mutex>
#include <utility>
#include <vector>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kMaxSharedB = 14;
constexpr int kBatch = 4;          // registers a thread reads before raising
constexpr int kLine = 32;          // int32 registers an L2 line

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

// Raise the registers at `file` (shared or global) by this block's share
// of the hashes.
__device__ __forceinline__ void raise_all(const uint32_t* __restrict__ h,
                                          long long N, int b, int rank_bits,
                                          int* file) {
  const uint32_t idx_mask = (1u << b) - 1u;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < N; e += kUnroll * stride) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = e + u * stride < N ? h[e + u * stride] : 0u;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (e + u * stride < N)
        raise_to(file + (v[u] & idx_mask), rank_of(v[u], b, rank_bits));
  }
}

// b <= 14: a register file a block in shared memory, flushed once
__global__ void __launch_bounds__(kThreads)
hll_shared_kernel(const uint32_t* __restrict__ h, long long N, int b,
                  int rank_bits, int* regs) {
  extern __shared__ int sregs[];
  const int R = 1 << b;
  for (int i = threadIdx.x; i < R; i += kThreads) sregs[i] = 0;
  __syncthreads();
  raise_all(h, N, b, rank_bits, sregs);
  __syncthreads();
  // this block's first line of the flush; R is a power of two
  const int off = static_cast<int>(blockIdx.x) * kLine & (R - 1);
  for (int i0 = threadIdx.x; i0 < R; i0 += kBatch * kThreads) {
    int idx[kBatch], mine[kBatch], now[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      idx[u] = (i + off) & (R - 1);
      mine[u] = i < R ? sregs[idx[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      now[u] = mine[u] > 0 ? __ldcg(regs + idx[u]) : 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (mine[u] > now[u]) atomicMax(regs + idx[u], mine[u]);
  }
}

// b >= 15: the global registers raised directly
__global__ void __launch_bounds__(kThreads)
hll_global_kernel(const uint32_t* __restrict__ h, long long N, int b,
                  int rank_bits, int* regs) {
  raise_all(h, N, b, rank_bits, regs);
}

// The current device's SM count, cached per device: launches of one
// process may go to several cards (a data mesh's shards).
int sm_count() {
  static std::mutex mu;
  static std::vector<std::pair<int, int>> seen;   // (device, SMs)
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& s : seen)
    if (s.first == dev) return s.second;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess &&
      sms > 0)
    seen.emplace_back(dev, sms);
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
  // one block an SM at most (each flushes its file once: fewer,
  // longer-lived blocks flush fewer atomics), as many as N needs
  const long long need =
      (N + 1LL * kThreads * kUnroll - 1) / (1LL * kThreads * kUnroll);
  const unsigned int grid =
      static_cast<unsigned int>(need < sm_count() ? need : sm_count());
  if (b <= kMaxSharedB) {
    const size_t smem = sizeof(int) << b;
    const cudaError_t err = cudaFuncSetAttribute(
        hll_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    hll_shared_kernel<<<grid, kThreads, smem, st>>>(h, N, b, rank_bits, r);
  } else {
    hll_global_kernel<<<grid, kThreads, 0, st>>>(h, N, b, rank_bits, r);
  }
  return static_cast<int>(cudaGetLastError());
}
