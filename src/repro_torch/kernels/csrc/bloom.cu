// Bloom-filter membership of hash pairs, hand-written for Hopper (sm_90a):
// the decontamination scan's probe.
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/bloom.py::bloom_probe (_bloom_kernel). It maps two (B, S)
// uint32 hash streams and a packed filter of 2^log2_m bits (2^log2_m / 32
// uint32 words, bit p at word p >> 5, bit p & 31) to a (B, S) bool: true
// iff all k double-hashed probes
//
//   p_i = (h_a + i * (h_b | 1)) mod 2^32 & (2^log2_m - 1),  i < k
//
// are set.
//
// What bounds it: 9 bytes an element (two 4-byte hashes in, one byte out)
// plus the filter read once, against per probe one multiply-add, a mask, a
// shift, a bit test and one load. At the bytes path's shape (4.3 M
// elements, 2^22 bits, k = 4, fill 0.38: 1.86 probes an element) that is
// 39 MB, 0.0117 ms at 3.35 TB/s. What held the first version back was the
// probes, not the bytes: the TPU kept the filter in VMEM, and a 512 KiB
// filter, above what one block's shared memory holds, was probed through
// __ldg, each probe a random 32-byte L2 sector (8 M of them, about 256 MB
// of L2 traffic for 4 bytes each; 0.058 ms).
//
// Design: the filter's words are read from shared memory wherever the card
// can hold them, and what is left is read through __ldg:
//   - up to 2^20 bits (128 KiB): each block stages the whole filter;
//   - up to 2^23 bits (1 MiB): each block stages the filter's first 224
//     KiB (kPrefixWords, as much as one block may take), so a probe that
//     falls there (44 % of them at the decontaminator's 2^22 bits, 22 % at
//     2^23) costs no L2 request, and the rest go through __ldg;
//   - larger filters (to 2^32 bits) are probed through __ldg and L2.
// The grid is resident (as many 1,024-thread blocks as fit on the card at
// once; the staging is paid once a block, with every load of a thread's
// share issued before its stores) and loops over the elements. A thread
// takes kUnroll elements a pass, kThreads apart so that loads and stores
// coalesce, loads all their hashes before the first probe, and issues
// probe i of every element still alive together, so the random probes of
// one thread overlap; an element stops at its first unset bit, as in the
// plain version.
//
// What the measurements said (H100 80GB HBM3, 700 W, chip_smoke.py and
// tools/kernel_ab.py at the bytes path's shape; PERF.md section 6): the
// first version's 8.0 M random probes through L2 took most of its 0.058
// ms. Splitting the 2^22-bit filter over a 4-block cluster's distributed
// shared memory (map_shared_rank) was slower still, 0.081–0.098 ms: a
// remote 4-byte read cost more than an L2 sector. Four elements a thread
// with the probes issued together, all through __ldg, measured the same
// as the first version (0.0509 against 0.0510 ms): the probes are bound by
// L2's request rate, not by latency. The staged prefix, which takes 44 % of
// the requests off L2, is what moved it: 0.0455 ms, and 0.0504 against
// 0.0586 on the path's own filter.

#include <cstdint>
#include <mutex>
#include <utility>
#include <vector>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;                   // elements a thread a pass
constexpr int kMaxSharedLog2M = 20;          // 2^20 bits = 128 KiB, whole
constexpr int kPrefixWords = 57344;          // 224 KiB: a block's most
constexpr int kMaxPrefixLog2M = 23;          // the prefix holds >= 22 %
constexpr int kStageUnroll = 7;              // 16-byte loads in flight

enum Route { kLdg = 0, kLocal = 1, kPrefix = 2 };

// Copy `words` words (a multiple of 4, 16-byte aligned) from global to
// shared memory, every thread's loads of a round issued before its stores.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src,
                                      int words) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  const int n4 = words / 4;
  for (int base = 0; base < n4; base += kThreads * kStageUnroll) {
    uint4 r[kStageUnroll];
#pragma unroll
    for (int j = 0; j < kStageUnroll; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      if (i < n4) r[j] = s4[i];
    }
#pragma unroll
    for (int j = 0; j < kStageUnroll; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      if (i < n4) d4[i] = r[j];
    }
  }
}

// kRoute: where the filter's words are read (kPrefix: words below
// kPrefixWords from shared memory, the rest through __ldg).
template <int kRoute>
__global__ void __launch_bounds__(kThreads, 1)
bloom_kernel(const uint32_t* __restrict__ ha, const uint32_t* __restrict__ hb,
             const uint32_t* __restrict__ bits, long long N, int k,
             uint32_t m_mask, int n_words, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t fs[];
  if constexpr (kRoute != kLdg) {
    const int words = kRoute == kLocal ? n_words : kPrefixWords;
    // 16-byte copies where the words allow (a filter of 2^5 or 2^6 bits is
    // one or two words; a caller's tensor may start off 16 bytes)
    if (words % 4 == 0 && (reinterpret_cast<uintptr_t>(bits) & 15u) == 0)
      stage(fs, bits, words);
    else
      for (int i = threadIdx.x; i < words; i += kThreads) fs[i] = bits[i];
    __syncthreads();
  }
  const long long pass = static_cast<long long>(gridDim.x) * kThreads *
                         kUnroll;
  for (long long e0 = static_cast<long long>(blockIdx.x) * kThreads *
                          kUnroll + threadIdx.x;
       e0 < N; e0 += pass) {
    uint32_t a[kUnroll], s[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = e0 + static_cast<long long>(u) * kThreads;
      live[u] = e < N;
      a[u] = live[u] ? ha[e] : 0u;
      s[u] = live[u] ? (hb[e] | 1u) : 1u;    // odd stride
    }
    for (int i = 0; i < k; ++i) {
      uint32_t w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {    // every load before any test
        const uint32_t p = (a[u] + static_cast<uint32_t>(i) * s[u]) & m_mask;
        const uint32_t wi = p >> 5;
        w[u] = 0u;
        if (live[u]) {
          if constexpr (kRoute == kLocal)
            w[u] = fs[wi];
          else if constexpr (kRoute == kPrefix)
            w[u] = wi < kPrefixWords ? fs[wi] : __ldg(bits + wi);
          else
            w[u] = __ldg(bits + wi);
        }
      }
      bool any = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t p = (a[u] + static_cast<uint32_t>(i) * s[u]) & m_mask;
        live[u] = live[u] && ((w[u] >> (p & 31u)) & 1u);
        any |= live[u];
      }
      if (!any) break;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = e0 + static_cast<long long>(u) * kThreads;
      if (e < N) out[e] = live[u];
    }
  }
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

// Which route a filter of 2^log2_m bits takes: 1 = staged whole in each
// block's shared memory, 2 = its first kPrefixWords words staged there and
// the rest read through __ldg, 0 = every word read through __ldg.
extern "C" int bloom_probe_route(int log2_m) {
  return log2_m <= kMaxSharedLog2M   ? kLocal
         : log2_m <= kMaxPrefixLog2M ? kPrefix
                                     : kLdg;
}

// Plain C interface, bound with ctypes. Device pointers: h_a, h_b (N,)
// uint32, bits (2^log2_m / 32,) uint32, out (N,) bytes of 0 or 1 (a
// torch.bool tensor). Runs on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int bloom_probe(const void* h_a, const void* h_b, const void* bits,
                           long long N, int k, int log2_m, void* out,
                           void* stream) {
  if (N < 0 || k < 0 || log2_m < 5 || log2_m > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const uint32_t m_mask =
      log2_m == 32 ? 0xFFFFFFFFu : ((1u << log2_m) - 1u);
  const int n_words = static_cast<int>((1ull << log2_m) >> 5);
  const int route = bloom_probe_route(log2_m);
  const size_t smem =
      sizeof(uint32_t) * (route == kLocal    ? n_words
                          : route == kPrefix ? kPrefixWords
                                             : 0);
  auto kernel = route == kLocal    ? bloom_kernel<kLocal>
                : route == kPrefix ? bloom_kernel<kPrefix>
                                   : bloom_kernel<kLdg>;
  // the resident grid: as many blocks as fit on the card at once
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (N + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long cap = 1LL * per_sm * sm_count();
  const long long grid = need < cap ? need : cap;
  kernel<<<static_cast<unsigned int>(grid > 0 ? grid : 1), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(h_a), static_cast<const uint32_t*>(h_b),
      static_cast<const uint32_t*>(bits), N, k, m_mask, n_words,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
