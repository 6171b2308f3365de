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
// Design: one thread per element, grid-stride, coalesced loads of the two
// hashes and one byte stored per element. A thread stops probing at its
// first miss, so on a sparse filter most elements cost one probe. The TPU
// kept the whole filter in VMEM and gathered words with a dynamic take; on
// Hopper a filter of up to 2^20 bits (128 KiB) is staged in shared memory
// once a block and probed there, and a larger one (2^22 bits = 512 KiB,
// the decontaminator's default) is probed through __ldg and stays resident
// in the 50 MB L2.
//
// What bounds it: 9 bytes an element (two 4-byte hashes in, one byte out)
// plus the filter read once, against per probe one multiply-add, a mask, a
// shift, a bit test and one load. With few probes an element it is bound
// by bytes; a dense filter (most probes hit) raises the load count toward
// k an element.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSharedLog2M = 20;          // 2^20 bits = 128 KiB

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
bloom_kernel(const uint32_t* __restrict__ ha, const uint32_t* __restrict__ hb,
             const uint32_t* __restrict__ bits, long long N, int k,
             uint32_t m_mask, int n_words, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t fs[];
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < n_words; i += kThreads) fs[i] = bits[i];
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < N; e += stride) {
    const uint32_t a = ha[e];
    const uint32_t s = hb[e] | 1u;           // odd stride
    bool hit = true;
    for (int i = 0; i < k; ++i) {
      const uint32_t p = (a + static_cast<uint32_t>(i) * s) & m_mask;
      uint32_t w;
      if constexpr (kShared)
        w = fs[p >> 5];
      else
        w = __ldg(bits + (p >> 5));
      if (!((w >> (p & 31u)) & 1u)) {
        hit = false;
        break;
      }
    }
    out[e] = hit;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint32_t*>(h_a);
  const auto* b = static_cast<const uint32_t*>(h_b);
  const auto* w = static_cast<const uint32_t*>(bits);
  auto* o = static_cast<uint8_t*>(out);
  const long long need = (N + kThreads - 1) / kThreads;
  if (log2_m <= kMaxSharedLog2M) {
    const size_t smem = static_cast<size_t>(n_words) * sizeof(uint32_t);
    cudaFuncSetAttribute(bloom_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bloom_kernel<true>,
                                                  kThreads, smem);
    const long long grid =
        need < 1LL * per_sm * sm_count() ? need : 1LL * per_sm * sm_count();
    bloom_kernel<true><<<static_cast<unsigned int>(grid > 0 ? grid : 1),
                         kThreads, smem, st>>>(a, b, w, N, k, m_mask, n_words,
                                               o);
  } else {
    const long long cap = 4LL * sm_count();  // 2048 threads an SM
    const long long grid = need < cap ? need : cap;
    bloom_kernel<false><<<static_cast<unsigned int>(grid), kThreads, 0, st>>>(
        a, b, w, N, k, m_mask, n_words, o);
  }
  return static_cast<int>(cudaGetLastError());
}
