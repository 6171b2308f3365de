// The plan kernel, hand-written for Hopper (sm_90a): one rolling-hash pass
// feeding every sketch epilogue of a plan (MinHash, HyperLogLog, CountMin,
// Bloom) in ONE launch.
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/sketch_fused.py::sketch_plan_fused (kernel body _plan_kernel
// with its epilogues _minhash_tile, _hll_tile, _cms_tile, _bloom_tile, and
// the CountMin scatter epilogue for wide tables). Only the bits are the
// contract. Window j of row r is valid iff w_start[r] <= j < n_windows[r];
// its hash h_j is the window's CYCLIC (XOR of rotations) or GENERAL (XOR of
// carry-less products with x^(n-1-t) mod p) hash masked by hash_mask (the
// Theorem-1 discard). Over the valid windows:
//
//   MinHash  out[r, i] = min(init[r, i], min_j (a[i] * h_j + b[i]) mod 2^32)
//   HLL      reg[h_j & (2^b-1)] = max(init, min(ctz(h_j >> b), rank_bits)+1)
//            with ctz(0) = 32
//   CountMin table[d, (a[d] * h_j + b[d]) >> (32 - w)] += 1, on init
//   Bloom    out[r] = init[r] + #{j : all k probes (h_j + i * (hb_j | 1))
//            mod 2^32 & (2^log2_m - 1) are set in the filter}, where hb_j
//            is the window hash of the second stream
//
// Design (simple first):
//   * grid = rows x window segments; 256 threads a block. A segment holds
//     up to kSeg windows; the launcher halves it (down to kMinSeg) while
//     the grid would hold fewer than kBlocksPerSm blocks per SM.
//   * The valid windows of a row form one contiguous range, so a block
//     clips its segment to that range and returns early when it is empty.
//   * Hash once: the block stages its symbols plus the n-1 halo in shared
//     memory (both streams for a Bloom plan) and hashes each valid window
//     once into shared memory. Every epilogue then reads the hashes there.
//     The kernel has two instances, with and without the second stream, so
//     a plan without Bloom keeps the smaller shared footprint; the
//     epilogues' descriptors are read at a dynamic index from the
//     kernel's constant bank, so their code appears once.
//   * The launcher pre-fills each output from its init carry, or with the
//     sketch's identity (0xFFFFFFFF for MinHash, 0 for the others), on the
//     launch's stream. All merges are order-free (min, max, +), so the
//     result is bit-identical whatever the block schedule.
//   * MinHash: thread t owns signature lane t % k over the window group
//     t / k; the groups fold in shared memory and each lane does one
//     atomicMin.
//   * HLL: a global atomicMax per window, skipped when an L2 read of the
//     register already shows the rank (registers only rise, so a stale read
//     costs an atomic, never a lost update). A per-block shared histogram
//     was rejected: at b = 12 it is 16 KiB and flushing its 4096 registers
//     costs more atomics than the block's 1024 windows.
//   * CountMin: depth global atomicAdds per window, for every width. At the
//     stats default (depth 4, w = 16) the table is 1 MiB, too large for
//     shared memory; the atomics land in the 50 MB L2.
//   * Bloom: the filter (512 KiB at log2_m = 22) does not fit in shared
//     memory; probes read it through the read-only path (__ldg) and L2
//     holds it. Hits reduce per warp, then per block, and each block does
//     one atomicAdd per row and segment.
//
// What bounds it: per window it reads 4 bytes of input (8 for Bloom) and
// issues integer work and memory operations: k multiply-adds and mins for
// MinHash, depth atomics for CountMin, up to k filter loads for Bloom, at
// most one atomic for HLL. So it is bound by instruction issue and by the
// atomics' and loads' rate, not by bytes. This design does nothing yet
// about that bound (direct hash of every window, no specialisation on n,
// the family or the plan); making it fast is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 1024;   // most windows per block
constexpr int kMinSeg = 64;  // fewest windows per block
constexpr int kBlocksPerSm = 4;
constexpr int kMaxN = 32;    // n <= L <= 32
constexpr int kMaxSketches = 8;

enum Kind { kMinHash = 0, kHll = 1, kCountMin = 2, kBloom = 3 };

struct HashParams {
  int family;            // 0 = CYCLIC, 1 = GENERAL
  int n;
  int L;
  uint32_t lmask;        // the L low bits
  uint32_t hash_mask;    // discard mask applied to every window hash
  uint32_t p_low;        // GENERAL: modulus without its top bit
  uint32_t xpow[kMaxN];  // GENERAL: xpow[t] = x^(n-1-t) mod p
};

}  // namespace

// One sketch of the plan; mirrored field for field by
// repro_torch/kernels/sketch_fused.py::_Epilogue.
struct Epilogue {
  int kind;          // Kind
  int p0;            // MinHash k; HLL b; CountMin depth; Bloom k
  int p1;            // HLL rank_bits; CountMin log2 width; Bloom log2_m
  int unused;
  const void* a;     // MinHash / CountMin a (uint32); Bloom filter words
  const void* b;     // MinHash / CountMin b (uint32)
  const void* init;  // carry in (the output's shape and type), or null
  void* out;         // MinHash (B, k) u32; HLL (2^b,) i32;
                     // CountMin (depth, 2^w) i32; Bloom (B,) i32
};

struct PlanDesc {    // mirrored by sketch_fused.py::_PlanDesc
  int n_sketches;
  int unused;
  Epilogue sk[kMaxSketches];
};

namespace {

__device__ __forceinline__ uint32_t rotl_l(uint32_t v, int r, int L,
                                           uint32_t m) {
  v &= m;
  if (r == 0) return v;  // a shift by L would be undefined
  return ((v << r) | (v >> (L - r))) & m;
}

__device__ __forceinline__ uint32_t mul_const(uint32_t v, uint32_t c, int L,
                                              uint32_t m, uint32_t p_low) {
  v &= m;
  uint32_t acc = 0;
  while (c) {
    if (c & 1u) acc ^= v;
    c >>= 1;
    if (c) {
      const uint32_t msb = (v >> (L - 1)) & 1u;
      v = ((v << 1) & m) ^ (msb * p_low);
    }
  }
  return acc;
}

__device__ __forceinline__ uint32_t window_hash(const uint32_t* xs,
                                                const HashParams& hp) {
  uint32_t acc = 0;
  if (hp.family == 0) {
    // n <= L, so the rotation n-1-t needs no reduction mod L
    for (int t = 0; t < hp.n; ++t)
      acc ^= rotl_l(xs[t], hp.n - 1 - t, hp.L, hp.lmask);
  } else {
    for (int t = 0; t < hp.n; ++t)
      acc ^= mul_const(xs[t], hp.xpow[t], hp.L, hp.lmask, hp.p_low);
  }
  return acc & hp.hash_mask;
}

__device__ __forceinline__ void minhash_epilogue(const Epilogue& ep, int row,
                                                 int lo, int hi,
                                                 const uint32_t* hs,
                                                 uint32_t* part) {
  const int k = ep.p0;
  const uint32_t* a = static_cast<const uint32_t*>(ep.a);
  const uint32_t* b = static_cast<const uint32_t*>(ep.b);
  uint32_t* orow =
      static_cast<uint32_t*>(ep.out) + static_cast<size_t>(row) * k;
  if (k < kThreads) {
    const int groups = kThreads / k;
    const int lane = threadIdx.x % k;
    const int g = threadIdx.x / k;
    uint32_t m = 0xFFFFFFFFu;
    if (g < groups) {
      const uint32_t av = a[lane], bv = b[lane];
      // unrolled on request: inside the descriptor loop the compiler left
      // it rolled, one dependent shared load, multiply-add and min a window
#pragma unroll 16
      for (int j = lo + g; j < hi; j += groups) m = min(m, av * hs[j] + bv);
    }
    part[threadIdx.x] = m;
    __syncthreads();
    if (threadIdx.x < k) {
      for (int gg = 1; gg < groups; ++gg)
        m = min(m, part[gg * k + threadIdx.x]);
      if (m != 0xFFFFFFFFu) atomicMin(orow + threadIdx.x, m);
    }
  } else {
    for (int lane = threadIdx.x; lane < k; lane += kThreads) {
      const uint32_t av = a[lane], bv = b[lane];
      uint32_t m = 0xFFFFFFFFu;
#pragma unroll 16
      for (int j = lo; j < hi; ++j) m = min(m, av * hs[j] + bv);
      if (m != 0xFFFFFFFFu) atomicMin(orow + lane, m);
    }
  }
}

__device__ __forceinline__ void hll_epilogue(const Epilogue& ep, int lo,
                                             int hi, const uint32_t* hs) {
  const int b = ep.p0, rank_bits = ep.p1;
  const uint32_t idx_mask = (1u << b) - 1u;
  int* regs = static_cast<int*>(ep.out);
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
    const uint32_t h = hs[j];
    const uint32_t rest = h >> b;
    // __ffs(0) is 0, so the zero case is spelled out: ctz(0) = 32
    const int tz = rest ? __ffs(static_cast<int>(rest)) - 1 : 32;
    const int rank = min(tz, rank_bits) + 1;
    int* r = regs + (h & idx_mask);
    if (rank > __ldcg(r)) atomicMax(r, rank);
  }
}

__device__ __forceinline__ void countmin_epilogue(const Epilogue& ep, int lo,
                                                  int hi,
                                                  const uint32_t* hs) {
  const int depth = ep.p0, lw = ep.p1;
  const uint32_t* a = static_cast<const uint32_t*>(ep.a);
  const uint32_t* b = static_cast<const uint32_t*>(ep.b);
  int* table = static_cast<int*>(ep.out);
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
    const uint32_t h = hs[j];
    for (int d = 0; d < depth; ++d) {
      const uint32_t col = (__ldg(a + d) * h + __ldg(b + d)) >> (32 - lw);
      atomicAdd(table + (static_cast<size_t>(d) << lw) + col, 1);
    }
  }
}

__device__ __forceinline__ void bloom_epilogue(const Epilogue& ep, int row,
                                               int lo, int hi,
                                               const uint32_t* hs,
                                               const uint32_t* hbs,
                                               uint32_t* part) {
  const int k = ep.p0, log2_m = ep.p1;
  const uint32_t m_mask = log2_m == 32 ? 0xFFFFFFFFu : (1u << log2_m) - 1u;
  const uint32_t* words = static_cast<const uint32_t*>(ep.a);
  unsigned hits = 0;
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
    const uint32_t ha = hs[j], stride = hbs[j] | 1u;
    bool all = true;
    for (int i = 0; i < k && all; ++i) {
      const uint32_t p = (ha + static_cast<uint32_t>(i) * stride) & m_mask;
      all = (__ldg(words + (p >> 5)) >> (p & 31u)) & 1u;
    }
    hits += all;
  }
  hits = __reduce_add_sync(0xFFFFFFFFu, hits);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = hits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += part[w];
    if (total)
      atomicAdd(static_cast<int*>(ep.out) + row, static_cast<int>(total));
  }
}

// kTwo: the plan has a Bloom sketch, so the second stream xb is staged and
// hashed too; plans without one keep the smaller shared footprint.
template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
sketch_plan_kernel(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ xb, int S, int W,
                   const int32_t* __restrict__ n_windows,
                   const int32_t* __restrict__ w_start, int seg,
                   const __grid_constant__ PlanDesc plan,
                   const __grid_constant__ HashParams hp) {
  constexpr int kSegB = kTwo ? kSeg : 1;
  __shared__ uint32_t xs[kSeg + kMaxN - 1];
  __shared__ uint32_t xbs[kSegB + kMaxN - 1];
  __shared__ uint32_t hs[kSeg];
  __shared__ uint32_t hbs[kSegB];
  __shared__ uint32_t part[kThreads];

  const int row = blockIdx.x;
  const int seg0 = blockIdx.y * seg;
  const int nw = min(n_windows[row], W);
  const int ws = w_start ? max(w_start[row], 0) : 0;
  // this segment's valid windows, relative to seg0: [lo, hi)
  const int lo = max(ws - seg0, 0);
  const int hi = min(nw - seg0, seg);
  if (hi <= lo) return;  // uniform over the block

  // symbols [lo, hi + n - 1) of the segment; the last one read is at most
  // n_windows + n - 2 <= S - 1
  const size_t base = static_cast<size_t>(row) * S + seg0;
  for (int i = lo + threadIdx.x; i < hi + hp.n - 1; i += kThreads) {
    xs[i] = x[base + i];
    if (kTwo) xbs[i] = xb[base + i];
  }
  __syncthreads();
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
    hs[j] = window_hash(xs + j, hp);
    if (kTwo) hbs[j] = window_hash(xbs + j, hp);
  }
  __syncthreads();

  // one copy of the epilogue code: the descriptors are read from the
  // kernel's constant bank (__grid_constant__) at a dynamic index
#pragma unroll 1
  for (int e = 0; e < plan.n_sketches; ++e) {
    const Epilogue& ep = plan.sk[e];
    switch (ep.kind) {
      case kMinHash: minhash_epilogue(ep, row, lo, hi, hs, part); break;
      case kHll: hll_epilogue(ep, lo, hi, hs); break;
      case kCountMin: countmin_epilogue(ep, lo, hi, hs); break;
      default: bloom_epilogue(ep, row, lo, hi, hs, hbs, part); break;
    }
    // part[] is reused by the next epilogue; none follows the last
    if (e + 1 < plan.n_sketches) __syncthreads();
  }
}

// bytes of an epilogue's output for a launch of B rows
size_t out_bytes(const Epilogue& ep, int B) {
  switch (ep.kind) {
    case kMinHash: return static_cast<size_t>(B) * ep.p0 * 4;
    case kHll: return (static_cast<size_t>(1) << ep.p0) * 4;
    case kCountMin: return (static_cast<size_t>(ep.p0) << ep.p1) * 4;
    default: return static_cast<size_t>(B) * 4;
  }
}

bool epilogue_ok(const Epilogue& ep, bool has_xb) {
  if (ep.out == nullptr) return false;
  switch (ep.kind) {
    case kMinHash: return ep.p0 >= 1 && ep.a && ep.b;
    case kHll: return ep.p0 >= 1 && ep.p0 <= 31 && ep.p1 >= 0;
    case kCountMin:
      return ep.p0 >= 1 && ep.p1 >= 1 && ep.p1 <= 30 && ep.a && ep.b;
    case kBloom: return has_xb && ep.p0 >= 1 && ep.p1 >= 5 && ep.p1 <= 32 &&
                        ep.a;
    default: return false;
  }
}

}  // namespace

// Plain C interface, bound with ctypes. Device pointers: x and xb (B, S)
// uint32 (xb, the second stream, only for plans with a Bloom sketch, else
// null), n_windows (B,) int32, w_start (B,) int32 or null, and every
// pointer inside `plan` (a HOST struct). xpow is a HOST array of n values
// x^(n-1-t) mod p (GENERAL only; may be null for CYCLIC). Runs on `stream`
// and does not synchronise. Returns cudaGetLastError() after the launch
// (0 = success), or cudaErrorInvalidValue for arguments out of range.
extern "C" int sketch_plan(
    const void* x, const void* xb, int B, int S, const void* n_windows,
    const void* w_start, const PlanDesc* plan, int family, int n, int L,
    unsigned int hash_mask, unsigned int p_low, const unsigned int* xpow,
    void* stream) {
  if (B < 0 || n < 1 || n > kMaxN || L < n || L > 32 || plan == nullptr ||
      plan->n_sketches < 1 || plan->n_sketches > kMaxSketches ||
      (family != 0 && family != 1) || (family == 1 && xpow == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int e = 0; e < plan->n_sketches; ++e)
    if (!epilogue_ok(plan->sk[e], xb != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  const int W = S - n + 1;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int seg = kSeg;
  auto n_segs = [W](int s) { return W > 0 ? (W + s - 1LL) / s : 0LL; };
  while (seg > kMinSeg &&
         static_cast<long long>(B) * n_segs(seg) <
             static_cast<long long>(kBlocksPerSm) * sms)
    seg /= 2;
  const long long segs = n_segs(seg);
  if (segs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int e = 0; e < plan->n_sketches; ++e) {
    const Epilogue& ep = plan->sk[e];
    const size_t bytes = out_bytes(ep, B);
    const cudaError_t fill =
        ep.init ? cudaMemcpyAsync(ep.out, ep.init, bytes,
                                  cudaMemcpyDeviceToDevice, st)
                : cudaMemsetAsync(ep.out, ep.kind == kMinHash ? 0xFF : 0,
                                  bytes, st);
    if (fill != cudaSuccess) return static_cast<int>(fill);
  }
  if (B == 0 || segs == 0) return static_cast<int>(cudaGetLastError());

  HashParams hp{};
  hp.family = family;
  hp.n = n;
  hp.L = L;
  hp.lmask = L == 32 ? 0xFFFFFFFFu : ((1u << L) - 1u);
  hp.hash_mask = hash_mask;
  hp.p_low = p_low;
  if (family == 1)
    for (int t = 0; t < n; ++t) hp.xpow[t] = xpow[t];

  const dim3 grid(B, static_cast<unsigned int>(segs));
  auto kernel = xb ? sketch_plan_kernel<true> : sketch_plan_kernel<false>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(xb), S,
      W, static_cast<const int32_t*>(n_windows),
      static_cast<const int32_t*>(w_start), seg, *plan, hp);
  return static_cast<int>(cudaGetLastError());
}
