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
// Design:
//   * ONE ordinary launch of min(tiles, resident blocks) blocks of 256
//     threads. A tile is one row's segment of up to kSeg windows; the
//     launcher halves the segment (down to kMinSeg) while the rows would
//     hold fewer than kBlocksPerSm tiles per SM. Each block walks the
//     linear tile index with a stride of the grid (so no grid-dimension
//     limit), and skips an empty tile as a whole block, which keeps its
//     barriers uniform. The index is 32 bits: 2^30 tiles of at least 64
//     windows would need an input of 256 GiB, and a 64-bit index cost the
//     kernel registers that slowed every plan (PERF.md §6). The valid
//     windows of a row form one contiguous range, so a tile clips its
//     segment to that range.
//   * Hash once: a tile stages its symbols plus the n-1 halo in shared
//     memory (both streams for a Bloom plan) and hashes each valid window
//     once into shared memory. Every epilogue then reads the hashes there.
//     The kernel has two instances, with and without the second stream, so
//     a plan without Bloom keeps the smaller shared footprint; the
//     epilogues' descriptors are read at a dynamic index from the
//     kernel's constant bank, so their code appears once.
//   * The launcher fills each output from its init carry, or with the
//     sketch's identity (0xFFFFFFFF for MinHash, 0 for the others), on the
//     launch's stream, except where the carry is donated (init == out):
//     then the kernel folds into it in place and nothing is filled. All
//     merges are order-free (min, max, +), so the result is bit-identical
//     whatever the block schedule.
//   * MinHash: thread t owns signature lane t % k over the window group
//     t / k; the groups fold in shared memory and each lane does one
//     atomicMin, once per tile.
//   * HLL, b <= 14: the block keeps the register file in (dynamic) shared
//     memory for all its tiles. It seeds the file from the output
//     registers, raises it in shared memory (read, and atomicMax only when
//     larger) and marks each register it raised in a bitmap; at its end it
//     issues one global atomicMax for each marked register. Registers only
//     rise, so a seed read stale while other blocks raise costs at most an
//     extra atomic and never loses an update. A plan's HLL files share up
//     to kMaxHllSmem bytes; the launch then runs at most kHllBlocksPerSm
//     blocks an SM, so each block's seed read and flush are spread over
//     several tiles. Above b = 14 (or past that budget): a global
//     atomicMax per window, skipped when an L2 read of the register already
//     shows the rank.
//   * CountMin: depth global atomicAdds per window (REDs into L2). At the
//     stats default (depth 4, w = 16) the table is 1 MiB, too large for
//     shared memory; chip_smoke.py times the same increments issued alone
//     (tools/countmin_red_floor.cu), the floor of this design.
//   * Bloom: the filter (512 KiB at log2_m = 22) does not fit in shared
//     memory; probes read it through the read-only path (__ldg) and L2
//     holds it. Hits reduce per warp, then per block, and each tile does
//     one atomicAdd for its row.
//
// What bounds it: per window it reads 4 bytes of input (8 for Bloom) and
// issues integer work and memory operations: k multiply-adds and mins for
// MinHash, depth atomics for CountMin, up to k filter loads for Bloom, at
// most one shared-memory update for HLL. So it is bound by instruction
// issue and by the atomics' and loads' rate, not by bytes. MinHash and
// Bloom are still the first, direct designs.

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <vector>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 1024;   // most windows per tile
constexpr int kMinSeg = 64;  // fewest windows per tile
constexpr int kBlocksPerSm = 4;  // tiles per SM below which segments halve
constexpr int kMaxN = 32;    // n <= L <= 32
constexpr int kMaxSketches = 8;
constexpr int kMaxSharedB = 14;  // HLL register files in shared memory
// the shared HLL files of one plan, with their raised-register bitmaps:
// one file at b = 14, or several smaller ones
constexpr int kMaxHllSmem = (4 << kMaxSharedB) + (1 << kMaxSharedB) / 8;
constexpr int kHllBlocksPerSm = 4;  // blocks an SM with shared HLL files

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
  int smem;          // HLL: word offset of its shared register file, or -1
                     // for the global path (set by the launcher)
  const void* a;     // MinHash / CountMin a (uint32); Bloom filter words
  const void* b;     // MinHash / CountMin b (uint32)
  const void* init;  // carry in (the output's shape and type), or null;
                     // equal to out when the carry is donated
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

__device__ __forceinline__ int hll_rank(uint32_t h, int b, int rank_bits) {
  const uint32_t rest = h >> b;
  // __ffs(0) is 0, so the zero case is spelled out: ctz(0) = 32
  const int tz = rest ? __ffs(static_cast<int>(rest)) - 1 : 32;
  return min(tz, rank_bits) + 1;
}

// A shared HLL file: 2^b registers, then one bit a register, set when the
// block raised it above its seed.
__device__ __forceinline__ int* hll_file(const Epilogue& ep, uint32_t* dyn) {
  return reinterpret_cast<int*>(dyn + ep.smem);
}

__device__ __forceinline__ uint32_t* hll_raised(const Epilogue& ep,
                                                uint32_t* dyn) {
  return dyn + ep.smem + (1u << ep.p0);
}

// Seed the block's file from the output registers (filled by the launcher,
// or the donated carry). __ldcg reads L2: other blocks raise the registers
// with atomics, and a value read stale is only lower.
__device__ __forceinline__ void hll_seed(const Epilogue& ep, uint32_t* dyn) {
  const int m = 1 << ep.p0;
  const int* regs = static_cast<const int*>(ep.out);
  int* file = hll_file(ep, dyn);
  if (m % 4 == 0 && (reinterpret_cast<uintptr_t>(regs) & 15) == 0) {
    const int4* r4 = reinterpret_cast<const int4*>(regs);
    int4* f4 = reinterpret_cast<int4*>(file);
    for (int i = threadIdx.x; i < m / 4; i += kThreads) f4[i] = __ldcg(r4 + i);
  } else {
    for (int i = threadIdx.x; i < m; i += kThreads) file[i] = __ldcg(regs + i);
  }
  uint32_t* raised = hll_raised(ep, dyn);
  for (int i = threadIdx.x; i < (m + 31) / 32; i += kThreads) raised[i] = 0;
}

// One global atomicMax for each register the block raised.
__device__ __forceinline__ void hll_flush(const Epilogue& ep, uint32_t* dyn) {
  const int m = 1 << ep.p0;
  int* regs = static_cast<int*>(ep.out);
  const int* file = hll_file(ep, dyn);
  const uint32_t* raised = hll_raised(ep, dyn);
  for (int i = threadIdx.x; i < m; i += kThreads)
    if ((raised[i >> 5] >> (i & 31)) & 1u) atomicMax(regs + i, file[i]);
}

__device__ __forceinline__ void hll_epilogue(const Epilogue& ep, int lo,
                                             int hi, const uint32_t* hs,
                                             uint32_t* dyn) {
  const int b = ep.p0, rank_bits = ep.p1;
  const uint32_t idx_mask = (1u << b) - 1u;
  if (ep.smem >= 0) {
    int* file = hll_file(ep, dyn);
    uint32_t* raised = hll_raised(ep, dyn);
    for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
      const uint32_t h = hs[j], i = h & idx_mask;
      const int rank = hll_rank(h, b, rank_bits);
      // a stale read is only lower: an extra atomic, never a lost update;
      // the atomic leaves the register at least rank > seed, so it rose
      if (rank > file[i]) {
        atomicMax(file + i, rank);
        atomicOr(raised + (i >> 5), 1u << (i & 31));
      }
    }
    return;
  }
  int* regs = static_cast<int*>(ep.out);
  for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
    const uint32_t h = hs[j];
    const int rank = hll_rank(h, b, rank_bits);
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
// hashed too; plans without one keep the smaller shared footprint. The
// dynamic shared memory holds the plan's shared HLL files (none, and no
// bytes, for a plan without one).
template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
sketch_plan_kernel(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ xb, int S, int W,
                   const int32_t* __restrict__ n_windows,
                   const int32_t* __restrict__ w_start, int seg, int segs,
                   int tiles,
                   const __grid_constant__ PlanDesc plan,
                   const __grid_constant__ HashParams hp) {
  constexpr int kSegB = kTwo ? kSeg : 1;
  __shared__ uint32_t xs[kSeg + kMaxN - 1];
  __shared__ uint32_t xbs[kSegB + kMaxN - 1];
  __shared__ uint32_t hs[kSeg];
  __shared__ uint32_t hbs[kSegB];
  __shared__ uint32_t part[kThreads];
  extern __shared__ uint32_t dyn[];

  bool shared_hll = false;
#pragma unroll 1
  for (int e = 0; e < plan.n_sketches; ++e)
    if (plan.sk[e].kind == kHll && plan.sk[e].smem >= 0) {
      hll_seed(plan.sk[e], dyn);
      shared_hll = true;
    }
  if (shared_hll) __syncthreads();

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row = t / segs;
    const int seg0 = (t % segs) * seg;
    const int nw = min(n_windows[row], W);
    const int ws = w_start ? max(w_start[row], 0) : 0;
    // this tile's valid windows, relative to seg0: [lo, hi)
    const int lo = max(ws - seg0, 0);
    const int hi = min(nw - seg0, seg);
    if (hi <= lo) continue;  // uniform over the block

    // symbols [lo, hi + n - 1) of the segment; the last one read is at
    // most n_windows + n - 2 <= S - 1
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
        case kHll: hll_epilogue(ep, lo, hi, hs, dyn); break;
        case kCountMin: countmin_epilogue(ep, lo, hi, hs); break;
        default: bloom_epilogue(ep, row, lo, hi, hs, hbs, part); break;
      }
      // part[] is reused by the next epilogue, and xs, hs by the next tile
      __syncthreads();
    }
  }

  if (shared_hll) {
#pragma unroll 1
    for (int e = 0; e < plan.n_sketches; ++e)
      if (plan.sk[e].kind == kHll && plan.sk[e].smem >= 0)
        hll_flush(plan.sk[e], dyn);
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

// The blocks of one instance that an SM holds at `smem` bytes of dynamic
// shared memory, and the SM count, cached per device (a launch asks the
// runtime once per device, instance and footprint).
struct Residency {
  int dev, two, smem, blocks, sms;
};

cudaError_t residency(bool two, int smem, int* blocks, int* sms) {
  static std::mutex mu;
  static std::vector<Residency> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Residency& r : seen)
    if (r.dev == dev && r.two == two && r.smem == smem) {
      *blocks = r.blocks;
      *sms = r.sms;
      return cudaSuccess;
    }
  auto kernel = two ? sketch_plan_kernel<true> : sketch_plan_kernel<false>;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  // above 48 KiB a kernel must opt in to its dynamic shared memory
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxHllSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  seen.push_back({dev, two, smem, *blocks, *sms});
  return cudaSuccess;
}

}  // namespace

// Plain C interface, bound with ctypes. Device pointers: x and xb (B, S)
// uint32 (xb, the second stream, only for plans with a Bloom sketch, else
// null), n_windows (B,) int32, w_start (B,) int32 or null, and every
// pointer inside `plan` (a HOST struct). A sketch whose init equals its out
// has its carry donated: it is folded into in place, with no fill. xpow is
// a HOST array of n values x^(n-1-t) mod p (GENERAL only; may be null for
// CYCLIC). Runs on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for arguments out of range.
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
  // the launch's own copy of the plan: HLL files get their shared offsets
  PlanDesc desc = *plan;
  int words = 0;
  for (int e = 0; e < desc.n_sketches; ++e) {
    Epilogue& ep = desc.sk[e];
    ep.smem = -1;
    if (ep.kind != kHll || ep.p0 > kMaxSharedB) continue;
    // the registers and their bitmap, rounded to 16 bytes for the seed's
    // vector stores
    const int need = ((1 << ep.p0) + ((1 << ep.p0) + 31) / 32 + 3) & ~3;
    if (4 * (words + need) > kMaxHllSmem) continue;
    ep.smem = words;
    words += need;
  }
  const int smem = 4 * words;
  int blocks = 0, sms = 0;
  cudaError_t err = residency(xb != nullptr, smem, &blocks, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);

  const int W = S - n + 1;
  int seg = kSeg;
  auto n_segs = [W](int s) { return W > 0 ? (W + s - 1LL) / s : 0LL; };
  while (seg > kMinSeg &&
         static_cast<long long>(B) * n_segs(seg) <
             static_cast<long long>(kBlocksPerSm) * sms)
    seg /= 2;
  const long long segs = n_segs(seg);
  const long long tiles = static_cast<long long>(B) * segs;
  // the 32-bit tile index, with room for the grid stride past the end
  if (tiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int e = 0; e < desc.n_sketches; ++e) {
    const Epilogue& ep = desc.sk[e];
    if (ep.init == ep.out) continue;  // donated: folded into in place
    const size_t bytes = out_bytes(ep, B);
    const cudaError_t fill =
        ep.init ? cudaMemcpyAsync(ep.out, ep.init, bytes,
                                  cudaMemcpyDeviceToDevice, st)
                : cudaMemsetAsync(ep.out, ep.kind == kMinHash ? 0xFF : 0,
                                  bytes, st);
    if (fill != cudaSuccess) return static_cast<int>(fill);
  }
  if (tiles == 0) return static_cast<int>(cudaGetLastError());

  HashParams hp{};
  hp.family = family;
  hp.n = n;
  hp.L = L;
  hp.lmask = L == 32 ? 0xFFFFFFFFu : ((1u << L) - 1u);
  hp.hash_mask = hash_mask;
  hp.p_low = p_low;
  if (family == 1)
    for (int t = 0; t < n; ++t) hp.xpow[t] = xpow[t];

  long long resident = static_cast<long long>(blocks) * sms;
  if (words > 0)
    resident = std::min(resident, static_cast<long long>(kHllBlocksPerSm) *
                                      sms);
  const unsigned int grid =
      static_cast<unsigned int>(std::min(tiles, resident));
  auto kernel = xb ? sketch_plan_kernel<true> : sketch_plan_kernel<false>;
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(xb), S,
      W, static_cast<const int32_t*>(n_windows),
      static_cast<const int32_t*>(w_start), seg, static_cast<int>(segs),
      static_cast<int>(tiles), desc, hp);
  return static_cast<int>(cudaGetLastError());
}
