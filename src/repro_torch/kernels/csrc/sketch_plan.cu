// The plan kernel's MinHash epilogue, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/sketch_fused.py::sketch_plan_fused (kernel body _plan_kernel,
// MinHash epilogue _minhash_tile) for plans whose sketches are all MinHash.
// Only the bits are the contract: for each row r and signature lane i,
//
//   out[r, i] = min(init[r, i],
//                   min over valid windows j of (a[i] * h_j + b[i]) mod 2^32)
//
// where h_j is the window's rolling hash (CYCLIC: XOR of rotations; GENERAL:
// XOR of carry-less products with x^(n-1-t) mod p) masked by hash_mask (the
// Theorem-1 discard), and window j is valid iff w_start[r] <= j < n_windows[r].
// An invalid window contributes nothing, which equals the reference's
// substitution of 0xFFFFFFFF after the remix.
//
// Design (simple first):
//   * grid = rows x window segments; 256 threads a block. A segment holds
//     up to kSeg windows; the launcher halves it (down to kMinSeg) while
//     the grid would hold fewer than kBlocksPerSm blocks per SM, so a
//     launch of few rows still spreads over the card.
//   * The valid windows of a row form one contiguous range, so a block
//     clips its segment to that range and returns early when it is empty.
//   * The block stages its symbols plus the n-1 halo in shared memory,
//     hashes each valid window once into shared memory, then thread t owns
//     signature lane t % k over the window group t / k: one multiply-add
//     and one min per window and lane, reading the hash by broadcast.
//   * The window groups are folded in shared memory and each lane does one
//     atomicMin into out. Unsigned min is order-free, so the result is
//     bit-identical whatever the schedule. The launcher pre-fills out from
//     init, or with 0xFFFFFFFF.
//
// What bounds it: per window it reads 4 bytes of input and issues about k
// multiply-adds and k mins (k = 64 on the dedup path), so it is bound by
// integer issue, not by bytes. This design does nothing yet about that
// bound (no unrolling over lanes, no specialisation on n or the family);
// making it fast is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 1024;   // most windows per block
constexpr int kMinSeg = 64;  // fewest windows per block
constexpr int kBlocksPerSm = 4;
constexpr int kMaxN = 32;    // n <= L <= 32

struct HashParams {
  int family;            // 0 = CYCLIC, 1 = GENERAL
  int n;
  int L;
  uint32_t lmask;        // the L low bits
  uint32_t hash_mask;    // discard mask applied to every window hash
  uint32_t p_low;        // GENERAL: modulus without its top bit
  uint32_t xpow[kMaxN];  // GENERAL: xpow[t] = x^(n-1-t) mod p
};

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

__global__ void __launch_bounds__(kThreads)
minhash_plan_kernel(const uint32_t* __restrict__ x, int S, int W,
                    const int32_t* __restrict__ n_windows,
                    const int32_t* __restrict__ w_start,
                    const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, int k, int seg,
                    uint32_t* __restrict__ out, HashParams hp) {
  __shared__ uint32_t xs[kSeg + kMaxN - 1];
  __shared__ uint32_t hs[kSeg];
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
  const uint32_t* xr = x + static_cast<size_t>(row) * S + seg0;
  for (int i = lo + threadIdx.x; i < hi + hp.n - 1; i += kThreads)
    xs[i] = xr[i];
  __syncthreads();
  for (int j = lo + threadIdx.x; j < hi; j += kThreads)
    hs[j] = window_hash(xs + j, hp);
  __syncthreads();

  uint32_t* orow = out + static_cast<size_t>(row) * k;
  if (k < kThreads) {
    const int groups = kThreads / k;
    const int lane = threadIdx.x % k;
    const int g = threadIdx.x / k;
    uint32_t m = 0xFFFFFFFFu;
    if (g < groups) {
      const uint32_t av = a[lane], bv = b[lane];
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
      for (int j = lo; j < hi; ++j) m = min(m, av * hs[j] + bv);
      if (m != 0xFFFFFFFFu) atomicMin(orow + lane, m);
    }
  }
}

}  // namespace

// Plain C interface, bound with ctypes. Device pointers: x (B, S) uint32,
// n_windows (B,) int32, w_start (B,) int32 or null, a and b (k,) uint32,
// init (B, k) uint32 or null, out (B, k) uint32. xpow is a HOST array of n
// values x^(n-1-t) mod p (GENERAL only; may be null for CYCLIC). Runs on
// `stream` and does not synchronise. Returns cudaGetLastError() after the
// launch (0 = success), or cudaErrorInvalidValue for arguments out of range.
extern "C" int sketch_plan_minhash(
    const void* x, int B, int S, const void* n_windows, const void* w_start,
    const void* a, const void* b, int k, const void* init, void* out,
    int family, int n, int L, unsigned int hash_mask, unsigned int p_low,
    const unsigned int* xpow, void* stream) {
  if (B < 0 || k < 1 || n < 1 || n > kMaxN || L < n || L > 32 ||
      (family != 0 && family != 1) || (family == 1 && xpow == nullptr))
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
  const size_t bytes = static_cast<size_t>(B) * k * sizeof(uint32_t);
  const cudaError_t fill =
      init ? cudaMemcpyAsync(out, init, bytes, cudaMemcpyDeviceToDevice, st)
           : cudaMemsetAsync(out, 0xFF, bytes, st);
  if (fill != cudaSuccess) return static_cast<int>(fill);
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
  minhash_plan_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(x), S, W,
      static_cast<const int32_t*>(n_windows),
      static_cast<const int32_t*>(w_start), static_cast<const uint32_t*>(a),
      static_cast<const uint32_t*>(b), k, seg, static_cast<uint32_t*>(out),
      hp);
  return static_cast<int>(cudaGetLastError());
}
