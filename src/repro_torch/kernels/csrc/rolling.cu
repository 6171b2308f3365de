// The plain window-hash kernels CYCLIC and GENERAL, hand-written for Hopper
// (sm_90a): the paper's Fig. 1 pair, and the byte path's CYCLIC over a
// symbol-table lookup.
//
// Replaces the JAX package's Pallas kernels
// repro/kernels/cyclic.py::cyclic_rolling (_cyclic_kernel),
// repro/kernels/general.py::general_rolling (_general_kernel, _mul_const)
// and repro/kernels/sketch_fused.py::cyclic_rolling_fused
// (_lookup_fused_kernel, _lookup_mxu). The first two map (B, S) uint32
// symbols to (B, S-n+1) uint32 window hashes, with every symbol first
// masked to its L low bits and no discard:
//
//   CYCLIC   H_j = XOR_t rotl_L(x[j+t], n-1-t)
//   GENERAL  H_j = XOR_t x[j+t] * x^(n-1-t) mod p   (carry-less, degree L)
//
// The third (the paper's inner loop, h1[c] then Algorithm 4) maps (B, S)
// int32 byte tokens and a 256-entry uint32 table to the CYCLIC hashes of
// x = table[c] & mask(L). A token outside [0, 256) reads the entry the
// JAX package's plain version reads: a negative token counts from the end
// once, then the index is clamped to [0, 255]. The TPU did the lookup as a
// one-hot matmul on its matrix unit; here the 1 KiB table sits in shared
// memory and is gathered directly while the block stages its symbols.
//
// Design: hash the way the paper does. A block covers kThreads * kRun
// consecutive windows of one row and stages their symbols (plus the n-1
// halo) in shared memory with coalesced loads; above n = 32 the halo is
// sized at launch (dynamic shared memory), so any n whose block fits in
// shared memory runs, n > L included. Thread t owns the run of kRun windows starting at
// t * kRun: it hashes the first directly (n terms; GENERAL by Horner's
// rule, h = x * h ^ x[t], which needs no table of powers), then rolls
// through the rest with the recursive update
//
//   CYCLIC   h' = rotl(h, 1) ^ rotl(x_out, n mod L) ^ x_in  (Algorithm 4)
//   GENERAL  h' = x * h ^ (x^n mod p) * x_out ^ x_in        (Algorithm 3)
//
// which gives the direct form's bits. GENERAL's product x^n * v mod p has a
// fixed cost a window, whatever n is, on one of two routes the wrapper picks
// from (n, p, L) alone (kernels/general.py::route):
//
//   the fold    (n < L, n + deg(p_low) <= L, at most kFoldTerms set bits in
//               p_low): with t = v >> (L - n), the top n bits of v,
//               x^n * v = (v << n) ^ t * x^L = (v << n) ^ t * p_low, and
//               t * p_low, of degree below L, is the XOR of t shifted by
//               each set bit of p_low: no reduction is left. The shifts
//               come by value; the term count is a template parameter.
//   the tables  (any (n, p, L)): byte-wide chunk tables in shared memory,
//               Lemma 2's split (gf2.build_shiftn_table_host) cut into
//               bytes: for n < L, (v << n) ^ XOR_c T_c[byte c of the top n
//               bits]; for n >= L, XOR_c T_c[byte c of v] with T_c[b] =
//               (b << 8c) * x^n mod p. At most 4 x 256 words, built once by
//               the wrapper and staged by each block.
//
// Every rotation is taken mod L, so
// n > L gives the plain version's bits. A row of more segments than a grid
// dimension holds (65,535, some 285 M windows) runs as one launch for each
// group of 65,535 segments, each told its first segment. kRun is odd, so
// the 32 threads of a warp, reading shared memory kRun words apart, hit 32
// distinct banks. The
// hashes go back through shared memory and leave with coalesced stores;
// the ragged tail of a row is masked.
//
// What bounds it: 4 bytes read and 4 written per window, against three
// integer instructions a window for CYCLIC at L = 32 (two funnel shifts
// and a three-input XOR; the lookup adds a clamp and a shared-memory load)
// and, for GENERAL at L = 32, one shift-reduce step for x * h, and the
// fold's shifts and XORs (11 instructions a window at n = 8 with the
// default p) or the tables' extracts, shared loads and XORs. All of them
// are bound by bytes at n = 8, L = 32 on an H100; the kernel does no more
// than the rolling recurrence and coalesced staging about that bound.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 17;                     // windows a thread rolls over
constexpr int kBlockWin = kThreads * kRun;   // windows a block covers
constexpr int kMaxN = 32;                    // a fixed halo up to n = 32
constexpr int kSigma = 256;                  // the byte path's alphabet
constexpr long long kMaxSegs = 65535;        // segments a launch's grid.y holds
constexpr int kFoldTerms = 4;   // most set bits of p_low the fold takes
constexpr int kMaxChunks = 4;   // byte chunks of a 32-bit v

struct RollParams {
  int n;
  int L;
  uint32_t lmask;        // the L low bits
  uint32_t p_low;        // GENERAL: modulus without its top bit
  int low_shift;         // GENERAL: v << low_shift is x^n * v's low part;
                         // 32 (none) when n >= L
  int top_shift;         // GENERAL: the overflow's first bit in v (L - n),
                         // 0 when n >= L (the tables read all of v)
  int fold[kFoldTerms];  // the fold: the set bits of p_low, in order
};

__device__ __forceinline__ uint32_t rotl_l(uint32_t v, int r, int L,
                                           uint32_t m) {
  if (r == 0) return v;  // a shift by L would be undefined
  return ((v << r) | (v >> (L - r))) & m;
}

__device__ __forceinline__ uint32_t xtimes(uint32_t v, const RollParams& rp) {
  const uint32_t msb = (v >> (rp.L - 1)) & 1u;
  return ((v << 1) & rp.lmask) ^ (msb * rp.p_low);
}

// x^n * v mod p by the fold, kTerms set bits in p_low (n < L)
template <int kTerms>
__device__ __forceinline__ uint32_t xn_fold(uint32_t v, const RollParams& rp) {
  const uint32_t t = v >> rp.top_shift;
  uint32_t m = (v << rp.n) & rp.lmask;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) m ^= t << rp.fold[k];
  return m;
}

// x^n * v mod p from kChunks byte-wide tables in shared memory
template <int kChunks>
__device__ __forceinline__ uint32_t xn_tables(uint32_t v, const RollParams& rp,
                                              const uint32_t* tab) {
  // a funnel shift clamps at 32: no low part when n >= L
  uint32_t m = __funnelshift_lc(0u, v, rp.low_shift) & rp.lmask;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    m ^= tab[c * kSigma + ((v >> (rp.top_shift + 8 * c)) & 0xffu)];
  return m;
}

// The table entry a byte token reads (the JAX plain version's index rule).
__device__ __forceinline__ int byte_index(int t) {
  if (t < 0) t += kSigma;
  return min(max(t, 0), kSigma - 1);
}

// kFamily: 0 = CYCLIC, 1 = GENERAL by the fold (kWays terms), 2 = CYCLIC
// over int32 byte tokens looked up in `table`, 3 = GENERAL by kWays chunk
// tables read from `table` (unused by families 0 and 1)
template <int kFamily, int kWays = 0>
__global__ void __launch_bounds__(kThreads)
rolling_kernel(const std::conditional_t<kFamily == 2, int32_t, uint32_t>*
                   __restrict__ x,
               int S, int W, int seg0, uint32_t* __restrict__ out,
               RollParams rp, const uint32_t* __restrict__ table) {
  constexpr bool kCyclic = kFamily == 0 || kFamily == 2;
  __shared__ uint32_t hs[kBlockWin];
  // the symbols with their n-1 halo: a fixed array up to n = kMaxN, sized
  // at launch (dynamic shared memory) above it; with the dynamic array for
  // every n the compiler's schedule cost plain CYCLIC 7 %
  __shared__ uint32_t xs_fixed[kBlockWin + kMaxN - 1];
  extern __shared__ uint32_t xs_wide[];
  uint32_t* xs = rp.n <= kMaxN ? xs_fixed : xs_wide;
  // GENERAL's chunk tables (family 3), read in the roll after the barrier
  // that ends the staging
  __shared__ uint32_t gtab[kFamily == 3 ? kWays * kSigma : 1];

  const int row = blockIdx.x;
  const int w0 = (seg0 + static_cast<int>(blockIdx.y)) * kBlockWin;
  const int nwin = min(kBlockWin, W - w0);
  const int n = rp.n;
  const auto* xr = x + static_cast<size_t>(row) * S + w0;
  if constexpr (kFamily == 2) {
    __shared__ uint32_t tab[kSigma];
    for (int i = threadIdx.x; i < kSigma; i += kThreads)
      tab[i] = table[i] & rp.lmask;
    __syncthreads();
    for (int i = threadIdx.x; i < nwin + n - 1; i += kThreads)
      xs[i] = tab[byte_index(xr[i])];
  } else {
    if constexpr (kFamily == 3) {
      for (int i = threadIdx.x; i < kWays * kSigma; i += kThreads)
        gtab[i] = table[i];
    }
    for (int i = threadIdx.x; i < nwin + n - 1; i += kThreads)
      xs[i] = xr[i] & rp.lmask;
  }
  __syncthreads();

  const int j0 = threadIdx.x * kRun;
  if (j0 < nwin) {
    // the first window directly: CYCLIC as n independent rotations (the
    // rotation is reduced mod L only past L, i.e. for n > L), GENERAL by
    // Horner's rule, h = x * h ^ x[t] (no table of powers)
    uint32_t h = 0;
    for (int t = 0; t < n; ++t) {
      const int r = n - 1 - t;
      h = kCyclic ? h ^ rotl_l(xs[j0 + t], r < rp.L ? r : r % rp.L, rp.L,
                               rp.lmask)
                  : xtimes(h, rp) ^ xs[j0 + t];
    }
    hs[j0] = h;
    const int j1 = min(j0 + kRun, nwin);
    const int r_out = n % rp.L, r_one = 1 % rp.L;
    for (int j = j0 + 1; j < j1; ++j) {
      const uint32_t x_out = xs[j - 1], x_in = xs[j + n - 1];
      if constexpr (kCyclic)
        h = rotl_l(h, r_one, rp.L, rp.lmask) ^
            rotl_l(x_out, r_out, rp.L, rp.lmask) ^ x_in;
      else if constexpr (kFamily == 1)
        h = xtimes(h, rp) ^ xn_fold<kWays>(x_out, rp) ^ x_in;
      else
        h = xtimes(h, rp) ^ xn_tables<kWays>(x_out, rp, gtab) ^ x_in;
      hs[j] = h;
    }
  }
  __syncthreads();
  uint32_t* orow = out + static_cast<size_t>(row) * W + w0;
  for (int i = threadIdx.x; i < nwin; i += kThreads) orow[i] = hs[i];
}

using U32Kernel = void (*)(const uint32_t*, int, int, int, uint32_t*,
                          RollParams, const uint32_t*);

// GENERAL's kernel for a route (1 the fold, 3 the tables) and its ways
U32Kernel general_kernel(int family, int ways) {
  static const U32Kernel fold[kFoldTerms] = {
      rolling_kernel<1, 1>, rolling_kernel<1, 2>, rolling_kernel<1, 3>,
      rolling_kernel<1, 4>};
  static const U32Kernel tables[kMaxChunks] = {
      rolling_kernel<3, 1>, rolling_kernel<3, 2>, rolling_kernel<3, 3>,
      rolling_kernel<3, 4>};
  return family == 1 ? fold[ways - 1] : tables[ways - 1];
}

// family as rolling_kernel's; ways: GENERAL's fold terms or chunk tables
int launch(int family, const void* x, int B, int S, int n, int L,
           const RollParams& rp, void* out, void* stream,
           const void* table = nullptr, int ways = 0) {
  if (B < 0 || n < 1 || L < 1 || L > 32 || S < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = S - n + 1;
  const long long segs = (W + kBlockWin - 1LL) / kBlockWin;
  if (B == 0) return static_cast<int>(cudaGetLastError());
  // above kMaxN the staged symbols with their n-1 halo take dynamic shared
  // memory; a kernel must opt in to it past 48 KiB with its static arrays,
  // and the block's whole footprint must fit the device's limit (n up to
  // about 45,000)
  const size_t smem =
      n <= kMaxN ? 0 : (static_cast<size_t>(kBlockWin) + n - 1) * 4;
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t fixed =
      (2 * kBlockWin + kMaxN - 1 + (family == 3 ? ways : 1) * kSigma) * 4;
  if (smem + fixed > static_cast<size_t>(most))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  const uint32_t* tp = static_cast<const uint32_t*>(table);
  uint32_t* op = static_cast<uint32_t*>(out);
  auto go = [&](auto kernel, const auto* xin) {
    if (smem > 0)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    // a launch for each group of kMaxSegs segments of every row
    for (long long s0 = 0; err == cudaSuccess && s0 < segs; s0 += kMaxSegs) {
      const dim3 grid(B, static_cast<unsigned int>(
                             segs - s0 < kMaxSegs ? segs - s0 : kMaxSegs));
      kernel<<<grid, kThreads, smem, st>>>(xin, S, W, static_cast<int>(s0),
                                           op, rp, tp);
      err = cudaGetLastError();
    }
  };
  if (family == 0)
    go(rolling_kernel<0>, xp);
  else if (family == 2)
    go(rolling_kernel<2>, static_cast<const int32_t*>(x));
  else
    go(general_kernel(family, ways), xp);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

RollParams params(int n, int L) {
  RollParams rp{};
  rp.n = n;
  rp.L = L;
  rp.lmask = L == 32 ? 0xFFFFFFFFu : ((1u << L) - 1u);
  return rp;
}

}  // namespace

// Windows one block covers: a row of W windows has ceil(W / this)
// segments (the size a check past the grid's 65,535 segments needs).
extern "C" int rolling_block_windows() { return kBlockWin; }

// Plain C interfaces, bound with ctypes. Device pointers: x (B, S) uint32,
// out (B, S-n+1) uint32. Run on `stream` and do not synchronise. Return
// cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int cyclic_rolling(const void* x, int B, int S, int n, int L,
                              void* out, void* stream) {
  if (L < 1 || L > 32) return static_cast<int>(cudaErrorInvalidValue);
  return launch(0, x, B, S, n, L, params(n, L), out, stream);
}

// p_low is the modulus without its top bit. route 1, the fold: ways is
// the number of set bits of p_low (1 to kFoldTerms), which are the fold's
// shifts, and n + deg(p_low) <= L with n < L; tables is unused. route 2,
// the tables: tables holds `ways` byte-wide chunk tables of 256 words
// (device pointer), ways = ceil(n / 8) for n < L and ceil(L / 8) for
// n >= L; kernels/general.py builds them. Any other combination is
// refused: there is no fallback.
extern "C" int general_rolling(const void* x, int B, int S, int n, int L,
                               unsigned int p_low, int route, int ways,
                               const void* tables, void* out, void* stream) {
  if (L < 1 || L > 32 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  RollParams rp = params(n, L);
  rp.p_low = p_low & rp.lmask;
  if (route == 1) {
    const int deg = 31 - __builtin_clz(rp.p_low | 1u);
    if (n >= L || n + deg > L || ways < 1 || ways > kFoldTerms ||
        __builtin_popcount(rp.p_low) != ways)
      return static_cast<int>(cudaErrorInvalidValue);
    rp.low_shift = n;
    rp.top_shift = L - n;
    for (int k = 0, bit = 0; bit < L; ++bit)
      if ((rp.p_low >> bit) & 1u) rp.fold[k++] = bit;
    return launch(1, x, B, S, n, L, rp, out, stream, nullptr, ways);
  }
  const int want = ((n < L ? n : L) + 7) / 8;
  if (route != 2 || tables == nullptr || ways != want)
    return static_cast<int>(cudaErrorInvalidValue);
  rp.low_shift = n < L ? n : 32;
  rp.top_shift = n < L ? L - n : 0;
  return launch(3, x, B, S, n, L, rp, out, stream, tables, ways);
}

// tokens (B, S) int32 byte tokens, table (256,) uint32 (device pointers);
// out (B, S-n+1) uint32: the CYCLIC hashes of table[token] & mask(L).
extern "C" int cyclic_rolling_fused(const void* tokens, const void* table,
                                    int B, int S, int n, int L, void* out,
                                    void* stream) {
  if (L < 1 || L > 32 || table == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(2, tokens, B, S, n, L, params(n, L), out, stream, table);
}
