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
// which gives the direct form's bits. Every rotation is taken mod L, so
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
// and one shift-reduce step per bit of x^n mod p for GENERAL (29
// instructions at n = 8). At n = 8, L = 32 all three are bound by bytes on
// an H100, GENERAL with its integer work at about 0.7 of its byte time.
// This first version does no more than the rolling recurrence and
// coalesced staging about either bound.

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

struct RollParams {
  int n;
  int L;
  uint32_t lmask;        // the L low bits
  uint32_t p_low;        // GENERAL: modulus without its top bit
  uint32_t c_out;        // GENERAL: x^n mod p
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

__device__ __forceinline__ uint32_t mul_const(uint32_t v, uint32_t c,
                                              const RollParams& rp) {
  uint32_t acc = 0;
  while (c) {
    if (c & 1u) acc ^= v;
    c >>= 1;
    if (c) v = xtimes(v, rp);
  }
  return acc;
}

// The table entry a byte token reads (the JAX plain version's index rule).
__device__ __forceinline__ int byte_index(int t) {
  if (t < 0) t += kSigma;
  return min(max(t, 0), kSigma - 1);
}

// kFamily: 0 = CYCLIC, 1 = GENERAL, 2 = CYCLIC over int32 byte tokens
// looked up in `table` (unused by the other two)
template <int kFamily>
__global__ void __launch_bounds__(kThreads)
rolling_kernel(const std::conditional_t<kFamily == 2, int32_t, uint32_t>*
                   __restrict__ x,
               int S, int W, int seg0, uint32_t* __restrict__ out,
               RollParams rp, const uint32_t* __restrict__ table) {
  constexpr bool kCyclic = kFamily != 1;
  __shared__ uint32_t hs[kBlockWin];
  // the symbols with their n-1 halo: a fixed array up to n = kMaxN, sized
  // at launch (dynamic shared memory) above it; with the dynamic array for
  // every n the compiler's schedule cost plain CYCLIC 7 %
  __shared__ uint32_t xs_fixed[kBlockWin + kMaxN - 1];
  extern __shared__ uint32_t xs_wide[];
  uint32_t* xs = rp.n <= kMaxN ? xs_fixed : xs_wide;

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
      if (kCyclic)
        h = rotl_l(h, r_one, rp.L, rp.lmask) ^
            rotl_l(x_out, r_out, rp.L, rp.lmask) ^ x_in;
      else
        h = xtimes(h, rp) ^ mul_const(x_out, rp.c_out, rp) ^ x_in;
      hs[j] = h;
    }
  }
  __syncthreads();
  uint32_t* orow = out + static_cast<size_t>(row) * W + w0;
  for (int i = threadIdx.x; i < nwin; i += kThreads) orow[i] = hs[i];
}

int launch(int family, const void* x, int B, int S, int n, int L,
           const RollParams& rp, void* out, void* stream,
           const void* table = nullptr) {
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
  const size_t fixed = (2 * kBlockWin + kMaxN - 1 + kSigma) * 4;
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
  else if (family == 1)
    go(rolling_kernel<1>, xp);
  else
    go(rolling_kernel<2>, static_cast<const int32_t*>(x));
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

// c_out = x^n mod p; p_low is the modulus without its top bit.
extern "C" int general_rolling(const void* x, int B, int S, int n, int L,
                               unsigned int p_low, unsigned int c_out,
                               void* out, void* stream) {
  if (L < 1 || L > 32) return static_cast<int>(cudaErrorInvalidValue);
  RollParams rp = params(n, L);
  rp.p_low = p_low;
  rp.c_out = c_out;
  return launch(1, x, B, S, n, L, rp, out, stream);
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
