// The decode-time n-gram plane, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// repro/kernels/decode.py::decode_masks_fused (_decode_kernel with
// _probe_hits_tile and _pack_tile). At every decode step it prices every
// candidate continuation v of every session row b with the paper's
// recursion, one rotate and one XOR from the row's prefix hash:
//
//   h = (rotl_L(prefix[b], 1) ^ h1[v]) & hash_mask      (Theorem-2 discard)
//
// then probes the row's packed no-repeat Bloom filter at the k positions
// (h + i * ((h * 0x9E3779B9) | 1)) & (m - 1), all arithmetic mod 2^32, and
// writes
//
//   out[b, v]     = -1e30f if banned, else logits[b, v]
//   banned[b, w]  bit i = banned(b, 32w + i); bits past V are zero
//   canary[b, w]  the same for canary_k probes of the one shared decontam
//                 canary filter (optional)
//
// where banned = all k probes set && ready[b] && v < V (a canary hit alike).
// h1 is masked to L bits by the caller; hash_mask is the full L bits in the
// degraded regime n > L.
//
// Design: one warp per 32 consecutive candidates, so each packed word is
// one __ballot_sync and the logits move with coalesced 128-byte loads and
// stores. A block of 8 warps walks a contiguous span of one row's words;
// the launcher sizes the spans so that about 8 blocks an SM are in flight.
// A session's filter row that fits (up to 32 KiB, log2_m <= 18; the
// serving default is 2 KiB) is staged in shared memory once per block, so
// its random probes hit shared memory; a larger row (up to 2 MiB at
// log2_m = 24) is probed in place through the read-only cache and L2. The
// shared canary filter (up to 128 MiB) is always probed through __ldg. A
// probe loop stops at the first unset bit. A row that is not ready probes
// nothing: it copies its logits and writes zero words.
//
// What bounds it: bytes. Each candidate reads and writes 4 bytes of
// logits and reads 4 bytes of h1; the filters and masks add about 1/16 of
// that. At (16, 152064) that is about 20 MB, about 6 us at 3.35 TB/s,
// against some 25 integer instructions a candidate for k = 2 and a mostly
// missing canary probe. This first version does no more about the bound
// than coalesced access and shared-memory probes; h1 is read once per row
// (from L2 after the first).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStageMaxWords = 8192;          // 32 KiB of shared memory
constexpr int kBlocksWanted = 8 * 132;        // about 8 blocks an SM
constexpr uint32_t kStride = 0x9E3779B9u;     // ref.BLOOM_STRIDE
constexpr float kNegLogit = -1e30f;           // float32(-1e30), ref.NEG_LOGIT

struct DecodeParams {
  int V;                 // candidates per row
  int W;                 // packed words per row, ceil(V / 32)
  int L;
  uint32_t lmask;        // the L low bits
  uint32_t hash_mask;    // the Theorem-2 discard
  int n_words;           // words of one session filter, 2^(log2_m - 5)
  uint32_t m_mask;       // 2^log2_m - 1
  int k;
  uint32_t c_mask;       // 2^canary_log2_m - 1
  int canary_k;
  int span;              // packed words one block walks
};

// all k probes of h set in the filter f (shared or global memory)
template <bool kLdg>
__device__ __forceinline__ bool probes_set(const uint32_t* f, uint32_t h,
                                           uint32_t mmask, int k) {
  const uint32_t stride = (h * kStride) | 1u;
  for (int i = 0; i < k; ++i) {
    const uint32_t p = (h + static_cast<uint32_t>(i) * stride) & mmask;
    const uint32_t word = kLdg ? __ldg(f + (p >> 5)) : f[p >> 5];
    if (!((word >> (p & 31u)) & 1u)) return false;
  }
  return true;
}

template <bool kStage, bool kCanary>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ logits,
              const uint32_t* __restrict__ prefix,
              const int* __restrict__ ready,
              const uint32_t* __restrict__ bloom,
              const uint32_t* __restrict__ h1,
              const uint32_t* __restrict__ canary,
              float* __restrict__ out, uint32_t* __restrict__ banned_out,
              uint32_t* __restrict__ canary_out, DecodeParams p) {
  extern __shared__ uint32_t sfilt[];
  const int row = blockIdx.y;
  const int w0 = blockIdx.x * p.span;
  const int w1 = min(w0 + p.span, p.W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool rdy = ready[row] != 0;          // uniform over the block
  const uint32_t* filt = bloom + static_cast<size_t>(row) * p.n_words;
  if (kStage && rdy) {
    for (int i = threadIdx.x; i < p.n_words; i += kThreads) sfilt[i] = filt[i];
    __syncthreads();
  }
  const uint32_t pf = prefix[row] & p.lmask;
  const uint32_t rot =
      p.L == 1 ? pf : (((pf << 1) | (pf >> (p.L - 1))) & p.lmask);
  const size_t rbase = static_cast<size_t>(row) * p.V;
  const size_t wbase = static_cast<size_t>(row) * p.W;
  for (int w = w0 + warp; w < w1; w += kWarps) {   // uniform over the warp
    const int v = w * 32 + lane;
    const bool col = v < p.V;
    bool ban = false, hit = false;
    if (col) {
      const float x = logits[rbase + v];
      if (rdy) {
        const uint32_t h = (rot ^ h1[v]) & p.hash_mask;
        ban = kStage ? probes_set<false>(sfilt, h, p.m_mask, p.k)
                     : probes_set<true>(filt, h, p.m_mask, p.k);
        if (kCanary) hit = probes_set<true>(canary, h, p.c_mask, p.canary_k);
      }
      out[rbase + v] = ban ? kNegLogit : x;
    }
    const uint32_t bw = __ballot_sync(0xffffffffu, ban);
    if (kCanary) {
      const uint32_t cw = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) canary_out[wbase + w] = cw;
    }
    if (lane == 0) banned_out[wbase + w] = bw;
  }
}

template <bool kStage, bool kCanary>
void launch(dim3 grid, size_t smem, cudaStream_t st, const float* lg,
            const uint32_t* pf, const int* rd, const uint32_t* bl,
            const uint32_t* h1, const uint32_t* cb, float* out, uint32_t* bo,
            uint32_t* co, const DecodeParams& p) {
  decode_kernel<kStage, kCanary><<<grid, kThreads, smem, st>>>(
      lg, pf, rd, bl, h1, cb, out, bo, co, p);
}

}  // namespace

// Plain C interface, bound with ctypes. Device pointers: logits (B, V)
// float32, prefix (B,) uint32, ready (B,) int32 (nonzero = ready), bloom
// (B, 2^log2_m / 32) uint32, h1 (V,) uint32 masked to L bits, canary
// (2^canary_log2_m / 32,) uint32 or null when canary_log2_m == 0; outputs
// out (B, V) float32, banned (B, ceil(V/32)) uint32 and canary_out (same
// shape, or null without a canary filter). Runs on `stream` and does not
// synchronise. Returns cudaGetLastError() after the launch (0 = success),
// or cudaErrorInvalidValue for arguments out of range.
extern "C" int decode_masks(const void* logits, const void* prefix,
                            const void* ready, const void* bloom,
                            const void* h1, const void* canary, int B, int V,
                            int L, unsigned int hash_mask, int log2_m, int k,
                            int canary_log2_m, int canary_k, void* out,
                            void* banned, void* canary_out, void* stream) {
  const bool has_canary = canary_log2_m != 0;
  if (B < 0 || B > 65535 || V < 0 || L < 1 || L > 32 || log2_m < 5 ||
      log2_m > 24 || k < 1 || k > 8 ||
      (has_canary && (canary_log2_m < 5 || canary_log2_m > 30 ||
                      canary_k < 1 || canary_k > 8 || canary == nullptr ||
                      canary_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeParams p{};
  p.V = V;
  p.W = (V + 31) / 32;
  p.L = L;
  p.lmask = L == 32 ? 0xFFFFFFFFu : ((1u << L) - 1u);
  p.hash_mask = hash_mask & p.lmask;
  p.n_words = 1 << (log2_m - 5);
  p.m_mask = static_cast<uint32_t>((1ull << log2_m) - 1);
  p.k = k;
  p.c_mask = has_canary ? static_cast<uint32_t>((1ull << canary_log2_m) - 1)
                        : 0u;
  p.canary_k = canary_k;
  if (B == 0 || p.W == 0) return static_cast<int>(cudaGetLastError());
  const int per_row = max(1, (kBlocksWanted + B - 1) / B);
  p.span = max(kWarps, (p.W + per_row - 1) / per_row);
  const dim3 grid((p.W + p.span - 1) / p.span, B);
  const bool stage = p.n_words <= kStageMaxWords;
  const size_t smem = stage ? sizeof(uint32_t) * p.n_words : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  const uint32_t* pf = static_cast<const uint32_t*>(prefix);
  const int* rd = static_cast<const int*>(ready);
  const uint32_t* bl = static_cast<const uint32_t*>(bloom);
  const uint32_t* hv = static_cast<const uint32_t*>(h1);
  const uint32_t* cb = static_cast<const uint32_t*>(canary);
  float* o = static_cast<float*>(out);
  uint32_t* bo = static_cast<uint32_t*>(banned);
  uint32_t* co = static_cast<uint32_t*>(canary_out);
  if (stage && has_canary)
    launch<true, true>(grid, smem, st, lg, pf, rd, bl, hv, cb, o, bo, co, p);
  else if (stage)
    launch<true, false>(grid, smem, st, lg, pf, rd, bl, hv, cb, o, bo, co, p);
  else if (has_canary)
    launch<false, true>(grid, smem, st, lg, pf, rd, bl, hv, cb, o, bo, co, p);
  else
    launch<false, false>(grid, smem, st, lg, pf, rd, bl, hv, cb, o, bo, co, p);
  return static_cast<int>(cudaGetLastError());
}
