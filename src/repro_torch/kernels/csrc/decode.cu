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
// What bounds it: bytes. Each candidate reads and writes 4 bytes of
// logits and reads 4 bytes of h1; the filters and masks add about 1/16 of
// that: at (16, 152064) about 20.8 MB, 0.0062 ms at 3.35 TB/s, against
// some 25 integer instructions a candidate for k = 2 and a mostly missing
// canary probe.
//
// What held the first version back, split on an H100 at the serve path's
// (16, 152064) with its real pool state (a 2^14-bit session filter, k = 2;
// the 2^20-bit canary filter, k = 4): 0.0193 ms a call, of which 0.0026 ms
// were two elementwise kernels turning `ready` into int32, 0.0062 ms the
// canary probes (each ready candidate's first probe a random load through
// the read-only cache into a 128 KiB filter), 0.0035 ms the session probes
// and the rest, and 0.0070 ms the streams alone (a kernel with the same
// grid and no probe). Its grid of 1,056 short blocks (one word a warp an
// iteration, nine iterations a warp) kept few bytes in flight behind each
// dependent chain of loads.
//
// Design:
//   - `ready` is read as the caller's bytes (1, 2, 4 or 8 a flag, nonzero
//     = ready): no conversion kernel before the launch.
//   - The first version's blocks stay (8 warps, about 8 blocks an SM, each
//     a span of one row's words), since many small blocks keep the SM busy
//     while one of them stages its row's filter; the grid is one linear
//     index of (row, span) tiles, so there is no limit on the rows. A span
//     is whole steps of every warp.
//   - A warp takes kWords = 4 consecutive words a step and loads all their
//     logits and h1 entries before its first probe, then issues probe i of
//     all its live candidates together, so a lane's random probes overlap
//     (a probe loop still stops at its first unset bit).
//   - A session's filter row up to 32 KiB (log2_m <= 18; the serving
//     default is 2 KiB) is staged in shared memory once per block; a
//     larger one (to 2^24 bits) is probed in place through __ldg. The
//     shared canary filter (to 2^30 bits) is probed through __ldg.
//   - A row that is not ready probes nothing: it copies its logits and
//     writes zero words. Logits stream through with evict-first loads and
//     stores; h1, which every row reads, stays cached.
//
// What the redesign measured (tools/kernel_ab.py and chip_smoke.py, H100
// 80GB HBM3, 700 W; PERF.md section 6):
//   - a first try staged the 128 KiB canary filter in shared memory in a
//     resident grid of 1,024-thread blocks, one an SM. It lost at (16,
//     152064), 0.0211 ms against the parent's 0.0195. The likely costs,
//     not split: staging 17 MB from L2 a launch, and the whole SM
//     draining at each block-wide barrier when a block's tiles moved to a
//     new row;
//   - this design, swept in one call at (16, 152064) and (256, 152064):
//     four words a warp a step 0.0187 and 0.195 ms, two words 0.0190 and
//     0.226, one word 0.0198 and 0.273, the first version 0.0195 and
//     0.259. So at B = 256 the gain is the loads a warp keeps in flight
//     (a step's logits and h1 entries all issued before its first probe);
//     a plain loop of one word a step measured 0.245-0.249 ms again later.
//     At B = 16 the four-word kernel gains 4 % and the canary probes
//     remain the largest part above the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWords = 4;                     // packed words a warp a step
constexpr int kStageMaxWords = 8192;          // session rows up to 32 KiB
constexpr int kBlocksWanted = 8 * 132;        // about 8 blocks an SM
constexpr long long kMaxGrid = 0x7FFFFFFF;    // blocks a launch's grid.x holds
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
  int ready_bytes;       // bytes of one ready flag: 1, 2, 4 or 8
  int span;              // packed words one block walks
  int spans;             // spans a row, ceil(W / span)
  long long tile0;       // the first (row, span) tile of this launch
};

__device__ __forceinline__ bool is_ready(const void* ready, long long row,
                                         int bytes) {
  switch (bytes) {
    case 1: return static_cast<const uint8_t*>(ready)[row] != 0;
    case 2: return static_cast<const uint16_t*>(ready)[row] != 0;
    case 4: return static_cast<const uint32_t*>(ready)[row] != 0;
    default: return static_cast<const unsigned long long*>(ready)[row] != 0;
  }
}

// live[u] &= all k probes of h[u] set in the filter f (shared or global
// memory). Probe i of every live candidate is loaded before any is tested.
template <bool kLdg>
__device__ __forceinline__ void probe(const uint32_t* f,
                                      const uint32_t (&h)[kWords],
                                      bool (&live)[kWords], uint32_t mmask,
                                      int k) {
  uint32_t stride[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u) stride[u] = (h[u] * kStride) | 1u;
  for (int i = 0; i < k; ++i) {
    uint32_t word[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const uint32_t p = (h[u] + static_cast<uint32_t>(i) * stride[u]) &
                         mmask;
      word[u] = !live[u] ? 0u : kLdg ? __ldg(f + (p >> 5)) : f[p >> 5];
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const uint32_t p = (h[u] + static_cast<uint32_t>(i) * stride[u]) &
                         mmask;
      live[u] = live[u] && ((word[u] >> (p & 31u)) & 1u);
      any |= live[u];
    }
    if (!any) return;
  }
}

template <bool kStage, bool kCanary>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ logits,
              const uint32_t* __restrict__ prefix, const void* ready,
              const uint32_t* __restrict__ bloom,
              const uint32_t* __restrict__ h1,
              const uint32_t* __restrict__ canary,
              float* __restrict__ out, uint32_t* __restrict__ banned_out,
              uint32_t* __restrict__ canary_out, DecodeParams p) {
  extern __shared__ uint32_t sfilt[];
  const long long tile = p.tile0 + blockIdx.x;
  const long long row = tile / p.spans;
  const int w0 = static_cast<int>(tile - row * p.spans) * p.span;
  const int w1 = min(w0 + p.span, p.W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool rdy = is_ready(ready, row, p.ready_bytes);   // block-uniform
  const uint32_t* filt = bloom + row * p.n_words;
  if (kStage && rdy) {
    for (int i = threadIdx.x; i < p.n_words; i += kThreads) sfilt[i] = filt[i];
    __syncthreads();
  }
  const uint32_t pf = prefix[row] & p.lmask;
  const uint32_t rot =
      p.L == 1 ? pf : (((pf << 1) | (pf >> (p.L - 1))) & p.lmask);
  const size_t rbase = static_cast<size_t>(row) * p.V;
  const size_t wbase = static_cast<size_t>(row) * p.W;
  // a warp takes kWords consecutive words a step (warp-uniform bounds)
  for (int w = w0 + warp * kWords; w < w1; w += kWarps * kWords) {
    float x[kWords];
    uint32_t h[kWords];
    bool col[kWords], ban[kWords], hit[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {       // every load before any probe
      const int v = (w + u) * 32 + lane;
      col[u] = w + u < w1 && v < p.V;
      x[u] = col[u] ? __ldcs(logits + rbase + v) : 0.f;
      h[u] = col[u] && rdy ? __ldg(h1 + v) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      h[u] = (rot ^ h[u]) & p.hash_mask;
      ban[u] = hit[u] = col[u] && rdy;
    }
    if (rdy) {
      if (kStage)
        probe<false>(sfilt, h, ban, p.m_mask, p.k);
      else
        probe<true>(filt, h, ban, p.m_mask, p.k);
      if (kCanary) probe<true>(canary, h, hit, p.c_mask, p.canary_k);
    }
    uint32_t bw = 0, cw = 0;
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int v = (w + u) * 32 + lane;
      if (col[u]) __stcs(out + rbase + v, ban[u] ? kNegLogit : x[u]);
      const uint32_t b = __ballot_sync(0xffffffffu, ban[u]);
      const uint32_t c = kCanary ? __ballot_sync(0xffffffffu, hit[u]) : 0u;
      if (lane == u) bw = b, cw = c;
    }
    // lanes 0..kWords-1 write the step's words (contiguous)
    if (lane < kWords && w + lane < w1) {
      banned_out[wbase + w + lane] = bw;
      if (kCanary) canary_out[wbase + w + lane] = cw;
    }
  }
}

template <bool kStage, bool kCanary>
cudaError_t launch(long long tiles, size_t smem, cudaStream_t st,
                   const float* lg, const uint32_t* pf, const void* rd,
                   const uint32_t* bl, const uint32_t* h1, const uint32_t* cb,
                   float* out, uint32_t* bo, uint32_t* co, DecodeParams p) {
  // a launch for each kMaxGrid tiles (grid.x holds no more)
  for (p.tile0 = 0; p.tile0 < tiles; p.tile0 += kMaxGrid) {
    const long long n = tiles - p.tile0 < kMaxGrid ? tiles - p.tile0
                                                   : kMaxGrid;
    decode_kernel<kStage, kCanary>
        <<<static_cast<unsigned int>(n), kThreads, smem, st>>>(
            lg, pf, rd, bl, h1, cb, out, bo, co, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Plain C interface, bound with ctypes. Device pointers: logits (B, V)
// float32, prefix (B,) uint32, ready (B,) flags of ready_bytes bytes each
// (1, 2, 4 or 8; nonzero = ready), bloom (B, 2^log2_m / 32) uint32, h1
// (V,) uint32 masked to L bits, canary (2^canary_log2_m / 32,) uint32 or
// null when canary_log2_m == 0; outputs out (B, V) float32, banned (B,
// ceil(V/32)) uint32 and canary_out (same shape, or null without a canary
// filter). Runs on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int decode_masks(const void* logits, const void* prefix,
                            const void* ready, int ready_bytes,
                            const void* bloom, const void* h1,
                            const void* canary, int B, int V, int L,
                            unsigned int hash_mask, int log2_m, int k,
                            int canary_log2_m, int canary_k, void* out,
                            void* banned, void* canary_out, void* stream) {
  const bool has_canary = canary_log2_m != 0;
  if (B < 0 || V < 0 || L < 1 || L > 32 || log2_m < 5 || log2_m > 24 ||
      k < 1 || k > 8 ||
      (ready_bytes != 1 && ready_bytes != 2 && ready_bytes != 4 &&
       ready_bytes != 8) ||
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
  p.ready_bytes = ready_bytes;
  if (B == 0 || p.W == 0) return static_cast<int>(cudaGetLastError());
  // about kBlocksWanted blocks in all; a span is whole steps of every warp
  const int per_row = max(1, (kBlocksWanted + B - 1) / B);
  const int step = kWarps * kWords;
  p.span = (p.W + per_row - 1) / per_row;
  p.span = (p.span + step - 1) / step * step;
  p.spans = (p.W + p.span - 1) / p.span;
  const long long tiles = static_cast<long long>(B) * p.spans;
  const bool stage = p.n_words <= kStageMaxWords;
  const size_t smem = stage ? sizeof(uint32_t) * p.n_words : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* lg = static_cast<const float*>(logits);
  const auto* pf = static_cast<const uint32_t*>(prefix);
  const auto* bl = static_cast<const uint32_t*>(bloom);
  const auto* hv = static_cast<const uint32_t*>(h1);
  const auto* cb = static_cast<const uint32_t*>(canary);
  auto* o = static_cast<float*>(out);
  auto* bo = static_cast<uint32_t*>(banned);
  auto* co = static_cast<uint32_t*>(canary_out);
  const cudaError_t err =
      stage && has_canary
          ? launch<true, true>(tiles, smem, st, lg, pf, ready, bl, hv, cb, o,
                               bo, co, p)
      : stage ? launch<true, false>(tiles, smem, st, lg, pf, ready, bl, hv,
                                    cb, o, bo, co, p)
      : has_canary ? launch<false, true>(tiles, smem, st, lg, pf, ready, bl,
                                         hv, cb, o, bo, co, p)
                   : launch<false, false>(tiles, smem, st, lg, pf, ready, bl,
                                          hv, cb, o, bo, co, p);
  return static_cast<int>(err);
}
