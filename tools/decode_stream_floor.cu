// The stream floor of the decode plane: the decode kernel's traffic with no
// filter probe at all, built for Hopper (sm_90a). Measurement only:
// chip_smoke.py builds it beside the port's kernels and times it against
// csrc/decode.cu on the same inputs, so that the kernel's time splits into
// streaming, session probes and canary probes.
//
// It runs one of two grids: grid 0 is the one csrc/decode.cu ran before its
// redesign (one warp a packed word of 32 candidates, 8 warps a block
// walking a span of one row's words, about 8 blocks an SM); grid 1 is the
// redesign's (the same blocks over a linear index of (row, span) tiles,
// spans of whole steps, 4 words a warp a step with every load before any
// store, logits loaded and stored evict-first). Either reads every logit
// and h1 entry and the ready flag, and writes every logit and the packed
// words: a word's bits are the candidates whose masked hash is odd, so the
// loads stay live. Its outputs mean nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksWanted = 8 * 132;

__global__ void __launch_bounds__(kThreads)
stream_floor_kernel(const float* __restrict__ logits,
                    const uint32_t* __restrict__ prefix,
                    const int* __restrict__ ready,
                    const uint32_t* __restrict__ h1, int V, int W, int span,
                    uint32_t hash_mask, float* __restrict__ out,
                    uint32_t* __restrict__ banned_out,
                    uint32_t* __restrict__ canary_out) {
  const int row = blockIdx.y;
  const int w0 = blockIdx.x * span;
  const int w1 = min(w0 + span, W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool rdy = ready[row] != 0;
  const uint32_t rot = prefix[row];
  const size_t rbase = static_cast<size_t>(row) * V;
  const size_t wbase = static_cast<size_t>(row) * W;
  for (int w = w0 + warp; w < w1; w += kWarps) {
    const int v = w * 32 + lane;
    bool odd = false;
    if (v < V) {
      const float x = logits[rbase + v];
      if (rdy) odd = ((rot ^ h1[v]) & hash_mask & 1u) != 0;
      out[rbase + v] = x;
    }
    const uint32_t bw = __ballot_sync(0xffffffffu, odd);
    if (lane == 0) {
      banned_out[wbase + w] = bw;
      if (canary_out) canary_out[wbase + w] = ~bw;
    }
  }
}

constexpr int kTileWords = 4;                 // words a warp a step
constexpr int kTileStep = kWarps * kTileWords;

__global__ void __launch_bounds__(kThreads)
tile_floor_kernel(const float* __restrict__ logits,
                  const uint32_t* __restrict__ prefix,
                  const int* __restrict__ ready,
                  const uint32_t* __restrict__ h1, int V, int W, int span,
                  int spans, uint32_t hash_mask, float* __restrict__ out,
                  uint32_t* __restrict__ banned_out,
                  uint32_t* __restrict__ canary_out) {
  const long long tile = blockIdx.x;
  const long long row = tile / spans;
  const int w0 = static_cast<int>(tile - row * spans) * span;
  const int w1 = min(w0 + span, W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool rdy = ready[row] != 0;
  const uint32_t rot = prefix[row];
  const size_t rbase = static_cast<size_t>(row) * V;
  for (int w = w0 + warp * kTileWords; w < w1; w += kTileStep) {
    float x[kTileWords];
    uint32_t h[kTileWords];
    bool col[kTileWords];
#pragma unroll
    for (int u = 0; u < kTileWords; ++u) {
      const int v = (w + u) * 32 + lane;
      col[u] = w + u < w1 && v < V;
      x[u] = col[u] ? __ldcs(logits + rbase + v) : 0.f;
      h[u] = col[u] && rdy ? __ldg(h1 + v) : 0u;
    }
    uint32_t bw = 0;
#pragma unroll
    for (int u = 0; u < kTileWords; ++u) {
      const int v = (w + u) * 32 + lane;
      if (col[u]) __stcs(out + rbase + v, x[u]);
      const uint32_t b = __ballot_sync(
          0xffffffffu, ((rot ^ h[u]) & hash_mask & 1u) != 0);
      if (lane == u) bw = b;
    }
    if (lane < kTileWords && w + lane < w1) {
      const size_t i = static_cast<size_t>(row) * W + w + lane;
      banned_out[i] = bw;
      if (canary_out) canary_out[i] = ~bw;
    }
  }
}

}  // namespace

// Plain C interface, bound with ctypes: the arguments of csrc/decode.cu's
// decode_masks that the stream touches (ready as int32 flags, canary_out
// null for a launch without a canary filter) and the grid (0 or 1, above).
// B up to 65,535. Returns cudaGetLastError().
extern "C" int decode_stream_floor(const void* logits, const void* prefix,
                                   const void* ready, const void* h1, int B,
                                   int V, unsigned int hash_mask, void* out,
                                   void* banned, void* canary_out, int grid,
                                   void* stream) {
  if (B < 0 || V < 0 || B > 65535 || grid < 0 || grid > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = (V + 31) / 32;
  if (B == 0 || W == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* lg = static_cast<const float*>(logits);
  const auto* pf = static_cast<const uint32_t*>(prefix);
  const auto* rd = static_cast<const int*>(ready);
  const auto* hv = static_cast<const uint32_t*>(h1);
  auto* o = static_cast<float*>(out);
  auto* bo = static_cast<uint32_t*>(banned);
  auto* co = static_cast<uint32_t*>(canary_out);
  if (grid == 0) {
    const int per_row = max(1, (kBlocksWanted + B - 1) / B);
    const int span = max(kWarps, (W + per_row - 1) / per_row);
    stream_floor_kernel<<<dim3((W + span - 1) / span, B), kThreads, 0, st>>>(
        lg, pf, rd, hv, V, W, span, hash_mask, o, bo, co);
  } else {
    const int per_row = max(1, (kBlocksWanted + B - 1) / B);
    int span = (W + per_row - 1) / per_row;
    span = (span + kTileStep - 1) / kTileStep * kTileStep;
    const int spans = (W + span - 1) / span;
    tile_floor_kernel<<<static_cast<unsigned int>(
                            static_cast<long long>(B) * spans),
                        kThreads, 0, st>>>(lg, pf, rd, hv, V, W, span, spans,
                                           hash_mask, o, bo, co);
  }
  return static_cast<int>(cudaGetLastError());
}
