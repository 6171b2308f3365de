"""Plain PyTorch versions of every CUDA kernel (independent of
repro_torch.core's families and sketches).

These are deliberately naive re-implementations of the defining formulas,
on ``int64`` lanes holding uint32 values (:mod:`repro_torch.core.u32`). The
CUDA kernels are held bit-exact against them on the card:
``csrc/sketch_plan.cu`` against :func:`sketch_plan_ref`, ``csrc/rolling.cu``
against :func:`cyclic_ref`, :func:`general_ref` and :func:`cyclic_fused_ref`,
``csrc/decode.cu`` against :func:`decode_masks_ref`, ``csrc/bloom.cu``
against :func:`bloom_probe_ref` and ``csrc/hll.cu`` against
:func:`hll_update_ref`; the CPU tests hold the module against the JAX
package's ``repro/kernels/ref.py`` and Pallas kernels. Window-hash helpers
return int64 lanes; :func:`sketch_plan_ref`, :func:`decode_masks_ref`,
:func:`bloom_probe_ref` and :func:`hll_update_ref` return the kernel's
dtypes.
"""
from __future__ import annotations

import torch

from repro_torch.core import u32
from repro_torch.kernels.plan import (BloomSpec, CountMinSpec, HLLSpec,
                                      MinHashSpec)

_SENTINEL = u32.MASK32


def cyclic_ref(h1v, n: int, L: int = 32) -> torch.Tensor:
    """CYCLIC window hashes: H_j = XOR_k rotl(h1v[j+k], n-1-k).
    (..., S) -> (..., S-n+1) int64 lanes."""
    x = u32.lanes(h1v)
    W = x.shape[-1] - n + 1
    acc = torch.zeros(x.shape[:-1] + (W,), dtype=torch.int64, device=x.device)
    for k in range(n):
        acc = acc ^ u32.rotl_const(x[..., k : k + W], (n - 1 - k) % L, L)
    return acc


def _xpows_host(n: int, p: int, L: int) -> tuple:
    """x^k mod p for k = 0..n on host ints (p WITH its top bit)."""
    xs = [1]
    for _ in range(n):
        c = xs[-1] << 1
        if c >> L:
            c ^= p
        xs.append(c & ((1 << L) - 1))
    return tuple(xs)


def general_ref(h1v, n: int, p: int, L: int = 32) -> torch.Tensor:
    """GENERAL window hashes mod irreducible p (given WITH top bit).
    (..., S) -> (..., S-n+1) int64 lanes."""
    x = u32.lanes(h1v)
    W = x.shape[-1] - n + 1
    xpow = _xpows_host(n, p, L)
    acc = torch.zeros(x.shape[:-1] + (W,), dtype=torch.int64, device=x.device)
    for k in range(n):
        acc = acc ^ u32.mul_const(x[..., k : k + W], xpow[n - 1 - k], p, L)
    return acc


def lookup_ref(tokens, table) -> torch.Tensor:
    """The byte path's h1 lookup, (...,) token values -> int64 lanes, with
    the JAX oracle's index rule: a negative token counts from the end of
    the table once, then the index is clamped into it (for 256 entries:
    -1 -> 255, 300 -> 255, -300 -> 0). Tokens are values: an int32 -1 is
    -1, not the bit pattern 0xFFFFFFFF."""
    tab = u32.lanes(table)
    t = torch.as_tensor(tokens, device=tab.device).to(torch.int64)
    sigma = tab.shape[0]
    return tab[torch.where(t < 0, t + sigma, t).clamp(0, sigma - 1)]


def cyclic_fused_ref(tokens, table, n: int, L: int = 32) -> torch.Tensor:
    """The fused byte path: h1 table lookup, then CYCLIC window hashes.
    (..., S) tokens -> (..., S-n+1) int64 lanes."""
    return cyclic_ref(lookup_ref(tokens, table), n, L)


def window_hashes_ref(h1v, *, family: str, n: int, L: int,
                      p: int = 0) -> torch.Tensor:
    """Family-generic rolling window hashes: (..., S) -> (..., S-n+1)."""
    if family == "cyclic":
        return cyclic_ref(h1v, n, L)
    if family == "general":
        return general_ref(h1v, n, p, L)
    raise ValueError(f"unknown hash family {family!r}")


def _masked_windows(h1v, n: int, L: int, hash_mask: int, n_windows,
                    family: str = "cyclic", p: int = 0, w_start=None):
    """(B, S) -> (B, W) window hashes with the discard mask applied and a
    (B, W) bool validity mask (``w_start <= window index < n_windows``;
    ``w_start=None`` means 0)."""
    h = window_hashes_ref(h1v, family=family, n=n, L=L, p=p) & hash_mask
    idx = torch.arange(h.shape[-1], device=h.device)
    valid = idx[None, :] < n_windows.to(h.device, torch.int64)[:, None]
    if w_start is not None:
        valid &= idx[None, :] >= w_start.to(h.device, torch.int64)[:, None]
    return h, valid


def minhash_reduce(h, valid, a, b, k_chunk: int = 16,
                   init=None) -> torch.Tensor:
    """(B, W) masked hashes -> (B, k) int64-lane signatures. Invalid windows
    are excluded from the min entirely (sentinel substituted after the
    remix). The remix runs in k-chunks so the (B, W, k) expansion never
    materialises. ``init`` is an optional (B, k) carry of running minima,
    folded in with ``min`` (the MinHash merge operator)."""
    a, b = u32.lanes(a), u32.lanes(b)
    B, W = h.shape
    if W == 0:
        out = torch.full((B, a.shape[0]), _SENTINEL, dtype=torch.int64,
                         device=h.device)
    else:
        outs = []
        for s in range(0, a.shape[0], k_chunk):
            ac, bc = a[s : s + k_chunk], b[s : s + k_chunk]
            mixed = (u32.mulmod32(ac[None, None, :], h[:, :, None])
                     + bc[None, None, :]) & u32.MASK32
            mixed = torch.where(valid[:, :, None], mixed, _SENTINEL)
            outs.append(mixed.min(dim=1).values)
        out = torch.cat(outs, dim=-1)
    return out if init is None else torch.minimum(out, u32.lanes(init))


def hll_reduce(h, valid, b: int, rank_bits: int, init=None) -> torch.Tensor:
    """(B, W) masked hashes -> (2^b,) int32 registers over the valid
    windows: index ``h & (2^b - 1)``, rank ``min(ctz(h >> b), rank_bits) +
    1`` (ctz(0) = 32), an invalid window ranks 0. ``init`` optionally
    carries a register file in (merged by max)."""
    h, valid = h.reshape(-1), valid.reshape(-1)
    m = 1 << b
    rank = u32.ctz(h >> b).clamp(max=rank_bits) + 1
    rank = torch.where(valid, rank, 0)
    out = (torch.zeros((m,), dtype=torch.int64, device=h.device)
           if init is None else init.to(torch.int64).clone())
    out.scatter_reduce_(0, h & (m - 1), rank, "amax")
    return out.to(torch.int32)


def hll_update_ref(hashes, *, b: int = 10, rank_bits: int = 32) -> torch.Tensor:
    """HLL registers of a hash stream: (...) uint32 -> (2^b,) int32, index
    ``h & (2^b - 1)``, rank ``min(ctz(h >> b), rank_bits) + 1`` (ctz(0) =
    32), merged by max from zero."""
    h = u32.lanes(hashes).reshape(-1)
    return hll_reduce(h, torch.ones_like(h, dtype=torch.bool), b, rank_bits)


def cms_reduce(h, valid, a, b, log2_width: int, init=None) -> torch.Tensor:
    """(B, W) masked hashes -> (depth, 2^log2_width) int32 counts: row d's
    column is the top ``log2_width`` bits of ``a[d] * h + b[d] mod 2^32``,
    and each valid window adds one. ``init`` optionally carries a running
    table in (counts merge by ``+``). The same table at every width: the
    JAX package's in-kernel/scatter split (``CountMinSpec.use_in_kernel``)
    is a TPU tiling choice that changes no count."""
    hf = h.reshape(-1)
    vf = valid.reshape(-1).to(torch.int32)
    a, b = u32.lanes(a), u32.lanes(b)
    depth, width = a.shape[0], 1 << log2_width
    mixed = (u32.mulmod32(a[:, None], hf[None, :]) + b[:, None]) & u32.MASK32
    cols = mixed >> (32 - log2_width)
    rows = torch.arange(depth, device=h.device)[:, None]
    table = (torch.zeros((depth, width), dtype=torch.int32, device=h.device)
             if init is None else init.to(torch.int32).clone())
    table.view(-1).index_add_(0, (rows * width + cols).reshape(-1),
                              vf.repeat(depth))
    return table


def bloom_reduce(ha, hb, valid, bits, k: int, log2_m: int,
                 init=None) -> torch.Tensor:
    """Two (B, W) masked hash draws + packed filter -> (B,) int32 counts of
    the valid windows whose k probes ``(ha + i * (hb | 1)) mod 2^32 & (m -
    1)`` all hit. ``init`` optionally carries running counts in (merged by
    ``+``)."""
    hit = bloom_probe_ref(ha, hb, bits, k=k, log2_m=log2_m)
    out = (hit & valid).sum(dim=-1).to(torch.int32)
    return out if init is None else out + init.to(torch.int32)


def bloom_probe_ref(h_a, h_b, bits, *, k: int = 4,
                    log2_m: int = 22) -> torch.Tensor:
    """Bloom membership of hash pairs: (...) h_a, h_b + packed filter
    (2^log2_m / 32,) -> (...) bool, true iff all k probes ``(h_a + i *
    (h_b | 1)) mod 2^32 & (2^log2_m - 1)`` are set (word p >> 5, bit p &
    31)."""
    ha, hb = u32.lanes(h_a), u32.lanes(h_b) | 1       # odd probe stride
    i = torch.arange(k, dtype=torch.int64, device=ha.device)
    # the sum wraps in 32 bits before the mask, which matters at log2_m = 32
    probes = ((ha[..., None] + i * hb[..., None]) & u32.MASK32) & (
        (1 << log2_m) - 1)
    words = u32.lanes(bits)
    return (((words[probes >> 5] >> (probes & 31)) & 1) == 1).all(dim=-1)


def sketch_plan_ref(plan, h1v, h1v_b, n_windows, operands,
                    w_start=None) -> dict:
    """Plain executor for a SketchPlan: ONE rolling-hash evaluation (per
    stream) feeds every requested sketch epilogue. Mirrors the CUDA kernel
    (``sketch_fused.sketch_plan_fused``) bit for bit. A sketch's optional
    ``init`` operand carries its running state in, folded with the sketch's
    merge operator (min / max / + / +), so a chunked run that threads the
    carry equals one shot. ``h1v_b`` is the second family draw that Bloom
    sketches take their probe stride from (None for plans without one).

    Returns MinHash (B, k) uint32, HLL (2^b,) int32, CountMin (depth,
    2^log2_width) int32 and Bloom (B,) int32."""
    hs = plan.hash
    h, valid = _masked_windows(h1v, hs.n, hs.L, hs.hash_mask, n_windows,
                               family=hs.family, p=hs.p, w_start=w_start)
    hb = None
    if plan.needs_second_stream:
        hb = window_hashes_ref(h1v_b, family=hs.family, n=hs.n, L=hs.L,
                               p=hs.p) & hs.hash_mask
    out = {}
    for name, spec in plan.sketches:
        ops_nm = operands.get(name, {})
        init = ops_nm.get("init")
        if isinstance(spec, MinHashSpec):
            out[name] = minhash_reduce(h, valid, ops_nm["a"], ops_nm["b"],
                                       init=init).to(torch.uint32)
        elif isinstance(spec, HLLSpec):
            out[name] = hll_reduce(h, valid, spec.b,
                                   spec.resolve_rank_bits(hs), init=init)
        elif isinstance(spec, CountMinSpec):
            out[name] = cms_reduce(h, valid, ops_nm["a"], ops_nm["b"],
                                   spec.log2_width, init=init)
        elif isinstance(spec, BloomSpec):
            out[name] = bloom_reduce(h, hb, valid, ops_nm["bits"], spec.k,
                                     spec.log2_m, init=init)
        else:  # pragma: no cover - SketchPlan validates spec types
            raise TypeError(f"unknown sketch spec {type(spec)}")
    return out


# ---------------------------------------------------------------------------
# The decode-time n-gram plane (the plain version of csrc/decode.cu)
# ---------------------------------------------------------------------------

# double-hashing stride constant (golden-ratio odd multiplier), shared by the
# plain version, the kernel and the session pool's filter inserts, so their
# probe sequences are bit-identical
BLOOM_STRIDE = 0x9E3779B9

NEG_LOGIT = -1e30          # written as float32, exactly float32(-1e30)


def pack_mask_u32(mask: torch.Tensor) -> torch.Tensor:
    """(..., V) bool -> (..., ceil(V/32)) uint32, bit i of word w = column
    32*w + i. V is padded with zero bits up to the word boundary."""
    V = mask.shape[-1]
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, -V % 32))
    m = m.reshape(mask.shape[:-1] + (-1, 32))
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << \
        torch.arange(32, device=mask.device)
    return (m * weights).sum(dim=-1).to(torch.uint32)


def bloom_probe_hits(h, words, k: int, log2_m: int) -> torch.Tensor:
    """All-k-probes-set membership of masked hashes ``h`` (..., V) against
    packed filters ``words``: per-row filters (B, m/32) probed row-wise, or
    one shared (m/32,) filter probed globally. Probe i is ``(h + i * ((h *
    BLOOM_STRIDE) | 1)) & (m - 1)``, a multiply and sum mod 2^32: double
    hashing with an odd stride derived from the already-discarded hash."""
    h = u32.lanes(h)
    stride = u32.mulmod32(h, BLOOM_STRIDE) | 1
    i = torch.arange(k, dtype=torch.int64, device=h.device)
    probes = ((h[..., None] + i * stride[..., None]) & u32.MASK32) & (
        (1 << log2_m) - 1)
    word, bit = probes >> 5, probes & 31
    w = u32.lanes(words)
    if w.dim() == 1:                          # shared filter
        got = w[word]
    else:                                     # per-row filters
        got = torch.gather(w, 1, word.reshape(word.shape[0], -1))
        got = got.reshape(word.shape)
    return (((got >> bit) & 1) == 1).all(dim=-1)


def decode_masks_ref(logits, prefix, ready, bloom, h1, *, n: int, L: int,
                     hash_mask: int, log2_m: int, k: int,
                     canary_bits=None, canary_log2_m: int = 0,
                     canary_k: int = 4) -> dict:
    """The decode plane: one candidate hash per (session, token), probed
    against the session's no-repeat filter and (optionally) the shared
    decontam canary filter.

    logits (B, V) float32, prefix (B,) rolling prefix hashes, ready (B,)
    bool or int (the session has consumed >= n-1 symbols), bloom (B,
    2^log2_m/32) per-session filters, h1 (V,) symbol hashes masked to L bits
    -> ``{"logits": (B, V) float32 with -1e30 where banned, "banned": (B,
    ceil(V/32)) uint32 packed mask[, "canary": packed canary-hit mask]}``.
    ``h_cand = rotl(prefix, 1) XOR h1[v]`` is the full-width recursive
    hash; probes derive from ``h_cand & hash_mask`` (the Theorem-2 discard).
    ``n`` is not read: the spec's hash_mask already reflects it.
    """
    cand = (u32.rotl_const(u32.lanes(prefix), 1, L)[:, None]
            ^ u32.lanes(h1)[None, :])
    h = cand & hash_mask
    rdy = ready.to(torch.bool)[:, None]        # a full n-gram needs n-1 history
    banned = bloom_probe_hits(h, bloom, k, log2_m) & rdy
    out = {"logits": logits.to(torch.float32).masked_fill(banned, NEG_LOGIT),
           "banned": pack_mask_u32(banned)}
    if canary_bits is not None:
        out["canary"] = pack_mask_u32(
            bloom_probe_hits(h, canary_bits, canary_k, canary_log2_m) & rdy)
    return out
