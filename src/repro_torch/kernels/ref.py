"""Plain PyTorch versions of the plan kernel (independent of repro_torch.core).

These are deliberately naive re-implementations of the defining formulas,
on ``int64`` lanes holding uint32 values (:mod:`repro_torch.core.u32`). The
CUDA kernel in ``csrc/sketch_plan.cu`` is held bit-exact against
:func:`sketch_plan_ref` on the card, and the whole module against the JAX
package's ``repro/kernels/ref.py`` by the CPU tests. Window-hash helpers
return int64 lanes; :func:`sketch_plan_ref` returns uint32 tensors, as the
kernel does.
"""
from __future__ import annotations

import torch

from repro_torch.core import u32
from repro_torch.kernels.plan import MinHashSpec

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


def require_minhash(plan) -> None:
    """Only the MinHash epilogue is ported; HLL, CountMin and Bloom raise
    until theirs are (ROADMAP.md, Queue 2 item 1)."""
    for name, spec in plan.sketches:
        if not isinstance(spec, MinHashSpec):
            raise NotImplementedError(
                f"sketch {name!r}: the {type(spec).__name__} epilogue is not "
                f"ported to repro_torch yet (ROADMAP.md, Queue 2 item 1)")


def sketch_plan_ref(plan, h1v, h1v_b, n_windows, operands,
                    w_start=None) -> dict:
    """Plain executor for a SketchPlan: ONE rolling-hash evaluation feeds
    every requested sketch epilogue. Mirrors the CUDA kernel
    (``sketch_fused.sketch_plan_fused``) bit for bit. A sketch's optional
    ``init`` operand carries its running state in, folded with the sketch's
    merge operator, so a chunked run that threads the carry equals one shot.
    MinHash sketches only (:func:`require_minhash`), so ``h1v_b`` must be
    None."""
    require_minhash(plan)
    if h1v_b is not None:
        raise ValueError("h1v_b given but no sketch in the plan consumes a "
                         "second hash stream")
    hs = plan.hash
    h, valid = _masked_windows(h1v, hs.n, hs.L, hs.hash_mask, n_windows,
                               family=hs.family, p=hs.p, w_start=w_start)
    out = {}
    for name, _ in plan.sketches:
        ops_nm = operands.get(name, {})
        out[name] = minhash_reduce(h, valid, ops_nm["a"], ops_nm["b"],
                                   init=ops_nm.get("init")).to(torch.uint32)
    return out
