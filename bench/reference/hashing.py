"""Plain PyTorch n-gram hashing for the benchmark's reference: the paper's
CYCLIC family, the Theorem-1 discard and the uint32 arithmetic of the
sketches, written from their definitions.

Every 32-bit value lives in an int64 lane in [0, 2^32), so the arithmetic
is exact on every device PyTorch has; unsigned order is int64 order. This
module imports nothing of the program: it is the yardstick the program is
held to.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def to_u32(lanes: torch.Tensor) -> torch.Tensor:
    """int64 lanes in [0, 2^32) -> a uint32 tensor of the same values."""
    signed = torch.where(lanes >= 1 << 31, lanes - (1 << 32), lanes)
    return signed.to(torch.int32).view(torch.uint32)


def random_u32(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform 32-bit values as int64 lanes, in one call on ``device``."""
    return torch.randint(0, 1 << 32, shape, generator=gen, device=device,
                         dtype=torch.int64)


def rotl(v: torch.Tensor, r: int, L: int) -> torch.Tensor:
    """Rotate the L low bits of lanes ``v`` left by the constant ``r``."""
    m = (1 << L) - 1
    v = v & m
    r %= L
    return v if r == 0 else ((v << r) | (v >> (L - r))) & m


def cyclic_windows(h1v: torch.Tensor, n: int, L: int) -> torch.Tensor:
    """CYCLIC window hashes of symbol hashes (..., S) -> (..., S-n+1): window
    j is XOR over k < n of rotl(h1v[j+k], n-1-k) (the paper's Algorithm 4
    unrolled)."""
    W = h1v.shape[-1] - n + 1
    acc = torch.zeros(h1v.shape[:-1] + (max(W, 0),), dtype=torch.int64,
                      device=h1v.device)
    for k in range(n):
        acc ^= rotl(h1v[..., k : k + W], n - 1 - k, L)
    return acc


def discard_mask(n: int, L: int, discard: bool = True) -> int:
    """The bits a CYCLIC window hash keeps: its L-n+1 low bits (Theorem 1),
    or all L bits without the discard."""
    return (1 << (L - n + 1 if discard else L)) - 1


def mulmod32(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """a * h mod 2^32 for lanes below 2^32, exactly in int64: ``a`` is split
    into 16-bit halves so that no partial product reaches 2^63."""
    lo = (a & 0xFFFF) * h
    hi = (((a >> 16) * h) & 0xFFFF) << 16
    return (lo + hi) & M32


def ctz(v: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of lanes in [0, 2^32); ctz(0) = 32. The lowest set bit
    is isolated and counted by comparing it with each power of two."""
    low = v & -v
    out = torch.full_like(v, 32)
    for k in range(32):
        out = torch.where(low == (1 << k), k, out)
    return out
