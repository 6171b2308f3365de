"""uint32 lane arithmetic on ``int64`` tensors.

PyTorch's CPU backend implements no uint32 shift, add, min or compare, so
the port's plain (reference) paths hold every 32-bit value in an ``int64``
lane in ``[0, 2^32)`` and mask after each step that can leave that range.
Unsigned min and max then become plain int64 min and max. The CUDA kernels
work on native ``uint32_t`` storage instead; values cross between the two
with ``.to(torch.int64)`` / ``.to(torch.uint32)``.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def mask(L: int) -> int:
    """All-ones mask over the L low bits."""
    if not 1 <= L <= 32:
        raise ValueError(f"L must be in [1, 32], got {L}")
    return (1 << L) - 1


def lanes(x) -> torch.Tensor:
    """Any integer tensor of uint32 values (uint32, int32 bit patterns or
    int64) -> int64 lanes in ``[0, 2^32)``."""
    x = torch.as_tensor(x)
    if x.dtype == torch.int32:
        x = x.view(torch.uint32)
    return x.to(torch.int64) & MASK32


def keep_low(t: torch.Tensor, L: int) -> torch.Tensor:
    """A uint32 tensor's values masked to their L low bits, as a uint32
    tensor (through the int32 view, which every backend implements)."""
    if L >= 32:
        return t
    return (t.view(torch.int32) & mask(L)).view(torch.uint32)


def rotl_const(v: torch.Tensor, r: int, L: int) -> torch.Tensor:
    """Rotate-left within the L low bits by a host constant ``r``."""
    r %= L
    m = mask(L)
    v = v & m
    if r == 0:                      # a shift by L would leave the lane
        return v
    return ((v << r) | (v >> (L - r))) & m


def rotl(v: torch.Tensor, r: torch.Tensor, L: int) -> torch.Tensor:
    """Rotate-left within the L low bits by per-element amounts ``r`` (an
    integer tensor broadcast against ``v``), taken mod L."""
    m = mask(L)
    v = v & m
    r = r.to(torch.int64) % L
    # (L - r) == L when r == 0: that lane keeps v and takes no right part
    right = torch.where(r == 0, 0, v >> (L - r))
    return ((v << r) & m) | right


def rotr(v: torch.Tensor, r: torch.Tensor, L: int) -> torch.Tensor:
    """Rotate-right within the L low bits by per-element amounts ``r``."""
    return rotl(v, (L - r.to(torch.int64) % L) % L, L)


def mul_const(v: torch.Tensor, c: int, p: int, L: int) -> torch.Tensor:
    """GF(2)[x] product of lanes ``v`` with the host constant ``c`` mod the
    degree-L polynomial ``p`` (given with its top bit): one XOR per set bit
    of ``c``, one shift-reduce step per bit position."""
    m = mask(L)
    p_low = p & m
    v = v & m
    acc = torch.zeros_like(v)
    while c:
        if c & 1:
            acc = acc ^ v
        c >>= 1
        if c:
            msb = (v >> (L - 1)) & 1
            v = ((v << 1) & m) ^ (msb * p_low)
    return acc


def mulmod32(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``a * h mod 2^32`` for lanes below 2^32, with no int64 overflow: ``a``
    is split into 16-bit halves so every partial product stays below 2^48."""
    lo = (a & 0xFFFF) * h
    hi = (((a >> 16) * h) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def ctz(v: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of int64 lanes in ``[0, 2^32)``, with ctz(0) = 32.
    PyTorch has no popcount on the CPU, so the lowest set bit is isolated
    (``v & -v``) and its position read as the float64 exponent of that
    power of two (2^k = 0.5 * 2^(k+1)), which is exact on every backend;
    ``log2`` is not on CUDA."""
    iso = v & -v
    tz = torch.frexp(iso.to(torch.float64)).exponent.to(torch.int64) - 1
    return torch.where(iso == 0, 32, tz)
