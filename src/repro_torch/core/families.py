"""The paper's recursive n-gram hash families, CYCLIC and GENERAL.

Every family hashes all length-``n`` windows of a token stream to ``L``-bit
values. This module holds the defining per-window formula
(``hash_windows_direct``, O(n) work per window); the rolling kernels behind
the dedup path live in :mod:`repro_torch.kernels`.

Parameters are a dict of tensors. ``h1`` is the fully independent symbol
hash: one uniform uint32 per alphabet symbol, drawn from an explicit
``torch.Generator`` on the CPU and then moved to ``device``, so a seed gives
the same table on every device. It does not give the JAX package's
threefry bits; parity with that package carries the parameters across
(:mod:`repro_torch.convert`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch

from repro_torch.core import gf2, u32

Params = Dict[str, torch.Tensor]


def init_h1(gen: torch.Generator, sigma: int, device="cuda") -> torch.Tensor:
    """Fully independent symbol hash: one i.i.d. uniform uint32 per symbol."""
    bits = torch.randint(0, 1 << 32, (sigma,), generator=gen, dtype=torch.int64)
    return bits.to(torch.uint32).to(device)


@dataclasses.dataclass(frozen=True)
class _Family:
    n: int
    L: int = 32

    @property
    def name(self) -> str:
        return type(self).__name__.upper()

    @property
    def out_bits(self) -> int:
        return self.L

    def __post_init__(self):
        if not 1 <= self.L <= 32:
            raise ValueError("L must be in [1, 32]")
        if self.n < 1:
            raise ValueError("n must be >= 1")
        if self.L < self.n:
            raise ValueError(f"{self.name} requires L >= n (paper Table 1)")

    def _lookup(self, params: Params, tokens) -> torch.Tensor:
        """tokens (...,) -> h1 values masked to L bits, uint32 on h1's device.
        The gather and the mask run on the int32 view of the table: PyTorch
        implements both for int32 on every backend."""
        h1 = params["h1"].view(torch.int32)
        t = torch.as_tensor(tokens, device=h1.device).to(torch.int64)
        v = h1[t]
        if self.L < 32:
            v = v & gf2.mask(self.L)
        return v.view(torch.uint32)

    def init(self, gen: torch.Generator, sigma: int, device="cuda") -> Params:
        return {"h1": init_h1(gen, sigma, device)}

    def _window_terms(self, v: torch.Tensor, k: int) -> torch.Tensor:
        raise NotImplementedError

    def hash_windows_direct(self, params: Params, tokens) -> torch.Tensor:
        """tokens (..., S) -> (..., S-n+1) uint32 window hashes."""
        h1v = u32.lanes(self._lookup(params, tokens))
        W = h1v.shape[-1] - self.n + 1
        acc = torch.zeros(h1v.shape[:-1] + (W,), dtype=torch.int64,
                          device=h1v.device)
        for k in range(self.n):
            acc = acc ^ self._window_terms(h1v[..., k : k + W], k)
        return acc.to(torch.uint32)

    def hash_windows_batched(self, params: Params, tokens) -> torch.Tensor:
        """tokens (..., S) -> (..., S-n+1) uint32 window hashes. The direct
        form already runs over leading dims, which the JAX package reaches
        with one ``vmap`` per dim."""
        return self.hash_windows_direct(params, tokens)


@dataclasses.dataclass(frozen=True)
class General(_Family):
    """Polynomial hashing mod an irreducible p(x): pairwise independent
    (Lemma 1)."""

    p: int = 0  # degree-L irreducible, WITH top bit; 0 = auto from table

    def __post_init__(self):
        super().__post_init__()
        if self.p == 0:
            object.__setattr__(self, "p", gf2.find_irreducible_host(self.L))
        if self.p.bit_length() - 1 != self.L:
            raise ValueError("p must have degree exactly L")

    @functools.cached_property
    def _xpows(self) -> tuple:
        return tuple(gf2.x_pow_mod_host(k, self.p, self.L)
                     for k in range(self.n + 1))

    def _window_terms(self, v, k):
        return u32.mul_const(v, self._xpows[self.n - 1 - k], self.p, self.L)


@dataclasses.dataclass(frozen=True)
class Cyclic(_Family):
    """Rotation-based rolling hash. Not uniform on all L bits (Lemma 3), but
    pairwise independent on any L-n+1 consecutive bits (Theorem 1)."""

    @property
    def out_bits(self) -> int:
        """Bits that survive the Theorem-1 discard."""
        return self.L - self.n + 1

    def _window_terms(self, v, k):
        return u32.rotl_const(v, (self.n - 1 - k) % self.L, self.L)

    def pairwise_bits(self, h: torch.Tensor, *,
                      keep_low: bool = True) -> torch.Tensor:
        """Discard n-1 consecutive bits (Theorem 1) -> pairwise-independent
        (L-n+1)-bit values. ``keep_low`` keeps bits [0, L-n+1)."""
        h = u32.lanes(h)
        if not keep_low:
            h = h >> (self.n - 1)
        return (h & gf2.mask(self.out_bits)).to(torch.uint32)


FAMILIES = {"general": General, "cyclic": Cyclic}

# the reference package's other families, not ported yet
_NOT_PORTED = ("threewise", "id37", "buffered_general")


def make_family(name: str, n: int, L: int = 32, **kw) -> _Family:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"family {name!r} is not ported to repro_torch yet "
            f"(ROADMAP.md, Queue 1 item 2)")
    return FAMILIES[name](n=n, L=L, **kw)
