"""The paper's recursive n-gram hash families, in three evaluation forms.

Every family hashes all length-``n`` windows of a token stream to ``L``-bit
values. Three forms give the same bits:

* ``hash_stream``         — the paper's symbol-at-a-time *recursive*
  algorithm (Algorithms 1–4), one step per symbol;
* ``hash_windows_direct`` — the defining per-window formula, O(n) work per
  window; the oracle of the tests;
* ``hash_windows``        — the parallel form: a prefix XOR (CYCLIC) or a
  prefix sum (ID37) collapses each window to two prefix values; GENERAL,
  BUFFERED-GENERAL and THREEWISE use the direct form.

All three run over leading dims: tokens ``(..., S)`` give ``(..., S-n+1)``
uint32 hashes. The symbol table may carry leading dims of its own (a batch
of tables, as the exact independence checkers enumerate them): it is
gathered along its last axis, so tables ``(A, sigma)`` and an n-gram
``(n,)`` give ``(A, 1)``.

Families
--------
- :class:`ThreeWise`        — Algorithm 1, non-recursive, exactly 3-wise
  independent: one table per position.
- :class:`ID37`             — Algorithm 2, randomized Karp–Rabin (uniform,
  not pairwise).
- :class:`General`          — Algorithm 3, irreducible p(x): pairwise
  independent (Lemma 1).
- :class:`BufferedGeneral`  — §8, Lemma 2: GENERAL with the shift by x^n
  read from K tables of 2^(n/K) entries.
- :class:`Cyclic`           — Algorithm 4, p(x)=x^L+1: pairwise independent
  on any L-n+1 consecutive bits (Theorem 1).

Parameters are a dict of tensors. ``h1`` is the fully independent symbol
hash: one uniform uint32 per alphabet symbol (THREEWISE: one row per
position), drawn from an explicit ``torch.Generator`` on the CPU and then
moved to ``device``, so a seed gives the same table on every device. It does
not give the JAX package's threefry bits; parity with that package carries
the parameters across (:mod:`repro_torch.convert`). Lane arithmetic runs on
int64 lanes (:mod:`repro_torch.core.u32`); the rolling kernels behind the
data paths live in :mod:`repro_torch.kernels`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core import gf2, u32

Params = Dict[str, torch.Tensor]


def init_h1(gen: torch.Generator, sigma: int, device="cuda") -> torch.Tensor:
    """Fully independent symbol hash: one i.i.d. uniform uint32 per symbol."""
    bits = torch.randint(0, 1 << 32, (sigma,), generator=gen, dtype=torch.int64)
    return bits.to(torch.uint32).to(device)


def _tokens(params: Params, tokens) -> torch.Tensor:
    """Token ids as int64 on the table's device."""
    return torch.as_tensor(tokens, device=params["h1"].device).to(torch.int64)


def _lag(h1v: torch.Tensor, n: int) -> torch.Tensor:
    """h1 of the symbol leaving the window at each step: h1v shifted right
    by n along the last axis, 0 while the window fills."""
    z = torch.zeros_like(h1v)
    if h1v.shape[-1] > n:
        z[..., n:] = h1v[..., :-n]
    return z


def _scan(h1v: torch.Tensor, n: int, step: Callable) -> torch.Tensor:
    """The recursive form: ``x <- step(x, h1(in), h1(out))`` once per symbol
    from x = 0, vectorised over leading dims; the states after each full
    window, as uint32."""
    z = _lag(h1v, n)
    x = torch.zeros(h1v.shape[:-1], dtype=torch.int64, device=h1v.device)
    xs = []
    for j in range(h1v.shape[-1]):
        x = step(x, h1v[..., j], z[..., j])
        xs.append(x)
    return torch.stack(xs, dim=-1)[..., n - 1 :].to(torch.uint32)


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

    def _check_l_ge_n(self):
        if self.L < self.n:
            raise ValueError(f"{self.name} requires L >= n (paper Table 1)")

    def _gather(self, h1: torch.Tensor, tokens) -> torch.Tensor:
        """Table(s) ``(..., sigma)`` at tokens -> uint32 masked to L bits.
        A token outside [0, sigma) reads the table's last entry, as the
        reference's gather of the token as uint32 clamps it. The gather
        and the mask run on the int32 view of the table: PyTorch
        implements both for int32 on every backend."""
        h1 = h1.view(torch.int32)
        last = h1.shape[-1] - 1
        idx = torch.as_tensor(tokens, device=h1.device).to(torch.int64)
        v = h1[..., torch.where(idx < 0, last, idx.clamp_max(last))]
        if self.L < 32:
            v = v & gf2.mask(self.L)
        return v.view(torch.uint32)

    def _lookup(self, params: Params, tokens) -> torch.Tensor:
        """tokens (...,) -> h1 values masked to L bits, uint32 on h1's
        device."""
        return self._gather(params["h1"], tokens)

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

    def hash_windows(self, params: Params, tokens) -> torch.Tensor:
        """The parallel form; the direct form unless a family has a faster
        one."""
        return self.hash_windows_direct(params, tokens)

    def hash_windows_batched(self, params: Params, tokens) -> torch.Tensor:
        """tokens (..., S) -> (..., S-n+1) uint32 window hashes. The direct
        form already runs over leading dims, which the JAX package reaches
        with one ``vmap`` per dim."""
        return self.hash_windows_direct(params, tokens)

    def hash_stream(self, params: Params, tokens) -> torch.Tensor:
        raise NotImplementedError

    def hash_ngram(self, params: Params, ngram) -> torch.Tensor:
        """Hash one n-gram (length-n tokens) -> uint32, with the table's
        leading dims."""
        return self.hash_windows_direct(params, ngram)[..., 0]


# ---------------------------------------------------------------------------
# Algorithm 1 — non-recursive 3-wise independent family
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ThreeWise(_Family):
    """h(x) = h_1(x_1) XOR ... XOR h_n(x_n), one independent table per
    position: ``h1`` is (n, sigma)."""

    def init(self, gen: torch.Generator, sigma: int, device="cuda") -> Params:
        return {"h1": torch.stack([init_h1(gen, sigma, device)
                                   for _ in range(self.n)])}

    def _lookup_pos(self, params: Params, k: int, tokens) -> torch.Tensor:
        return u32.lanes(self._gather(params["h1"][..., k, :], tokens))

    def hash_windows_direct(self, params: Params, tokens) -> torch.Tensor:
        t = _tokens(params, tokens)
        W = t.shape[-1] - self.n + 1
        acc = 0
        for k in range(self.n):
            acc = acc ^ self._lookup_pos(params, k, t[..., k : k + W])
        return acc.to(torch.uint32)

    def hash_stream(self, params: Params, tokens) -> torch.Tensor:
        # Algorithm 1 keeps a FIFO of the last n symbols and XORs their
        # positional hashes at every step
        t = _tokens(params, tokens)
        buf = torch.zeros(t.shape[:-1] + (self.n,), dtype=torch.int64,
                          device=t.device)
        hs = []
        for j in range(t.shape[-1]):
            buf = torch.cat([buf[..., 1:], t[..., j : j + 1]], dim=-1)
            h = 0
            for k in range(self.n):
                h = h ^ self._lookup_pos(params, k, buf[..., k])
            hs.append(h)
        return torch.stack(hs, dim=-1)[..., self.n - 1 :].to(torch.uint32)


# ---------------------------------------------------------------------------
# Algorithm 2 — Randomized Karp-Rabin (Integer Division), "ID37"
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _int_pows_host(base: int, S: int) -> np.ndarray:
    """base^i mod 2^32 for i in [0, S)."""
    out = np.empty(S, dtype=np.int64)
    v = 1
    for i in range(S):
        out[i] = v
        v = (v * base) & u32.MASK32
    return out


@dataclasses.dataclass(frozen=True)
class ID37(_Family):
    """h = sum_k B^{n-1-k} h1(x_k) mod 2^L, default B=37 (paper §5).
    Products mod 2^32 go through :func:`u32.mulmod32`: a 32 x 32-bit product
    overflows an int64 lane."""

    B: int = 37

    def hash_windows_direct(self, params: Params, tokens) -> torch.Tensor:
        h1v = u32.lanes(self._lookup(params, tokens))
        W = h1v.shape[-1] - self.n + 1
        acc = 0
        for k in range(self.n):
            c = pow(self.B, self.n - 1 - k, 1 << 32)
            acc = (acc + u32.mulmod32(c, h1v[..., k : k + W])) & u32.MASK32
        return (acc & gf2.mask(self.L)).to(torch.uint32)

    def hash_stream(self, params: Params, tokens) -> torch.Tensor:
        # Algorithm 2: x <- B x - B^n z + h1(c) mod 2^32
        h1v = u32.lanes(self._lookup(params, tokens))
        Bn = pow(self.B, self.n, 1 << 32)

        def step(x, c, z):
            return (u32.mulmod32(self.B, x) - u32.mulmod32(Bn, z) + c) \
                & u32.MASK32

        hs = u32.lanes(_scan(h1v, self.n, step))
        return (hs & gf2.mask(self.L)).to(torch.uint32)

    def hash_windows(self, params: Params, tokens) -> torch.Tensor:
        # parallel prefix form, B odd => B invertible mod 2^32:
        # P_i = B^{-i} h1(x_i); C = cumsum(P); H_j = B^{j+n-1} (C_{j+n-1} -
        # C_{j-1})
        if self.B % 2 == 0:
            return self.hash_windows_direct(params, tokens)
        h1v = u32.lanes(self._lookup(params, tokens))
        S = h1v.shape[-1]
        n, W = self.n, S - self.n + 1
        dev = h1v.device
        ipow = torch.from_numpy(_int_pows_host(pow(self.B, -1, 1 << 32),
                                               S)).to(dev)
        fpow = torch.from_numpy(_int_pows_host(self.B, S)).to(dev)
        # each term is below 2^32, so the int64 sum is exact for S < 2^31
        csum = torch.cumsum(u32.mulmod32(ipow, h1v), dim=-1) & u32.MASK32
        left = torch.zeros_like(csum[..., :W])
        left[..., 1:] = csum[..., : W - 1]
        windowed = (csum[..., n - 1 :] - left) & u32.MASK32
        out = u32.mulmod32(fpow[n - 1 :], windowed)
        return (out & gf2.mask(self.L)).to(torch.uint32)


# ---------------------------------------------------------------------------
# Algorithm 3 — GENERAL (irreducible p(x)) and §8 RAM-buffered variant
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class General(_Family):
    """Polynomial hashing mod an irreducible p(x): pairwise independent
    (Lemma 1)."""

    p: int = 0  # degree-L irreducible, WITH top bit; 0 = auto from table

    def __post_init__(self):
        super().__post_init__()
        self._check_l_ge_n()
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

    def _shifter(self, device) -> Callable:
        """z -> x^n z mod p, the recursive step's shift of the outgoing
        symbol: n shift-reduce steps."""
        p_low = self.p & gf2.mask(self.L)

        def shift(z):
            for _ in range(self.n):
                z = gf2.xtimes(z, p_low, self.L)
            return z
        return shift

    def hash_stream(self, params: Params, tokens) -> torch.Tensor:
        # Algorithm 3: x <- x * x mod p, then XOR shift^n(z) and h1(c)
        h1v = u32.lanes(self._lookup(params, tokens))
        p_low = self.p & gf2.mask(self.L)
        shift = self._shifter(h1v.device)
        return _scan(h1v, self.n, lambda x, c, z:
                     gf2.xtimes(x, p_low, self.L) ^ shift(z) ^ c)


@dataclasses.dataclass(frozen=True)
class BufferedGeneral(General):
    """GENERAL with the Lemma-2 precomputed shift table (``k_split=1``) or
    the §8 K-split trade-off (``k_split=K``): shift^n(z) becomes K table
    lookups."""

    k_split: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.n % self.k_split:
            raise ValueError("k_split must divide n")

    @functools.cached_property
    def _tables(self) -> tuple:
        return tuple(torch.from_numpy(t.astype(np.int64)) for t in
                     gf2.build_shiftn_table_host(self.n, self.p, self.L,
                                                 self.k_split))

    def _shifter(self, device) -> Callable:
        n, L = self.n, self.L
        chunk = n // self.k_split
        tables = [t.to(device) for t in self._tables]

        def shift(z):
            # the low L-n bits shift up without reduction; each chunk of
            # the top n bits reads its reduced product from a table
            out = ((z & ((1 << (L - n)) - 1)) << n) & gf2.mask(L)
            for j, tbl in enumerate(tables):
                out = out ^ tbl[(z >> (L - n + j * chunk)) & ((1 << chunk) - 1)]
            return out
        return shift


# ---------------------------------------------------------------------------
# Algorithm 4 — CYCLIC (p(x) = x^L + 1, multiplication by x = rotl)
# ---------------------------------------------------------------------------


def _prefix_xor(x: torch.Tensor) -> torch.Tensor:
    """Inclusive XOR scan along the last axis in ceil(log2 S) shifted XORs
    (Hillis–Steele); PyTorch has no cumulative XOR."""
    d = 1
    while d < x.shape[-1]:
        x = torch.cat([x[..., :d], x[..., d:] ^ x[..., :-d]], dim=-1)
        d *= 2
    return x


@dataclasses.dataclass(frozen=True)
class Cyclic(_Family):
    """Rotation-based rolling hash. Not uniform on all L bits (Lemma 3), but
    pairwise independent on any L-n+1 consecutive bits (Theorem 1)."""

    def __post_init__(self):
        super().__post_init__()
        self._check_l_ge_n()

    @property
    def out_bits(self) -> int:
        """Bits that survive the Theorem-1 discard."""
        return self.L - self.n + 1

    def _window_terms(self, v, k):
        return u32.rotl_const(v, (self.n - 1 - k) % self.L, self.L)

    def hash_stream(self, params: Params, tokens) -> torch.Tensor:
        # Algorithm 4: x <- rotl(x, 1) XOR rotl(z, n) XOR h1(c)
        h1v = u32.lanes(self._lookup(params, tokens))
        n, L = self.n, self.L
        return _scan(h1v, n, lambda x, c, z: u32.rotl_const(x, 1, L)
                     ^ u32.rotl_const(z, n % L, L) ^ c)

    def hash_windows(self, params: Params, tokens) -> torch.Tensor:
        """Parallel prefix form: H_j = rotl(X_{j+n-1} XOR X_{j-1}, (j+n-1)
        mod L), with X the prefix XOR of P_i = rotr(h1(x_i), i mod L). XOR is
        its own inverse, so a window collapses to two prefix values."""
        h1v = u32.lanes(self._lookup(params, tokens))
        S = h1v.shape[-1]
        n, L, W = self.n, self.L, S - self.n + 1
        dev = h1v.device
        X = _prefix_xor(u32.rotr(h1v, torch.arange(S, device=dev) % L, L))
        left = torch.zeros_like(X[..., :W])
        left[..., 1:] = X[..., : W - 1]
        rot = (torch.arange(W, device=dev) + n - 1) % L
        return u32.rotl(X[..., n - 1 :] ^ left, rot, L).to(torch.uint32)

    def pairwise_bits(self, h: torch.Tensor, *,
                      keep_low: bool = True) -> torch.Tensor:
        """Discard n-1 consecutive bits (Theorem 1) -> pairwise-independent
        (L-n+1)-bit values. ``keep_low`` keeps bits [0, L-n+1)."""
        h = u32.lanes(h)
        if not keep_low:
            h = h >> (self.n - 1)
        return (h & gf2.mask(self.out_bits)).to(torch.uint32)


FAMILIES = {
    "threewise": ThreeWise,
    "id37": ID37,
    "general": General,
    "buffered_general": BufferedGeneral,
    "cyclic": Cyclic,
}


def make_family(name: str, n: int, L: int = 32, **kw) -> _Family:
    return FAMILIES[name](n=n, L=L, **kw)
