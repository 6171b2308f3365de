"""GF(2)[x] polynomial arithmetic on host integers.

Polynomials of degree < L are the L low bits of an int (the coefficient of
``x^i`` is bit ``i``), as in the paper (§6): addition is XOR, multiplication
by ``x`` a left shift followed by a conditional XOR with the modulus. These
run at set-up time only (finding irreducible moduli, the constants
``x^k mod p`` of GENERAL); lane arithmetic lives in :mod:`repro_torch.core.u32`.
"""
from __future__ import annotations

import functools

__all__ = [
    "mask",
    "xtimes_host",
    "mulmod_host",
    "x_pow_mod_host",
    "is_irreducible_host",
    "find_irreducible_host",
    "PAPER_TABLE2",
    "GENERAL_L19",
]

# Irreducible polynomials from the paper, Table 2 (with the top bit).
PAPER_TABLE2 = {
    10: (1 << 10) | (1 << 3) | 1,
    15: (1 << 15) | (1 << 1) | 1,
    20: (1 << 20) | (1 << 3) | 1,
    25: (1 << 25) | (1 << 3) | 1,
    30: (1 << 30) | (1 << 6) | (1 << 4) | (1 << 1) | 1,
}

# The degree-19 polynomial the paper prints for GENERAL is divisible by
# x^2+x+1; this is the verified irreducible used in its place:
# x^19 + x^5 + x^2 + x + 1.
GENERAL_L19 = (1 << 19) | (1 << 5) | (1 << 2) | (1 << 1) | 1


def mask(L: int) -> int:
    """All-ones mask over the L low bits."""
    if not 1 <= L <= 32:
        raise ValueError(f"L must be in [1, 32], got {L}")
    return (1 << L) - 1


def xtimes_host(v: int, p: int, L: int) -> int:
    """Multiply v(x) by x modulo p(x) (p given WITH its top bit)."""
    v <<= 1
    if v >> L:
        v ^= p
    return v & mask(L)


def mulmod_host(a: int, b: int, p: int, L: int) -> int:
    """Carry-less multiply a(x)*b(x) mod p(x) (p WITH top bit)."""
    res = 0
    while b:
        if b & 1:
            res ^= a
        b >>= 1
        a = xtimes_host(a, p, L)
    return res


def x_pow_mod_host(k: int, p: int, L: int) -> int:
    """x^k mod p(x) by repeated squaring (p WITH top bit)."""
    result, base = 1, 2  # 1 and x
    while k:
        if k & 1:
            result = mulmod_host(result, base, p, L)
        base = mulmod_host(base, base, p, L)
        k >>= 1
    return result


def _gcd_host(a: int, b: int) -> int:
    """Polynomial GCD over GF(2)[x] on int representations."""
    while b:
        da, db = a.bit_length() - 1, b.bit_length() - 1
        while da >= db and a:
            a ^= b << (da - db)
            da = a.bit_length() - 1
        a, b = b, a
    return a


def is_irreducible_host(p: int) -> bool:
    """Rabin's irreducibility test for p(x) over GF(2).

    p of degree L is irreducible iff x^(2^L) == x (mod p) and
    gcd(x^(2^(L/q)) - x, p) == 1 for every prime divisor q of L.
    """
    L = p.bit_length() - 1
    if L < 1:
        return False

    def x_pow_pow2(e: int) -> int:
        r = 2
        for _ in range(e):
            r = mulmod_host(r, r, p, L)
        return r

    if x_pow_pow2(L) != 2:
        return False
    primes, m, d = [], L, 2
    while d * d <= m:
        if m % d == 0:
            primes.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        primes.append(m)
    return all(_gcd_host(x_pow_pow2(L // q) ^ 2, p) == 1 for q in primes)


@functools.lru_cache(maxsize=None)
def find_irreducible_host(L: int) -> int:
    """Deterministically find an irreducible polynomial of degree L: the
    paper's Table 2 entry, else the first low-weight hit of an increasing
    scan. Returns the int WITH the top bit set."""
    if L in PAPER_TABLE2:
        return PAPER_TABLE2[L]
    if L == 19:
        return GENERAL_L19
    top = 1 << L
    # the constant term must be 1 (else x divides the candidate)
    for low in range(1, 1 << min(L, 20), 2):
        if is_irreducible_host(top | low):
            return top | low
    raise RuntimeError(f"no irreducible polynomial found for L={L}")
