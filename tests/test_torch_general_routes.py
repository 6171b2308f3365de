"""GENERAL's two routes for the product x^n * v mod p
(``repro_torch.kernels.general``) against the JAX package, bit for bit.

The card's ``csrc/rolling.cu`` takes the product by the fold (a few shifts
and XORs) or from byte-wide chunk tables; ``general.route`` picks one from
(n, p, L). Here each route's arithmetic on int64 lanes, as the kernel does
it with the route's constants and ``general.chunk_tables``, is held
against the reference's
``repro.kernels.general._mul_const`` over n in 1..40 and L in {8, 16, 19,
20, 32}, with find_irreducible_host's modulus and a dense one; the route
choice against its condition; the tables against Lemma 2's
(``gf2.build_shiftn_table_host``); the rolling recurrence on either route
against the plain version; and ``ops.general(impl="ref")`` at route cases
against the reference's Pallas kernel in interpret mode. The kernel itself
runs only on the card (tests/test_torch_on_card.py, chip_smoke.py).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import general as jgeneral
from repro.kernels import ops as jops
from repro_torch.core import gf2
from repro_torch.kernels import general, ops, ref

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

LS = (8, 16, 19, 20, 32)
NS = range(1, 41)


@functools.lru_cache(maxsize=None)
def _dense(L: int) -> int:
    """A dense irreducible p of degree L, which the fold takes at no n: the
    one of weight 9 with its top bit (7 at L = 8: x^8 + ... + 1, of weight
    9, is divisible by x^2 + x + 1) and the smallest low part."""
    weight = 9 if L > 8 else 7
    for low in range(1, 1 << L, 2):
        if bin(low).count("1") == weight - 1 and \
                gf2.is_irreducible_host((1 << L) | low):
            return (1 << L) | low
    raise ValueError(f"no irreducible p of degree {L} and weight {weight}")


def _product(v: torch.Tensor, n: int, p: int, L: int,
             which: int) -> torch.Tensor:
    """x^n * v mod p on int64 lanes (v below 2^L) as route ``which`` of
    csrc/rolling.cu computes it: the fold, (v << n) ^ the overflow t =
    v >> (L - n) shifted by each set bit of p_low; or the tables, (v << n
    for n < L) ^ a table entry for each byte chunk of the top min(n, L)
    bits of v."""
    r = general.route(n, p, L)
    if which == general.FOLD:
        t = v >> (L - n)
        m = (v << n) & gf2.mask(L)
        for j in r.shifts:
            m = m ^ (t << j)
        return m
    tab = torch.from_numpy(general.chunk_tables(n, p, L).astype(np.int64))
    top = L - n if n < L else 0
    m = (v << n) & gf2.mask(L) if n < L else torch.zeros_like(v)
    for c in range(len(tab) // 256):
        m = m ^ tab[c * 256 + ((v >> (top + 8 * c)) & 0xFF)]
    return m


def _poly(kind: str, L: int) -> int:
    return gf2.find_irreducible_host(L) if kind == "default" else _dense(L)


def _lanes(L: int, seed: int, size: int = 512) -> np.ndarray:
    v = np.random.default_rng(seed).integers(0, 1 << L, size=size,
                                             dtype=np.uint64)
    v[:3] = (0, 1, (1 << L) - 1)
    return v


def test_dense_moduli_are_dense_and_irreducible():
    for L in LS:
        p = _dense(L)
        assert p.bit_length() - 1 == L and gf2.is_irreducible_host(p)
        assert bin(p).count("1") >= (9 if L >= 9 else 7)


@pytest.mark.parametrize("kind", ["default", "dense"])
@pytest.mark.parametrize("L", LS)
def test_route_products_match_reference_mul_const(L, kind):
    """Each route's product, where it applies, == the reference's
    _mul_const by x^n mod p, over n in 1..40 (n >= L included)."""
    p = _poly(kind, L)
    v = _lanes(L, seed=L)
    vj = jnp.asarray(v.astype(np.uint32))
    vt = torch.from_numpy(v.astype(np.int64))
    folds = 0
    for n in NS:
        c = jgeneral._xpows_host(n, p, L)[n]
        want = np.asarray(jgeneral._mul_const(vj, c, p, L)).astype(np.int64)
        routes = [general.TABLES]
        if general.route(n, p, L).route == general.FOLD:
            routes.append(general.FOLD)
            folds += 1
        for which in routes:
            got = _product(vt, n, p, L, which).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"n={n} "
                                          f"route={which}")
    # the default moduli take the fold below L - deg(p_low) + 1; the dense
    # ones never
    p_low = p & gf2.mask(L)
    assert folds == (L - p_low.bit_length() + 1 if kind == "default" else 0)


@pytest.mark.parametrize("L", LS)
def test_route_picks_the_fold_exactly_where_it_holds(L):
    """The fold where 1 <= n < L, n + deg(p_low) <= L and p_low has 1 to
    FOLD_TERMS set bits; the tables elsewhere, ceil(min(n, L) / 8) of
    them. Moduli of every weight from 1 to 6 bits in p_low, irreducible or
    not (the kernel takes any p of degree L)."""
    lows = [1, 0b11, 0b1011, gf2.find_irreducible_host(L) & gf2.mask(L),
            0b11111, 0b111111, _dense(L) & gf2.mask(L)]
    for low in lows:
        p = (1 << L) | (low & gf2.mask(L))
        p_low = p & gf2.mask(L)
        weight = bin(p_low).count("1")
        for n in NS:
            r = general.route(n, p, L)
            fold = (n < L and 1 <= weight <= general.FOLD_TERMS
                    and n + p_low.bit_length() - 1 <= L)
            assert r.route == (general.FOLD if fold else general.TABLES), \
                (hex(p), n)
            if fold:
                assert r.ways == weight and r.shifts == tuple(
                    j for j in range(L) if p_low >> j & 1)
            else:
                assert r.ways == (min(n, L) + 7) // 8 and r.shifts == ()
    with pytest.raises(ValueError, match="p of degree L"):
        general.route(4, 1 << (L - 1) | 1, L)


@pytest.mark.parametrize("L", LS)
def test_chunk_tables_are_lemma2_tables_in_bytes(L):
    """For n < L the tables are Lemma 2's table of the top n bits
    (gf2.build_shiftn_table_host, 2^n entries: n up to 12 here) cut into
    byte chunks; each has 256 entries below 2^L."""
    p = _dense(L)
    for n in range(1, min(L, 13)):
        tabs = general.chunk_tables(n, p, L)
        assert tabs.shape == (((n + 7) // 8) * 256,)
        (lemma2,) = gf2.build_shiftn_table_host(n, p, L)
        idx = np.arange(1 << n)
        got = np.zeros(1 << n, dtype=np.uint32)
        for c in range(len(tabs) // 256):
            got ^= tabs[c * 256 + ((idx >> (8 * c)) & 0xFF)]
        np.testing.assert_array_equal(got, lemma2, err_msg=f"n={n}")
    assert int(general.chunk_tables(L + 3, p, L).max()) < 1 << L


@pytest.mark.parametrize("L,kind,n", [(32, "default", 8), (32, "default", 25),
                                      (32, "dense", 8), (32, "dense", 33),
                                      (19, "default", 25),
                                      (20, "default", 12)])
def test_rolling_on_either_route_matches_plain(L, kind, n):
    """The kernel's recurrence, the first window by Horner's rule and then
    h' = x*h ^ x^n*out ^ in with the route's product, gives the plain
    version's hashes."""
    p = _poly(kind, L)
    x = torch.from_numpy(_lanes(L, seed=n, size=3 * 90).reshape(3, 90)
                         .astype(np.int64))
    want = ref.general_ref(x, n, p, L)
    p_low = p & gf2.mask(L)
    h = torch.zeros(3, dtype=torch.int64)
    for t in range(n):
        h = gf2.xtimes(h, p_low, L) ^ x[:, t]
    got = [h]
    for j in range(1, x.shape[1] - n + 1):
        h = (gf2.xtimes(h, p_low, L)
             ^ _product(x[:, j - 1], n, p, L, general.route(n, p, L).route)
             ^ x[:, j + n - 1])
        got.append(h)
    assert torch.equal(torch.stack(got, dim=1), want)


@pytest.mark.parametrize("L,kind,n", [(32, "dense", 8), (20, "default", 20)])
def test_general_ref_matches_reference_pallas_interpret_at_route_cases(
        L, kind, n):
    """ops.general's plain version against the reference's Pallas kernel
    (interpret mode) on a tables-route modulus and at n = L."""
    p = _poly(kind, L)
    x = np.random.default_rng(n).integers(0, 1 << 32, size=(2, 48),
                                          dtype=np.uint32)
    got = ops.general(x, n=n, p=p, L=L, impl="ref", device="cpu")
    want = jops.general(jnp.asarray(x), n=n, p=p, L=L, impl="pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
