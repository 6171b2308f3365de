"""repro_torch.core.independence against repro.core.independence.

Both packages enumerate the same h1 tables (``all_tables``), so each exact
checker must give the same hash matrix and the same verdict as the
reference, on the cases of ``tests/test_independence.py`` (the paper's
claims C1–C7), and that verdict must be the paper's. The empirical checker
draws its tables from a ``torch.Generator``, not from threefry, so it is
held to the reference test's stated bound (about 4 sigma of a fair
multinomial), not to the reference's bits.
"""
import numpy as np
import pytest
import torch

from repro.core import independence as jind
from repro.core import make_family as jmake_family
from repro_torch.core import independence as ind
from repro_torch.core import make_family

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

AA_AB_BB = [[0, 0], [0, 1], [1, 1]]


def _cyclic_pairs(n):
    return [[[0] * n, [1] * n],
            [[0] * (n - 1) + [1], [1] + [0] * (n - 1)],
            [[0] * n, [0] * (n - 1) + [1]]]


# (id, family, n, L, family kwargs, checker, n-grams, sigma, transform,
#  bits, the paper's verdict)
_CASES = [
    *[(f"general pairwise {i}", "general", 2, 4, {}, "is_kwise_independent",
       g, 2, None, None, True) for i, g in enumerate(
           [[[0, 0], [1, 1]], [[0, 1], [1, 0]], [[0, 0], [0, 1]],
            [[1, 1], [1, 0]]])],
    ("general pairwise n3 a", "general", 3, 6, {}, "is_kwise_independent",
     [[0, 0, 1], [0, 1, 0]], 2, None, None, True),
    ("general pairwise n3 b", "general", 3, 6, {}, "is_kwise_independent",
     [[1, 1, 1], [0, 0, 0]], 2, None, None, True),
    *[(f"general uniform {g}", "general", 2, 4, {}, "is_uniform", g, 2,
       None, None, True) for g in ([0, 0], [0, 1], [1, 1])],
    ("general not 3-wise", "general", 2, 3, {}, "is_kwise_independent",
     AA_AB_BB, 2, None, None, False),
    ("general not 3-wise tz", "general", 2, 3, {},
     "is_kwise_trailing_zero_independent", AA_AB_BB, 2, None, None, False),
    ("general pairwise tz", "general", 2, 3, {},
     "is_kwise_trailing_zero_independent", AA_AB_BB[:2], 2, None, None, True),
    ("cyclic not 3-wise after discard", "cyclic", 2, 4, {},
     "is_kwise_independent", AA_AB_BB, 2, "low", "out", False),
    ("threewise 3-wise B", "threewise", 2, 2, {}, "is_kwise_independent",
     AA_AB_BB, 2, None, None, True),
    ("threewise 3-wise A", "threewise", 2, 2, {}, "is_kwise_independent",
     [[0, 0], [1, 1], [2, 2]], 3, None, None, True),
    ("threewise 3-wise C", "threewise", 2, 2, {}, "is_kwise_independent",
     [[0, 1], [1, 0], [1, 1]], 2, None, None, True),
    ("threewise not 4-wise", "threewise", 2, 1, {}, "is_kwise_independent",
     [[0, 2], [0, 3], [1, 2], [1, 3]], 4, None, None, False),
    ("threewise 3-wise tz", "threewise", 2, 2, {},
     "is_kwise_trailing_zero_independent", AA_AB_BB, 2, None, None, True),
    ("id37 not uniform n even", "id37", 2, 4, {}, "is_uniform", [0, 0], 1,
     None, None, False),
    *[(f"id37 uniform n odd {g}", "id37", 3, 4, {}, "is_uniform", g, s,
       None, None, True)
      for g, s in (([0, 0, 0], 1), ([0, 1, 0], 2), ([0, 1, 2], 3))],
    ("id37 even B uniform a", "id37", 2, 4, {"B": 36}, "is_uniform", [0, 0],
     1, None, None, True),
    ("id37 even B uniform b", "id37", 2, 4, {"B": 36}, "is_uniform", [0, 1],
     2, None, None, True),
    ("cyclic not uniform n even", "cyclic", 2, 4, {}, "is_uniform", [0, 0],
     1, None, None, False),
    *[(f"cyclic pairwise after discard n{n} L{L} {i}", "cyclic", n, L, {},
       "is_kwise_independent", g, 2, "low", "out", True)
      for n, L in ((2, 4), (3, 5), (2, 5))
      for i, g in enumerate(_cyclic_pairs(n))],
    *[(f"cyclic uniform after discard n{n} L{L} {v}", "cyclic", n, L, {},
       "is_uniform", [v] * n, 2, "low", "out", True)
      for n, L in ((2, 4), (3, 5), (2, 5)) for v in (0, 1)],
    ("cyclic high-bit discard", "cyclic", 2, 4, {}, "is_kwise_independent",
     [[0, 0], [1, 1]], 2, "high", "out", True),
    ("cyclic tz pairwise after discard", "cyclic", 2, 4, {},
     "is_kwise_trailing_zero_independent", [[0, 0], [1, 1]], 2, "low", "out",
     True),
]


def _transform(fam, kind):
    if kind is None:
        return None
    return lambda h: fam.pairwise_bits(h, keep_low=kind == "low")


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_exact_checker_verdicts_match_reference(case):
    _, name, n, L, kw, checker, grams, sigma, tr, bits, paper = case
    tf, jf = make_family(name, n, L, **kw), jmake_family(name, n, L, **kw)
    t_tr, j_tr = _transform(tf, tr), _transform(jf, tr)
    bits = tf.out_bits if bits == "out" else None
    grams2d = [grams] if checker == "is_uniform" else grams
    # the same enumerated tables give the same hash matrix ...
    got_h = ind.enumerate_hashes(tf, grams2d, sigma, t_tr)
    want_h = jind.enumerate_hashes(jf, grams2d, sigma, j_tr)
    assert got_h.dtype == np.uint32
    np.testing.assert_array_equal(got_h, want_h)
    # ... and the same verdict, the paper's
    extra = {} if bits is None else {"bits": bits}
    got = getattr(ind, checker)(tf, grams, sigma=sigma, transform=t_tr,
                                **extra)
    want = getattr(jind, checker)(jf, grams, sigma=sigma, transform=j_tr,
                                  **extra)
    assert got == want == paper


def test_threewise_xor_of_four_is_zero():
    """XOR of h(ac), h(ad), h(bc), h(bd) is identically 0 (paper §4)."""
    fam = make_family("threewise", n=2, L=1)
    hs = ind.enumerate_hashes(fam, [[0, 2], [0, 3], [1, 2], [1, 3]], sigma=4)
    assert hs.shape == (256, 4)
    assert ((hs[:, 0] ^ hs[:, 1] ^ hs[:, 2] ^ hs[:, 3]) == 0).all()


@pytest.mark.parametrize("name,B,x1,x2,exact", [
    ("id37", 37, [0, 0], [1, 1], 2 ** -3),
    ("id37", 36, [0, 0], [1, 0], None),
])
def test_id37_collision_probability_matches(name, B, x1, x2, exact):
    """ID37 is never pairwise, not even 2-universal (Prop. 3)."""
    tf, jf = make_family(name, 2, 4, B=B), jmake_family(name, 2, 4, B=B)
    got = ind.collision_probability(tf, x1, x2, sigma=2)
    assert got == jind.collision_probability(jf, x1, x2, sigma=2)
    assert got > 2 ** -4
    if exact is not None:
        assert got == pytest.approx(exact)


def test_cyclic_never_pairwise_raw():
    """Lemma 3's n=3 construction: h(a,a,b) vs h(a,b,a)."""
    tf, jf = make_family("cyclic", 3, 4), jmake_family("cyclic", 3, 4)
    got = ind.collision_probability(tf, [0, 0, 1], [0, 1, 0], sigma=2)
    assert got == jind.collision_probability(jf, [0, 0, 1], [0, 1, 0],
                                             sigma=2)
    assert got >= 2 ** -3


def test_numpy_helpers_match_reference():
    for L, slots in ((2, 3), (4, 2), (1, 8)):
        np.testing.assert_array_equal(ind.all_tables(L, slots),
                                      jind.all_tables(L, slots))
    v = np.random.default_rng(0).integers(0, 1 << 12, 500).astype(np.uint32)
    v[:2] = 0
    np.testing.assert_array_equal(ind.trailing_zeros_np(v, 12),
                                  jind.trailing_zeros_np(v, 12))
    hs = np.random.default_rng(1).integers(0, 8, (300, 2)).astype(np.uint32)
    np.testing.assert_array_equal(ind.joint_counts(hs, 3),
                                  jind.joint_counts(hs, 3))
    with pytest.raises(ValueError, match="too large"):
        ind.all_tables(8, 4)


def test_empirical_uniformity_L32():
    fam = make_family("cyclic", n=4, L=32)
    dev = ind.empirical_joint_deviation(
        fam, [[0, 1, 2, 3]], sigma=4, samples=4096,
        gen=torch.Generator().manual_seed(5), bits=8,
        transform=lambda h: fam.pairwise_bits(h) & 0xFF)
    assert dev < 4 / np.sqrt(4096)  # ~4 sigma of a fair multinomial
    with pytest.raises(ValueError, match="bits\\*k"):
        ind.empirical_joint_deviation(fam, [[0, 1, 2, 3]] * 2, sigma=4,
                                      samples=8,
                                      gen=torch.Generator().manual_seed(0),
                                      bits=20)
