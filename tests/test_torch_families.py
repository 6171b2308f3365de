"""repro_torch.core's five hash families against repro.core, bit for bit.

The same numpy draws go to both packages (through
``repro_torch.convert.family_params_from_jax``): THREEWISE, ID37, GENERAL,
BUFFERED-GENERAL and CYCLIC, each in its three forms (``hash_windows_direct``,
``hash_stream``, ``hash_windows``), at n in {1, 2, 5, 8, 25} and L in {16,
32}, THREEWISE and ID37 also at L < n. Then the cases of
``tests/test_hashing.py``: BUFFERED-GENERAL equals GENERAL for every
k_split, the rolling-window shift, the paper's Table 3 and the
``hash_stream`` prefix property.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_family as jmake_family
from repro_torch.convert import family_params_from_jax
from repro_torch.core import FAMILIES, gf2, make_family, u32

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

_FORMS = ("hash_windows_direct", "hash_stream", "hash_windows")
_CASES = [(name, n, L) for name in sorted(FAMILIES) for n in (1, 2, 5, 8, 25)
          for L in (16, 32) if L >= n or name in ("threewise", "id37")]


def _kw(name, n):
    """BUFFERED-GENERAL with tables of at most 2^8 entries (the fewest
    chunks that get there)."""
    if name != "buffered_general":
        return {}
    return {"k_split": next(k for k in range(1, n + 1)
                            if n % k == 0 and n // k <= 8)}


def _pair(name, n, L, **kw):
    jf, tf = jmake_family(name, n, L, **kw), make_family(name, n, L, **kw)
    if name == "buffered_general":
        # build the reference's cached tables outside its scan: built inside
        # one, they hold a tracer that the next call of the instance trips on
        jf._tables
    return jf, tf


def _h1(name, n, sigma, rng):
    shape = (n, sigma) if name == "threewise" else (sigma,)
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("name,n,L", _CASES)
def test_three_forms_match_reference(name, n, L):
    rng = np.random.default_rng(1000 * n + L + len(name))
    sigma, S = 64, 60
    jf, tf = _pair(name, n, L, **_kw(name, n))
    h1 = _h1(name, n, sigma, rng)
    tokens = rng.integers(0, sigma, size=(2, S)).astype(np.int32)
    params = family_params_from_jax({"h1": h1}, device="cpu")
    got = {form: getattr(tf, form)(params, torch.from_numpy(tokens))
           for form in _FORMS}
    for form in _FORMS:
        assert got[form].dtype == torch.uint32
        assert tuple(got[form].shape) == (2, S - n + 1)
        # every form gives the direct form's bits on every row ...
        np.testing.assert_array_equal(got[form].numpy(),
                                      got["hash_windows_direct"].numpy())
        # ... and the reference's same form on the first
        want = getattr(jf, form)({"h1": jnp.asarray(h1)},
                                 jnp.asarray(tokens[0]))
        np.testing.assert_array_equal(got[form].numpy()[0], np.asarray(want),
                                      err_msg=form)
    if L < 32:
        assert int(u32.lanes(got["hash_windows"]).max()) < 1 << L


def test_buffered_general_matches_general_all_ksplits():
    rng = np.random.default_rng(7)
    h1 = rng.integers(0, 1 << 32, size=256, dtype=np.uint32)
    t = torch.from_numpy(rng.integers(0, 256, size=(2, 200)))
    base = make_family("general", n=8, L=32)
    params = {"h1": torch.from_numpy(h1)}
    want = base.hash_windows_direct(params, t)
    np.testing.assert_array_equal(
        want.numpy()[0],
        np.asarray(jmake_family("general", n=8, L=32).hash_windows_direct(
            {"h1": jnp.asarray(h1)}, jnp.asarray(t.numpy()[0]))))
    for k_split in (1, 2, 4, 8):
        fam = make_family("buffered_general", n=8, L=32, k_split=k_split)
        assert torch.equal(fam.hash_stream(params, t), want), k_split
    with pytest.raises(ValueError, match="k_split"):
        make_family("buffered_general", n=8, L=32, k_split=3)


@pytest.mark.parametrize("k_split", [1, 2, 4, 8])
def test_shift_tables_match_reference(k_split):
    from repro.core import gf2 as jgf2
    p = gf2.find_irreducible_host(32)
    got = gf2.build_shiftn_table_host(8, p, 32, k_split)
    want = jgf2.build_shiftn_table_host(8, p, 32, k_split)
    assert len(got) == len(want) == k_split
    for g, w in zip(got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)
    # the lane step of the recursive form
    v = np.random.default_rng(k_split).integers(0, 1 << 32, 64, np.uint32)
    xt = gf2.xtimes(u32.lanes(torch.from_numpy(v)), p & gf2.mask(32), 32)
    np.testing.assert_array_equal(
        xt.numpy(), np.asarray(jgf2.xtimes(jnp.asarray(v), p & gf2.mask(32),
                                           32)))


@pytest.mark.parametrize("name", ["cyclic", "id37"])
def test_rolling_property_window_shift(name):
    """Hashing a shifted stream reproduces the shifted hash sequence: the
    prefix forms carry no positional leak."""
    fam = make_family(name, n=4, L=32)
    params = fam.init(torch.Generator().manual_seed(0), 256, "cpu")
    t = torch.from_numpy(np.random.default_rng(3).integers(0, 256, 100))
    full = fam.hash_windows(params, t)
    assert torch.equal(full[10:], fam.hash_windows(params, t[10:]))


def test_table3_exact():
    """Paper Table 3 (bit strings LSB-first): h(a,a) under CYCLIC, L=3."""
    cyc = make_family("cyclic", n=2, L=3)
    lsb = lambda s: int(s[::-1], 2)
    table3 = {"000": "000", "100": "110", "010": "011", "110": "101",
              "001": "101", "101": "011", "011": "110", "111": "000"}
    for h1a, want in table3.items():
        params = {"h1": torch.tensor([lsb(h1a)], dtype=torch.uint32)}
        assert int(cyc.hash_ngram(params, [0, 0])) == lsb(want)


@pytest.mark.parametrize("S,n", [(2, 1), (7, 3), (12, 6), (30, 5), (30, 1)])
def test_hash_stream_prefix_consistency(S, n):
    """Streaming more symbols never changes hashes already emitted."""
    fam = make_family("cyclic", n=n, L=32)
    params = fam.init(torch.Generator().manual_seed(S), 16, "cpu")
    t = torch.from_numpy(np.random.default_rng(S).integers(0, 16, S))
    full = fam.hash_stream(params, t)
    half = fam.hash_stream(params, t[: S // 2 + n])
    assert torch.equal(full[: len(half)], half)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_batched_tables_gather_along_last_axis(name):
    """A batch of tables gives each table's own hashes (the layout the exact
    independence checkers enumerate in)."""
    fam = make_family(name, n=3, L=8)
    rng = np.random.default_rng(5)
    shape = (4, 3, 5) if name == "threewise" else (4, 5)
    tables = torch.from_numpy(rng.integers(0, 256, size=shape,
                                           dtype=np.uint32))
    gram = [1, 4, 2]
    got = fam.hash_ngram({"h1": tables}, gram)
    assert tuple(got.shape) == (4,)
    for a in range(4):
        assert int(got[a]) == int(fam.hash_ngram({"h1": tables[a]}, gram))


def test_l_below_n_only_where_the_paper_allows():
    for name in ("threewise", "id37"):
        fam = make_family(name, n=25, L=16)
        params = fam.init(torch.Generator().manual_seed(1), 32, "cpu")
        assert fam.hash_windows(params, torch.arange(30) % 32).shape == (6,)
    for name in ("general", "buffered_general", "cyclic"):
        with pytest.raises(ValueError, match="L >= n"):
            make_family(name, n=25, L=16)


def test_family_params_from_jax_checks_its_input():
    h1 = np.arange(6, dtype=np.uint32).reshape(2, 3)
    got = family_params_from_jax({"h1": h1}, device="cpu")
    assert got["h1"].dtype == torch.uint32 and tuple(got["h1"].shape) == (2, 3)
    with pytest.raises(ValueError, match="uint32"):
        family_params_from_jax({"h1": h1.astype(np.int64)}, device="cpu")
    with pytest.raises(ValueError, match="exactly"):
        family_params_from_jax({"h1": h1, "a": h1}, device="cpu")
