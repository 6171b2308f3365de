"""repro_torch.core against repro.core, bit for bit.

The same numpy draws go to both packages: GF(2) host arithmetic, the
CYCLIC and GENERAL window hashes, the Theorem-1 discard, the uint32 lane
helpers (including the mod-2^32 remix at 0xFFFFFFFF) and MinHash.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MinHash as JMinHash
from repro.core import gf2 as jgf2
from repro.core import make_family as jmake_family
from repro.kernels.general import _mul_const as j_mul_const
from repro.kernels.ref import _rotl_const as j_rotl_const
from repro_torch.core import MinHash, gf2, make_family, u32

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.numpy() if t.dtype == torch.uint32 else (
        t.numpy().astype(np.uint32))


@pytest.mark.parametrize("L", range(8, 33))
def test_gf2_host_functions_match(L):
    p = gf2.find_irreducible_host(L)
    assert p == jgf2.find_irreducible_host(L)
    assert gf2.is_irreducible_host(p)
    assert gf2.mask(L) == jgf2.mask(L)
    rng = np.random.default_rng(L)
    for v in rng.integers(0, 1 << L, size=8).tolist():
        assert gf2.xtimes_host(v, p, L) == jgf2.xtimes_host(v, p, L)
    for k in (0, 1, L - 1, L, 2 * L + 3):
        assert gf2.x_pow_mod_host(k, p, L) == jgf2.x_pow_mod_host(k, p, L)
    for cand in ((1 << L) | 3, (1 << L) | 0b1011, p ^ 2):
        assert gf2.is_irreducible_host(cand) == jgf2.is_irreducible_host(cand)


_CASES = [(n, L) for n in (1, 2, 5, 8, 25) for L in (16, 32) if L >= n]


@pytest.mark.parametrize("family", ["cyclic", "general"])
@pytest.mark.parametrize("n,L", _CASES)
def test_hash_windows_direct_matches(family, n, L):
    rng = np.random.default_rng(100 * n + L)
    h1 = rng.integers(0, 1 << 32, size=512, dtype=np.uint32)
    tokens = rng.integers(0, 512, size=(3, 90)).astype(np.int32)
    jf, tf = jmake_family(family, n, L), make_family(family, n, L)
    got = tf.hash_windows_direct({"h1": _t(h1)}, _t(tokens))
    assert got.dtype == torch.uint32 and tuple(got.shape) == (3, 90 - n + 1)
    for r in range(3):
        want = jf.hash_windows_direct({"h1": jnp.asarray(h1)},
                                      jnp.asarray(tokens[r]))
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))


@pytest.mark.parametrize("n,L", [(1, 32), (5, 16), (8, 32), (25, 32)])
@pytest.mark.parametrize("keep_low", [True, False])
def test_pairwise_bits_matches(n, L, keep_low):
    rng = np.random.default_rng(n)
    h = rng.integers(0, 1 << L, size=200, dtype=np.uint32)
    want = jmake_family("cyclic", n, L).pairwise_bits(jnp.asarray(h),
                                                      keep_low=keep_low)
    got = make_family("cyclic", n, L).pairwise_bits(_t(h), keep_low=keep_low)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lane_helpers_match():
    rng = np.random.default_rng(7)
    v = rng.integers(0, 1 << 32, size=300, dtype=np.uint32)
    v[:3] = [0, 1, 0xFFFFFFFF]
    lanes = u32.lanes(_t(v))
    for L in (1, 7, 16, 31, 32):
        vm = v & np.uint32((1 << L) - 1) if L < 32 else v
        for r in (0, 1, L - 1, L, L + 3):
            np.testing.assert_array_equal(
                _np(u32.rotl_const(u32.lanes(_t(vm)), r, L)),
                np.asarray(j_rotl_const(jnp.asarray(vm), r, L)))
    for L in (8, 19, 32):
        p = gf2.find_irreducible_host(L)
        for c in (1, 2, 0x5A5, (1 << L) - 1):
            np.testing.assert_array_equal(
                _np(u32.mul_const(lanes, c, p, L)),
                np.asarray(j_mul_const(jnp.asarray(v), c, p, L)))


def test_mulmod32_wraps_exactly():
    top = torch.tensor([0xFFFFFFFF], dtype=torch.int64)
    assert int(u32.mulmod32(top, top)) == (0xFFFFFFFF * 0xFFFFFFFF) % (1 << 32)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64)
    h = rng.integers(0, 1 << 32, size=1000, dtype=np.uint64)
    a[:2], h[:2] = 0xFFFFFFFF, [0xFFFFFFFF, 1]
    want = np.asarray(jnp.asarray(a.astype(np.uint32))
                      * jnp.asarray(h.astype(np.uint32)))
    got = u32.mulmod32(_t(a.astype(np.int64)), _t(h.astype(np.int64)))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got), (a * h) & 0xFFFFFFFF)


def test_minhash_signature_and_jaccard_match():
    rng = np.random.default_rng(11)
    k = 64
    a = rng.integers(0, 1 << 32, size=k, dtype=np.uint32) | 1
    b = rng.integers(0, 1 << 32, size=k, dtype=np.uint32)
    h = rng.integers(0, 1 << 32, size=500, dtype=np.uint32)
    h[0] = 0xFFFFFFFF
    want = JMinHash(k).signature({"a": jnp.asarray(a), "b": jnp.asarray(b)},
                                 jnp.asarray(h))
    got = MinHash(k).signature({"a": _t(a), "b": _t(b)}, _t(h))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    other = got.numpy().copy()
    other[: k // 4] ^= 1
    assert float(MinHash.jaccard(got, _t(other))) == pytest.approx(
        float(JMinHash.jaccard(jnp.asarray(got.numpy()), jnp.asarray(other))))


def test_own_draws_are_seeded_and_well_formed():
    fam = make_family("cyclic", 8)
    draw = lambda s: (fam.init(torch.Generator().manual_seed(s), 1000, "cpu"),
                      MinHash(16).init(torch.Generator().manual_seed(s), "cpu"))
    (p1, m1), (p2, m2), (p3, _) = draw(0), draw(0), draw(1)
    assert p1["h1"].dtype == torch.uint32 and p1["h1"].shape == (1000,)
    assert torch.equal(p1["h1"], p2["h1"]) and torch.equal(m1["a"], m2["a"])
    assert not torch.equal(p1["h1"], p3["h1"])
    assert (u32.lanes(m1["a"]) & 1).all()


@pytest.mark.parametrize("name", ["threewise", "id37", "buffered_general"])
def test_unported_families_raise(name):
    # the families and their data paths' unfused fallback are ported: the
    # deduper signs THREEWISE and ID37 by the bucketed path and the stats
    # fold their hashes unfused, each equal to the reference's.
    # BUFFERED-GENERAL gives GENERAL's bits, so the deduper signs it on the
    # fused GENERAL plan, as the reference's (its stats are unfused)
    from repro.data.dedup import DedupConfig as JDedupConfig
    from repro.data.dedup import MinHashDeduper as JMinHashDeduper
    from repro.data.stats import NgramStats as JNgramStats
    from repro.data.stats import StatsConfig as JStatsConfig
    from repro_torch.data.dedup import DedupConfig, MinHashDeduper
    from repro_torch.data.stats import NgramStats, StatsConfig
    assert make_family(name, 4).name == name.upper().replace("_", "")
    kw = dict(family=name, ngram_n=4, vocab=300, n_signatures=8,
              lsh_bands=2)
    jdd = JMinHashDeduper(JDedupConfig(**kw))
    dd = MinHashDeduper(DedupConfig(device="cpu", **kw))
    dd.import_params(jdd.export_state()["params"])
    if name == "buffered_general":
        assert dd.plan.hash.family == "general"
    else:
        assert dd.plan is None
    rng = np.random.default_rng(5)
    docs = [rng.integers(0, 300, size=m) for m in (3, 20, 41)]
    np.testing.assert_array_equal(dd.signature_many(docs),
                                  jdd.signature_many(docs))
    skw = dict(family=name, ngram_n=4, vocab=300, hll_b=5,
               cms_log2_width=6)
    jst = JNgramStats(JStatsConfig(**skw))
    st = NgramStats(StatsConfig(device="cpu", **skw))
    st.rebind_params(jst.export_params())
    toks = rng.integers(0, 300, (2, 25))
    got = st.update(st.init_state(), toks)
    want = jst.update(jst.init_state(), toks)
    for key in ("hll", "cms"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
