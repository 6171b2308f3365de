"""repro_torch.core's sketches against repro.core's, bit for bit.

The same numpy draws go to both packages: ctz and trailing zeros, the
HyperLogLog update, split update and float32 estimate, the Bloom filter's
probes, exact OR-scatter, membership and fill, and the CountMin table and
query, with the JAX package's parameters carried across.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketches as jsk
from repro_torch.core import sketches as tsk
from repro_torch.core import u32

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


def _hashes(n, seed, bits=32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, size=n, dtype=np.uint64).astype(
        np.uint32)


def test_ctz_matches_reference():
    edge = np.array([0, 1, 2, 3, 1 << 31, 0xFFFFFFFF, 0x80000001, 96],
                    np.uint32)
    powers = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    v = np.concatenate([edge, powers, powers * 3, _hashes(500, 0)])
    got = u32.ctz(torch.from_numpy(v.astype(np.int64))).numpy()
    want = np.asarray(jsk.trailing_zeros(jnp.asarray(v), 32))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 32 and got[4] == 31
    for L in (13, 25, 32):
        t = tsk.trailing_zeros(torch.from_numpy(v), L)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(jsk.trailing_zeros(jnp.asarray(v), L)))


@pytest.mark.parametrize("b,hash_bits,n", [(4, 32, 50), (10, 25, 3000),
                                           (12, 32, 20000)])
def test_hll_update_and_estimate_match(b, hash_bits, n):
    h = _hashes(n, b, hash_bits)
    jh, th = jsk.HyperLogLog(b=b, hash_bits=hash_bits), tsk.HyperLogLog(
        b=b, hash_bits=hash_bits)
    jregs = jh.update(jh.init(), jnp.asarray(h))
    tregs = th.update(th.init("cpu"), torch.from_numpy(h))
    assert tregs.dtype == torch.int32 and tuple(tregs.shape) == (1 << b,)
    np.testing.assert_array_equal(tregs.numpy(), np.asarray(jregs))
    est = th.estimate(tregs)
    assert est.dtype == torch.float32
    np.testing.assert_allclose(float(est), float(jh.estimate(jregs)),
                               rtol=1e-5)
    # two-draw update and merge
    h2 = _hashes(n, b + 100)
    jsplit = jh.update_split(jregs, jnp.asarray(h), jnp.asarray(h2), 20)
    tsplit = th.update_split(tregs, torch.from_numpy(h), torch.from_numpy(h2),
                             20)
    np.testing.assert_array_equal(tsplit.numpy(), np.asarray(jsplit))
    np.testing.assert_array_equal(
        th.merge(tregs, tsplit).numpy(),
        np.asarray(jh.merge(jregs, jsplit)))


@pytest.mark.parametrize("log2_m,k", [(10, 4), (14, 2), (20, 7)])
def test_bloom_add_contains_fill_match(log2_m, k):
    jb, tb = jsk.BloomFilter(log2_m=log2_m, k=k), tsk.BloomFilter(
        log2_m=log2_m, k=k)
    ha, hb = _hashes(700, log2_m), _hashes(700, log2_m + 1)
    jbits = jb.add(jb.init(), jnp.asarray(ha), jnp.asarray(hb))
    tbits = tb.add(tb.init("cpu"), torch.from_numpy(ha), torch.from_numpy(hb))
    assert tbits.dtype == torch.uint32 and tuple(tbits.shape) == (
        (1 << log2_m) // 32,)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    qa = np.concatenate([ha[:300], _hashes(300, 7)])
    qb = np.concatenate([hb[:300], _hashes(300, 8)])
    got = tb.contains(tbits, torch.from_numpy(qa), torch.from_numpy(qb))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jb.contains(jbits, jnp.asarray(qa),
                                            jnp.asarray(qb))))
    assert got[:300].all()                      # no false negatives
    np.testing.assert_allclose(float(tb.fill_fraction(tbits)),
                               float(jb.fill_fraction(jbits)), rtol=1e-6)


def test_scatter_or_is_exact_under_collisions():
    bits = np.array([0b1000, 0, 0xFFFF0000], np.uint32)
    word = np.array([0, 0, 0, 1, 1, 2, 2])
    bit = np.array([1, 0, 1, 31, 31, 0, 20])
    got = tsk._scatter_or(torch.from_numpy(bits), torch.from_numpy(word),
                          torch.from_numpy(bit))
    want = jsk._scatter_or(jnp.asarray(bits), jnp.asarray(word, jnp.uint32),
                           jnp.asarray(bit, jnp.uint32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().tolist() == [0b1011, 1 << 31, 0xFFFF0001 | (1 << 20)]


@pytest.mark.parametrize("depth,log2_width", [(4, 8), (4, 16), (3, 12)])
def test_countmin_add_and_query_match(depth, log2_width):
    jc = jsk.CountMinSketch(depth=depth, log2_width=log2_width)
    tc = tsk.CountMinSketch(depth=depth, log2_width=log2_width)
    jp = jc.init(jax.random.PRNGKey(depth + log2_width))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    h = _hashes(5000, log2_width)
    h[:1000] = h[0]                            # one heavy hitter
    jp = jc.add(jp, jnp.asarray(h))
    tp = tc.add(tp, torch.from_numpy(h))
    assert tp["table"].dtype == torch.int32
    np.testing.assert_array_equal(tp["table"].numpy(), np.asarray(jp["table"]))
    q = h[:50]
    got = tc.query(tp, torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jc.query(jp, jnp.asarray(q))))
    assert got[0] >= 1000


def test_parameter_draws_and_layouts():
    gen = torch.Generator().manual_seed(0)
    p = tsk.CountMinSketch(depth=3, log2_width=5).init(gen, "cpu")
    assert (p["a"].to(torch.int64) & 1).all()
    assert p["table"].dtype == torch.int32 and tuple(p["table"].shape) == (3, 32)
    p2 = tsk.CountMinSketch(depth=3, log2_width=5).init(
        torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["a"], p2["a"]) and torch.equal(p["b"], p2["b"])
    assert tsk.HyperLogLog(b=6).init("cpu").dtype == torch.int32
    assert tuple(tsk.BloomFilter(log2_m=12).init("cpu").shape) == (128,)
