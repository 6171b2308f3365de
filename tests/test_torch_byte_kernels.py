"""The byte path's three kernels' plain versions against the JAX package.

``ops.cyclic_fused`` (the h1 table lookup fused into the CYCLIC window
hash), ``kernels.bloom.bloom_probe`` and ``kernels.hll.hll_update`` run
their plain versions on CPU tensors; these are held bit for bit against the
reference's Pallas kernels in interpret mode and its oracles, mirroring
``tests/test_kernels.py``: the extreme table values, Bloom agreeing with
``BloomFilter.add``, the HLL estimate quality. Tokens outside [0, 256) are
compared with the reference oracle ``repro.kernels.ref.cyclic_fused_ref``
only: the reference kernel's one-hot lookup reads 0 for them, its oracle
wraps a negative index once and clamps, and the port follows the oracle.
The CUDA kernels (``csrc/rolling.cu``, ``csrc/bloom.cu``,
``csrc/hll.cu``) run only on the card: their case skips without one, and
``chip_smoke.py`` holds them against the plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sketches import HyperLogLog as JHyperLogLog
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bloom import bloom_probe as j_bloom_probe
from repro.kernels.bloom import bloom_probe_ref as j_bloom_probe_ref
from repro.kernels.hll import hll_update as j_hll_update
from repro.kernels.hll import hll_update_ref as j_hll_update_ref
from repro.kernels.sketch_fused import cyclic_rolling_fused as j_fused
from repro_torch.core import BloomFilter, HyperLogLog
from repro_torch.kernels import bloom, hll, ops, ref, sketch_fused

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels "
                    "there)")
    return torch.device("cuda")


def _u32(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                                dtype=np.uint32)


def _bytes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# The fused lookup + CYCLIC kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,n", [(2, 512, 8), (1, 300, 3), (4, 1024, 15)])
def test_cyclic_fused_matches_pallas_interpret(B, S, n):
    table, toks = _u32((256,), 9), _bytes((B, S), 5)
    got = sketch_fused.cyclic_rolling_fused(torch.from_numpy(toks),
                                            torch.from_numpy(table), n=n)
    want = j_fused(jnp.asarray(toks), jnp.asarray(table), n=n, block_b=2,
                   block_s=256, interpret=True)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (B, S - n + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cyclic_fused_exact_for_extreme_values():
    """All-ones and high-bit table entries survive the lookup."""
    table = np.asarray([0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x00010001]
                       + [0] * 252, dtype=np.uint32)
    toks = np.asarray([[0, 1, 2, 3] * 64], dtype=np.int32)
    got = ops.cyclic_fused(toks, table, n=1, device="cpu")
    want = j_fused(jnp.asarray(toks), jnp.asarray(table), n=1, block_b=1,
                   block_s=256, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[0, :4], table[:4])


@pytest.mark.parametrize("n,L", [(1, 32), (5, 32), (8, 32), (25, 32),
                                 (5, 20), (8, 20), (9, 8), (20, 16),
                                 (33, 32)])
def test_cyclic_fused_matches_oracle(n, L):
    table, toks = _u32((256,), n), _bytes((3, 300), L + n)
    for impl in ("ref", "auto"):
        got = ops.cyclic_fused(toks, table, n=n, L=L, impl=impl,
                               device="cpu")
        want = jops.cyclic_fused(jnp.asarray(toks), jnp.asarray(table), n=n,
                                 L=L, impl="ref")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same hashes as the rolling kernel's path on looked-up values
    np.testing.assert_array_equal(
        got.numpy(), ops.cyclic(table[toks], n=n, L=L, device="cpu").numpy())


@pytest.mark.parametrize("n", [1, 3, 8])
def test_out_of_range_tokens_follow_the_oracle(n):
    table = _u32((256,), 4)
    toks = _bytes((2, 40), n)
    toks[0, :6] = [-300, -1, 256, 300, -256, 255]
    toks[1, -4:] = [-257, 1000, -2, 2 ** 31 - 1]
    got = ops.cyclic_fused(torch.from_numpy(toks), torch.from_numpy(table),
                           n=n, device="cpu")
    want = jref.cyclic_fused_ref(jnp.asarray(toks), jnp.asarray(table), n, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = ref.lookup_ref(torch.tensor([-300, -1, 256, 300, -256, 255]),
                         torch.arange(256))
    assert idx.tolist() == [0, 255, 255, 255, 0, 255]


def test_cyclic_fused_leading_dims_and_validation():
    table, toks = _u32((256,), 1), _bytes((2, 3, 30), 2)
    got = ops.cyclic_fused(torch.from_numpy(toks), table, n=4)
    assert tuple(got.shape) == (2, 3, 27)
    np.testing.assert_array_equal(
        got.numpy().reshape(6, 27),
        ops.cyclic_fused(toks.reshape(6, 30), table, n=4,
                         device="cpu").numpy())
    with pytest.raises(ValueError, match="sequence length"):
        ops.cyclic_fused(toks[..., :3], table, n=4, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        ops.cyclic_fused(toks, table, n=4, impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="table"):
        sketch_fused.cyclic_rolling_fused(torch.from_numpy(toks[0]),
                                          torch.zeros(255,
                                                      dtype=torch.uint32),
                                          n=4)


# ---------------------------------------------------------------------------
# Bloom membership
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,k,log2_m", [(2, 512, 4, 16), (3, 300, 2, 14),
                                          (1, 2048, 8, 18)])
def test_bloom_probe_matches_pallas_interpret(B, S, k, log2_m):
    ha, hb = _u32((B, S), 1), _u32((B, S), 2)
    words = 1 << (log2_m - 5)
    bits = _u32((words,), 3) & _u32((words,), 4)          # ~25 % fill
    got = bloom.bloom_probe(torch.from_numpy(ha), torch.from_numpy(hb),
                            torch.from_numpy(bits), k=k, log2_m=log2_m)
    assert got.dtype == torch.bool and tuple(got.shape) == (B, S)
    args = (jnp.asarray(ha), jnp.asarray(hb), jnp.asarray(bits))
    want = j_bloom_probe(*args, k=k, log2_m=log2_m, block_b=2, block_s=256,
                         interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_bloom_probe_ref(*args, k=k,
                                                  log2_m=log2_m)))
    if k <= 2:
        assert bool(got.any())
    assert not bool(got.all())


def test_bloom_probe_agrees_with_core_filter():
    """No false negatives: every pair added to the filter probes as a
    member."""
    bf = BloomFilter(log2_m=16, k=4)
    add_a, add_b = _u32((500,), 11), _u32((500,), 12)
    bits = bf.add(bf.init("cpu"), torch.from_numpy(add_a),
                  torch.from_numpy(add_b))
    got = bloom.bloom_probe(torch.from_numpy(add_a[None]),
                            torch.from_numpy(add_b[None]), bits, k=4,
                            log2_m=16)
    assert bool(got.all())
    other = bloom.bloom_probe(torch.from_numpy(_u32((1, 4000), 13)),
                              torch.from_numpy(_u32((1, 4000), 14)), bits,
                              k=4, log2_m=16)
    fill = float(bf.fill_fraction(bits))
    assert float(other.float().mean()) < 2 * fill ** 4


def test_bloom_probe_validates_like_the_reference():
    h = torch.zeros((2, 8), dtype=torch.uint32)
    bits = torch.zeros(1 << 9, dtype=torch.uint32)
    with pytest.raises(ValueError, match="one shape"):
        bloom.bloom_probe(h, h[:, :4], bits, log2_m=14)
    with pytest.raises(ValueError, match="one shape"):
        bloom.bloom_probe(h[0], h[0], bits, log2_m=14)
    with pytest.raises(ValueError, match="bits must have shape"):
        bloom.bloom_probe(h, h, bits, log2_m=15)


# ---------------------------------------------------------------------------
# HLL register update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,b", [(4096, 8), (5000, 10), (300, 6)])
def test_hll_update_matches_pallas_interpret(N, b):
    h = _u32((N,), b)
    got = hll.hll_update(torch.from_numpy(h), b=b, rank_bits=32 - b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1 << b,)
    want = j_hll_update(jnp.asarray(h), b=b, rank_bits=32 - b, block=1024,
                        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_hll_update_ref(jnp.asarray(h), b=b,
                                                 rank_bits=32 - b)))


@pytest.mark.parametrize("b", [4, 10])
@pytest.mark.parametrize("rank_bits", [32, 32 - 4, 3])
def test_hll_update_edge_hashes(b, rank_bits):
    """Zero, hashes with h >> b == 0 (rank rank_bits+1, 33 at the default)
    and the ragged tail."""
    h = _u32((1000,), b + rank_bits)
    h[:4] = [0, 1, (1 << b) - 1, 1 << b]
    h[-3:] = [0xFFFFFFFF, 1 << 31, 2]
    got = hll.hll_update(torch.from_numpy(h), b=b, rank_bits=rank_bits)
    want = j_hll_update(jnp.asarray(h), b=b, rank_bits=rank_bits, block=256,
                        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) == min(32, rank_bits) + 1


def test_hll_update_estimate_quality():
    h = _u32((200_000,), 11)
    regs = hll.hll_update(torch.from_numpy(h), b=10, rank_bits=22)
    est = float(HyperLogLog(b=10, hash_bits=32).estimate(regs))
    assert est == pytest.approx(
        float(JHyperLogLog(b=10, hash_bits=32).estimate(
            jnp.asarray(regs.numpy()))), rel=1e-6)
    assert abs(est - 200_000) / 200_000 < 0.12


@pytest.mark.parametrize("b", [1, 2, 3, 17])
def test_hll_update_validates(b):
    """Any b, as the reference takes: b = 1, 2, 3 and 17 give the
    reference's registers; a negative rank_bits still raises."""
    h = _u32((5000,), 30 + b)
    got = hll.hll_update(torch.from_numpy(h), b=b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1 << b,)
    want = j_hll_update(jnp.asarray(h), b=b, block=1024, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="rank_bits"):
        hll.hll_update(torch.from_numpy(h), b=b, rank_bits=-1)


# ---------------------------------------------------------------------------
# The CUDA kernels (card only)
# ---------------------------------------------------------------------------

def test_kernels_match_plain_versions_on_the_card(cuda):
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(-300, 556, (3, 2000), generator=gen,
                         dtype=torch.int32)
    table = torch.randint(0, 1 << 32, (256,), generator=gen).to(torch.uint32)
    for n, L in ((1, 32), (8, 32), (25, 32), (5, 20)):
        got = ops.cyclic_fused(toks.to(cuda), table.to(cuda), n=n, L=L,
                               impl="kernel")
        want = ops.cyclic_fused(toks, table, n=n, L=L, impl="ref")
        assert torch.equal(got.cpu(), want)
    ha, hb = (torch.randint(0, 1 << 32, (4, 3000), generator=gen)
              .to(torch.uint32) for _ in range(2))
    for k, log2_m in ((4, 22), (2, 14), (8, 18)):
        bits = torch.randint(0, 1 << 32, (1 << (log2_m - 5),),
                             generator=gen).to(torch.uint32)
        got = bloom.bloom_probe(ha.to(cuda), hb.to(cuda), bits.to(cuda), k=k,
                                log2_m=log2_m)
        assert torch.equal(got.cpu(), bloom.bloom_probe(ha, hb, bits, k=k,
                                                        log2_m=log2_m))
    for b in (4, 12, 16):
        got = hll.hll_update(ha.to(cuda), b=b, rank_bits=32 - b)
        assert torch.equal(got.cpu(), hll.hll_update(ha, b=b,
                                                     rank_bits=32 - b))


def test_widened_domains_match_plain_versions_on_the_card(cuda):
    """hll_update over b in [1, 31] (shared registers up to b = 14, global
    above) and the fused lookup kernel at n > L."""
    gen = torch.Generator().manual_seed(1)
    h = torch.randint(0, 1 << 32, (20_000,), generator=gen).to(torch.uint32)
    for b in (1, 2, 3, 14, 15, 17, 20):
        got = hll.hll_update(h.to(cuda), b=b)
        assert torch.equal(got.cpu(), hll.hll_update(h, b=b))
    toks = torch.randint(0, 256, (3, 2000), generator=gen, dtype=torch.int32)
    table = torch.randint(0, 1 << 32, (256,), generator=gen).to(torch.uint32)
    for n, L in ((9, 8), (20, 16), (33, 32), (100, 32)):
        got = ops.cyclic_fused(toks.to(cuda), table.to(cuda), n=n, L=L,
                               impl="kernel")
        want = ops.cyclic_fused(toks, table, n=n, L=L, impl="ref")
        assert torch.equal(got.cpu(), want)
