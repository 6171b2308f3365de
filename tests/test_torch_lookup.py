"""The decontamination scan's lookups on the CPU: ``Decontaminator`` stages
a token block once and gathers both draws' h1 values from that copy. Its
lookups, stream scan and batch scan equal the same fed by two lookups that
each staged the block on its own (``stream.stage``): ids of every
integer type, ids below 0 and past the table's end, L = 32 and below.

The file imports no JAX, so it runs on a machine with a card and no JAX;
the scan on the card is in tests/test_torch_on_card.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.data.decontam import DecontamConfig, Decontaminator
from repro_torch.kernels import shard, stream

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

VOCAB = 1000
# the ids at the table's edges, and past them on both sides
EDGES = (-(1 << 31), -7, -1, 0, 1, VOCAB - 2, VOCAB - 1, VOCAB, VOCAB + 1,
         (1 << 31) - 1)


def _tokens(rng, shape, dtype=np.int32, vocab=VOCAB):
    """Ids over the vocabulary with every edge id planted."""
    t = rng.integers(0, vocab, shape).astype(np.int64)
    flat = t.reshape(-1)
    flat[:len(EDGES)] = EDGES
    rng.shuffle(flat)
    return t.astype(dtype)


def _scanner(seed=11, L=32):
    dc = Decontaminator(DecontamConfig(ngram_n=5, L=L, log2_m=12, vocab=VOCAB,
                                       impl="auto", device="cpu", seed=seed))
    rng = np.random.default_rng(seed)
    evals = rng.integers(0, VOCAB, (2, 40)).astype(np.int32)
    dc.add_eval_set(evals)
    return dc, evals, rng


def _two_stagings(dc, tokens):
    """The lookups as they were: each draw staged its own copy of the
    block and gathered from it."""
    cpu = torch.device("cpu")
    return (dc.fam_a._lookup(dc.pa, stream.stage(tokens, cpu)),
            dc.fam_b._lookup(dc.pb, stream.stage(tokens, cpu)))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.int16,
                                   torch.int8, torch.uint8, torch.uint32])
@pytest.mark.parametrize("L", [32, 19])
def test_lookups_equal_two_stagings(dtype, L):
    dc, _, rng = _scanner(seed=L, L=L)
    ids = _tokens(rng, (3, 41), np.int64, vocab=VOCAB + VOCAB // 4)
    if dtype == torch.uint8:
        ids = np.abs(ids) % 256
    elif dtype == torch.int16:
        ids = np.clip(ids, -(1 << 15), (1 << 15) - 1)
    elif dtype == torch.int8:
        ids = np.clip(ids, -(1 << 7), (1 << 7) - 1)
    elif dtype == torch.uint32:
        ids = ids & 0x7FFFFFFF
    tokens = torch.from_numpy(ids).to(dtype)
    got = dc._lookups(tokens)
    want = _two_stagings(dc, tokens)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint32 and g.shape == tokens.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    # an id outside the table reads its last entry, masked to L bits
    ids = torch.from_numpy(ids)
    past = (ids < 0) | (ids >= VOCAB)
    if dtype != torch.uint8:
        assert past.any()
    for g, params in zip(got, (dc.pa, dc.pb)):
        last = int(params["h1"][-1]) & ((1 << L) - 1)
        vals = g.view(torch.int32)[past].to(torch.int64) & 0xFFFFFFFF
        assert vals.eq(last).all()


def test_stream_scan_equals_two_stagings():
    dc, evals, rng = _scanner()
    T, B, C = 3, 4, 16
    blocks = []
    for _ in range(2):
        blk = _tokens(rng, (T, B, C))
        # a row that repeats the eval set, so there are hits to count
        blk[:, 1, :] = np.resize(evals[0], (T, C))
        blocks.append(blk)
    st = dc.init_stream(B)
    carry = stream.init_state(dc.plan, B, device="cpu")
    for blk in blocks:
        ha, hb = dc._lookups(blk)
        want_a, want_b = _two_stagings(dc, blk)
        assert torch.equal(ha.view(torch.int32), want_a.view(torch.int32))
        assert torch.equal(hb.view(torch.int32), want_b.view(torch.int32))
        st = dc.update_stream_many(st, blk)
        carry = stream.update_many(dc.plan, carry, want_a, chunk_b=want_b,
                                   operands={"bloom": {"bits": dc.bits}},
                                   impl="ref")
    got = stream.finalize(dc.plan, st["stream"])["bloom"]
    want = stream.finalize(dc.plan, carry)["bloom"]
    assert torch.equal(got, want)
    assert int(got[1]) > 0
    frac = dc.finalize_stream(st)
    assert frac[1] > 0 and np.all(frac >= 0)


def test_batch_scan_equals_two_stagings():
    dc, evals, rng = _scanner(seed=12)
    tokens = _tokens(rng, (5, 48))
    tokens[2, :40] = evals[1]
    want_a, want_b = _two_stagings(dc, tokens)
    counts = shard.run_auto(dc.plan, want_a, h1v_b=want_b,
                            operands={"bloom": {"bits": dc.bits}},
                            impl="ref")["bloom"]
    want = (counts.to(torch.float32) / (48 - 5 + 1)).numpy()
    got = dc.contamination(tokens)
    assert np.array_equal(got, want)
    assert got[2] > 0
    # the same block as a tensor of another integer type
    assert np.array_equal(dc.contamination(torch.from_numpy(tokens).long()),
                          want)
