"""repro_torch.data.dedup against repro.data.dedup, bit for bit.

Both dedupers are built from the same DedupConfig values; the reference's
sampled parameters are carried into the port with
``convert.params_from_jax`` (the port's own ``torch.Generator`` draws do not
give JAX's threefry bits). Signatures, add_batch flags, check_and_add
results and the packed LSH index must then be identical on a planted-
duplicate corpus, for both hash families.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MinHash as JMinHash
from repro.core import make_family as jmake_family
from repro.data import corpus as jcorpus
from repro.data import dedup as jdedup
from repro_torch import convert
from repro_torch.core import MinHash, make_family
from repro_torch.data import corpus, dedup
from repro_torch.kernels import stream

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernel "
                    "there)")
    return torch.device("cuda")


_SPEC = dict(n_docs=300, dup_rate=0.25, mutate_frac=0.01, seed=5, vocab=8192)


def _docs():
    docs, dup_of = corpus.documents(corpus.CorpusSpec(**_SPEC))
    jdocs, jdup = jcorpus.documents(jcorpus.CorpusSpec(**_SPEC))
    assert all(np.array_equal(a, b) for a, b in zip(docs, jdocs))
    np.testing.assert_array_equal(dup_of, jdup)
    return docs, dup_of


def _pair(family, **kw):
    cfg = dict(vocab=8192, threshold=0.5, family=family, **kw)
    ref = jdedup.MinHashDeduper(jdedup.DedupConfig(**cfg))
    port = dedup.MinHashDeduper(dedup.DedupConfig(device="cpu", **cfg))
    port.import_params(convert.params_from_jax(
        ref.export_state()["params"], device="cpu"))
    return ref, port


def _assert_index_equal(got, want):
    assert sorted(got) == sorted(want)
    for band in want:
        for key in want[band]:
            np.testing.assert_array_equal(got[band][key], want[band][key],
                                          err_msg=f"{band}/{key}")


@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_deduper_matches_reference(family):
    docs, _ = _docs()
    docs = docs + [np.arange(5, dtype=np.int32)]      # shorter than n
    ref, port = _pair(family, stream_rows=32, stream_chunk_s=256)
    with ref, port:
        sigs = port.signature_many(docs)
        np.testing.assert_array_equal(sigs, ref.signature_many(docs))
        assert (sigs[-1] == 0xFFFFFFFF).all()
        np.testing.assert_array_equal(port.add_batch(docs[:200]),
                                      ref.add_batch(docs[:200]))
        for d in docs[200:240]:
            assert port.check_and_add(d) == ref.check_and_add(d)
        np.testing.assert_array_equal(port.add_batch(docs[240:]),
                                      ref.add_batch(docs[240:]))
        got, want = port.export_state(), ref.export_state()
        np.testing.assert_array_equal(got["sigs"], want["sigs"])
        _assert_index_equal(got["index"], want["index"])
        for grp in ("fam", "mh"):
            for name, arr in want["params"][grp].items():
                np.testing.assert_array_equal(got["params"][grp][name], arr)


def test_recall_precision_on_planted_duplicates():
    # tests/test_data.py's streaming check, on the port's own seeded draw
    docs, dup_of = _docs()
    # one document per check: 8-row blocks keep the masked rows few
    dd = dedup.MinHashDeduper(dedup.DedupConfig(vocab=8192, threshold=0.5,
                                                stream_rows=8, device="cpu"))
    flagged = np.array([dd.check_and_add(d)[0] for d in docs])
    truth = dup_of >= 0
    recall = (flagged & truth).sum() / max(truth.sum(), 1)
    precision = (flagged & truth).sum() / max(flagged.sum(), 1)
    assert recall > 0.9, recall
    assert precision > 0.9, precision


def test_state_round_trip_continues_identically():
    docs, _ = _docs()
    cfg = dedup.DedupConfig(vocab=8192, threshold=0.5, device="cpu",
                            stream_rows=64)
    a = dedup.MinHashDeduper(cfg)
    a.add_batch(docs[:150])
    b = dedup.MinHashDeduper(dedup.DedupConfig(**{**cfg.__dict__,
                                                  "seed": 99}))
    b.import_state(a.export_state())
    np.testing.assert_array_equal(a.add_batch(docs[150:]),
                                  b.add_batch(docs[150:]))
    assert len(a) == len(b)


@pytest.mark.parametrize("lsh_bands", [16, 4])
def test_check_and_add_agrees_with_add_batch(lsh_bands):
    """The per-document path and the batched one key the LSH bands the same
    way: the same verdicts, the same matches and the same packed index."""
    docs, dup_of = _docs()
    docs = docs[:120]
    cfg = dedup.DedupConfig(vocab=8192, threshold=0.5, device="cpu",
                            lsh_bands=lsh_bands, stream_rows=32)
    one, batch = dedup.MinHashDeduper(cfg), dedup.MinHashDeduper(cfg)
    verdicts = [one.check_and_add(d) for d in docs]
    flags = batch.add_batch(docs)
    np.testing.assert_array_equal([v[0] for v in verdicts], flags)
    assert flags.any() and (dup_of[:120] >= 0).any()
    got, want = one.export_state(), batch.export_state()
    np.testing.assert_array_equal(got["sigs"], want["sigs"])
    _assert_index_equal(got["index"], want["index"])


@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_signature_batch_fused_matches(family):
    rng = np.random.default_rng(2)
    h1 = rng.integers(0, 1 << 32, size=4096, dtype=np.uint32)
    a = rng.integers(0, 1 << 32, size=32, dtype=np.uint32) | 1
    b = rng.integers(0, 1 << 32, size=32, dtype=np.uint32)
    toks = rng.integers(0, 4096, size=(5, 150)).astype(np.int32)
    nw = np.array([143, 0, 50, 143, 3], np.int32)
    want = jdedup.signature_batch_fused(
        jmake_family(family, 8), {"h1": jnp.asarray(h1)}, JMinHash(32),
        {"a": jnp.asarray(a), "b": jnp.asarray(b)}, jnp.asarray(toks),
        n_windows=jnp.asarray(nw), impl="ref")
    got = dedup.signature_batch_fused(
        make_family(family, 8), {"h1": torch.from_numpy(h1)}, MinHash(32),
        {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}, toks,
        n_windows=nw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tile_loop(group, Bt, Cs, T0):
    """The signing path's tiling as a loop over chunks and rows, one
    row-chunk copy at a time: the oracle of ``dedup._tile_blocks``."""
    max_len = max((len(d) for d in group), default=0)
    n_chunks = max(1, -(-max_len // Cs))
    done = 0
    while done < n_chunks:
        rem = n_chunks - done
        T = T0 if rem >= T0 else 1 << int(np.ceil(np.log2(rem)))
        toks = np.zeros((T, Bt, Cs), np.int32)
        lengths = np.zeros((T, Bt), np.int32)
        for t in range(T):
            lo = (done + t) * Cs
            for r, d in enumerate(group):
                v = int(np.clip(len(d) - lo, 0, Cs))
                if v:
                    toks[t, r, :v] = d[lo : lo + v]
                    lengths[t, r] = v
        done += T
        yield toks, lengths


# chunks of 16 symbols; n = 5 below, so 4 is one short of a window
_CS = 16
_EDGES = [0, 1, 4, _CS - 1, _CS, _CS + 1, 3 * _CS, 8 * _CS + 1]
_TILE_GROUPS = {
    "edges_descending": sorted(_EDGES, reverse=True),
    "edges_unsorted": [_CS + 1, 0, 8 * _CS + 1, 4, _CS, 1, 3 * _CS, _CS - 1],
    "fewer_rows": [40, 7, 0],
    "all_empty": [0, 0],
    # two full 8-chunk blocks and a tail chunk with 5 symbols
    "past_full_blocks": [19 * _CS + 5, 2 * _CS],
    "random_full": "random",
}


@pytest.mark.parametrize("Bt", [8, 64])
@pytest.mark.parametrize("T0", [1, 8])
@pytest.mark.parametrize("case", sorted(_TILE_GROUPS))
def test_tile_blocks_match_row_loop(case, T0, Bt):
    rng = np.random.default_rng(len(case) * 100 + T0 + Bt)
    lengths = _TILE_GROUPS[case]
    if lengths == "random":
        lengths = rng.integers(0, 12 * _CS, size=Bt).tolist()
    group = [rng.integers(1, 1 << 17, size=n).astype(np.int32)
             for n in lengths]
    got = list(dedup._tile_blocks(group, Bt, _CS, T0))
    want = list(_tile_loop(group, Bt, _CS, T0))
    assert len(got) == len(want)
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt.dtype == wt.dtype and gl.dtype == wl.dtype
        assert gt.shape == wt.shape and gl.shape == wl.shape
        assert gt.tobytes() == wt.tobytes()
        assert gl.tobytes() == wl.tobytes()


_TAIL_BATCHES = {
    # mixed lengths: the two longest cut into two segments each, seven rows
    # in one group of one full 8-chunk block, fewer launches than the
    # document layout's full block and padded tail
    "mixed": lambda longest: [40, longest, 4, 0, 7 * _CS + 9, _CS],
    # eight of the longest: the segments take as many launches (8 + 4 or
    # 8 + 8) as one row a document, so the document layout is kept
    "tied": lambda longest: [longest] * 8,
}


@pytest.mark.parametrize("batch", sorted(_TAIL_BATCHES))
@pytest.mark.parametrize("longest", [11 * _CS - 3, 13 * _CS])
def test_signatures_with_padded_tail_block(longest, batch):
    """Against the JAX package, in both layouts: in the document layout
    ("tied") the 11 or 13 chunks run as one full 8-chunk block and then a
    tail of 3 or 5 chunks padded to 4 or 8, whose last chunks are 0-length
    in every row; in the segmented layout ("mixed") every row fits one
    block. The rows signed show which layout ran."""
    rng = np.random.default_rng(longest)
    lengths = _TAIL_BATCHES[batch](longest)
    docs = [rng.integers(0, 8192, size=n).astype(np.int32) for n in lengths]
    ref, port = _pair("cyclic", ngram_n=5, n_signatures=16, lsh_bands=4,
                      stream_rows=8, stream_chunk_s=_CS,
                      stream_block_chunks=8)
    rows = {"mixed": 7, "tied": len(docs)}[batch]
    with ref, port:
        before = dedup.segment_count()
        sigs = port.signature_many(docs)
        assert dedup.segment_count() - before == rows
        np.testing.assert_array_equal(sigs, ref.signature_many(docs))
        for d, sig in zip(docs, sigs):
            np.testing.assert_array_equal(sig, port.signature_unfused(d))


# signing blocks of 4 chunks of 16 symbols: a segment holds at most 64
_SPAN = 4 * _CS
_SEG = dict(n_signatures=16, lsh_bands=4, stream_rows=4, stream_chunk_s=_CS,
            stream_block_chunks=4)


def _edge_lengths(n):
    """Lengths at the cuts of a document into segments, for n-grams: with
    h = n - 1 a segment after the first opens with h symbols of history,
    so the cuts step by span - h."""
    h = n - 1
    step = _SPAN - h
    return [0, 1, n - 1, n, step - 1, step, step + 1, _SPAN, _SPAN + 1,
            2 * step + h - 1, 2 * step + h, 2 * step + h + 1,
            3 * step + h + 1, 5 * _SPAN + 3]


def _seg_lengths(N, n):
    """A document's segment lengths, counted by hand: full segments of
    _SPAN, then what is left after the last one's cut, history included."""
    h, step = n - 1, _SPAN - n + 1
    k = max(1, -(-(N - h) // step))
    return [N] if k == 1 else [_SPAN] * (k - 1) + [N - (k - 1) * step]


def _launches(lengths, Bt):
    """Chunk launches of rows of these lengths, grouped Bt at a time by
    descending length: the chunks the row-loop tiling oracle gives."""
    ls = sorted(lengths, reverse=True)
    return sum(toks.shape[0] for g in range(0, len(ls), Bt)
               for toks, _ in _tile_loop([np.zeros(x, np.int32)
                                          for x in ls[g : g + Bt]],
                                         Bt, _CS, 4))


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_segments_hold_each_window_once(n):
    """Every window of a document ends in exactly one of its segments, past
    that segment's history; each segment is a view of at most one block."""
    h = n - 1
    for N in range(0, 4 * _SPAN):
        doc = np.arange(N, dtype=np.int32)
        rows, row_lens, starts = dedup._segment_docs(
            [doc], np.array([N], np.int64), _SPAN, h)
        assert starts.tolist() == [0]
        assert [len(r) for r in rows] == _seg_lengths(N, n)
        assert row_lens.tolist() == _seg_lengths(N, n)
        ends = []
        for j, r in enumerate(rows):
            assert len(r) <= _SPAN and (N == 0 or np.shares_memory(r, doc))
            # windows end at row symbols h.. (a row's first h symbols are
            # history, the first row's are the document's own)
            ends.extend(r[h:].tolist())
        assert ends == list(range(h, N)), N


@pytest.mark.parametrize("n", [2, 5, 8])
@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_segmented_signatures_match_reference(family, n):
    """Documents cut at every edge of the segment layout sign to the JAX
    package's signatures and to the unfused ones, bit for bit, in groups
    whose last holds fewer rows than stream_rows; shorter than n and empty
    documents sign to the sentinel."""
    rng = np.random.default_rng(n)
    lengths = _edge_lengths(n)
    docs = [rng.integers(0, 8192, size=x).astype(np.int32) for x in lengths]
    ref, port = _pair(family, ngram_n=n, **_SEG)
    rows = sum(len(_seg_lengths(x, n)) for x in lengths)
    assert rows > len(docs) and rows % _SEG["stream_rows"]
    with ref, port:
        before = dedup.segment_count()
        sigs = port.signature_many(docs)
        assert dedup.segment_count() - before == rows
        np.testing.assert_array_equal(sigs, ref.signature_many(docs))
        for d, sig in zip(docs, sigs):
            np.testing.assert_array_equal(sig, port.signature_unfused(d))
        assert (sigs[lengths.index(n - 1)] == 0xFFFFFFFF).all()
        assert (sigs[lengths.index(0)] == 0xFFFFFFFF).all()


def test_segmented_signing_on_a_2_shard_mesh():
    """Segments past twice a group's rows double the group over two
    shards: the same signatures as one device and as the unfused path."""
    rng = np.random.default_rng(3)
    lengths = [5 * _SPAN, 3 * _SPAN + 7, 2 * _SPAN, 70, 9, 0]
    docs = [rng.integers(0, 8192, size=x).astype(np.int32) for x in lengths]
    kw = dict(vocab=8192, device="cpu", **_SEG)
    one = dedup.MinHashDeduper(dedup.DedupConfig(**kw))
    two = dedup.MinHashDeduper(dedup.DedupConfig(data_shards=2, **kw))
    assert two._group_rows(sum(len(_seg_lengths(x, 8)) for x in lengths)) \
        == 2 * _SEG["stream_rows"]
    sigs = two.signature_many(docs)
    np.testing.assert_array_equal(sigs, one.signature_many(docs))
    for d, sig in zip(docs, sigs):
        np.testing.assert_array_equal(sig, one.signature_unfused(d))


_LAYOUTS = {
    # book-like: every document several blocks long
    "long": ([9 * _SPAN + 5, 4 * _SPAN, 3 * _SPAN - 2, 2 * _SPAN + 1,
              7 * _SPAN, 2 * _SPAN, 5 * _SPAN + 40], True),
    # no document past one block: nothing to cut
    "one_block": ([_SPAN, 40, _SPAN - 1, 3], False),
    # a cut that issues as many launches as the document layout
    "no_fewer_launches": ([_SPAN + 1, _SPAN, _SPAN, _SPAN], False),
}


@pytest.mark.parametrize("case", sorted(_LAYOUTS))
def test_signing_layout_by_launch_count(case):
    """A call signs segments only where they issue fewer chunk launches
    than one row a document, and then exactly the segments' launches (on
    the plain path one dispatch a chunk) and rows."""
    lengths, segmented = _LAYOUTS[case]
    n, Bt = 8, _SEG["stream_rows"]
    seg = [x for N in lengths for x in _seg_lengths(N, n)]
    assert (_launches(seg, Bt) < _launches(lengths, Bt)) == segmented
    rows = seg if segmented else lengths
    dd = dedup.MinHashDeduper(dedup.DedupConfig(vocab=8192, device="cpu",
                                                ngram_n=n, **_SEG))
    docs = [np.arange(x, dtype=np.int32) % 8192 for x in lengths]
    before = (stream.dispatch_count(), dedup.segment_count())
    sigs = dd.signature_many(docs)
    assert stream.dispatch_count() - before[0] == _launches(rows, Bt)
    assert dedup.segment_count() - before[1] == len(rows)
    for d, sig in zip(docs, sigs):
        np.testing.assert_array_equal(sig, dd.signature_unfused(d))


def test_band_packing_round_trip_matches_reference():
    shard = {b"k1": [0, 5], b"zz": [3], b"": [7, 8, 9]}
    packed = dedup.pack_band(shard)
    want = jdedup.pack_band(shard)
    for key in want:
        np.testing.assert_array_equal(packed[key], want[key])
    assert dedup.unpack_band(packed) == shard


def test_unported_options_raise():
    # multi-device signing is ported: two shards sign and flag as one device
    docs, _ = _docs()
    one = dedup.MinHashDeduper(dedup.DedupConfig(device="cpu", vocab=8192))
    two = dedup.MinHashDeduper(dedup.DedupConfig(data_shards=2, device="cpu",
                                                 vocab=8192))
    np.testing.assert_array_equal(two.signature_many(docs[:40]),
                                  one.signature_many(docs[:40]))
    np.testing.assert_array_equal(two.add_batch(docs[:40]),
                                  one.add_batch(docs[:40]))
    # THREEWISE is ported: it signs by the bucketed path, as the reference
    kw = dict(family="threewise", vocab=8192, n_signatures=16, lsh_bands=4)
    ref = jdedup.MinHashDeduper(jdedup.DedupConfig(**kw))
    port = dedup.MinHashDeduper(dedup.DedupConfig(device="cpu", **kw))
    port.import_params(convert.params_from_jax(ref.export_state()["params"],
                                               "cpu"))
    docs, _ = _docs()
    np.testing.assert_array_equal(port.add_batch(docs[:40]),
                                  ref.add_batch(docs[:40]))


def test_deduper_kernel_matches_plain_on_card(cuda):
    docs, _ = _docs()
    kern = dedup.MinHashDeduper(dedup.DedupConfig(vocab=8192, device="cuda",
                                                  impl="kernel"))
    plain = dedup.MinHashDeduper(dedup.DedupConfig(vocab=8192, device="cuda",
                                                   impl="ref"))
    np.testing.assert_array_equal(kern.signature_many(docs[:100]),
                                  plain.signature_many(docs[:100]))
