"""The port's spans and counters: ``repro_torch.trace.span`` calls nothing
of the profiler while none records; under one, ``add_batch`` and a decontam
block give the span tree of their layers, parents found by containment;
``stream.staged_bytes`` equals a hand count of a dedup group's and of a
scan block's host arrays (a scan block goes over once for both lookups,
under the span ``decontam.lookup``);
``dedup.candidate_count`` equals a hand count on an index with known band
collisions; the seven counters move only in their own context; and on the
card a second block of one
shape captures no graph (``stream.graph_captures``).

The file imports no JAX, so it runs on a machine with a card and no JAX.
"""
import contextvars

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.data import dedup
from repro_torch.data.decontam import DecontamConfig, Decontaminator
from repro_torch.kernels import plan as tplan
from repro_torch.kernels import shard, stream
from repro_torch.serve import sessions

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

# a group of 4 rows in chunks of 16 symbols, 4 chunks to a block
ROWS, CHUNK, BLOCK = 4, 16, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels "
                    "there)")
    return torch.device("cuda")


def _deduper(device="cpu", impl="ref"):
    return dedup.MinHashDeduper(dedup.DedupConfig(
        ngram_n=5, n_signatures=16, lsh_bands=4, threshold=0.5, vocab=1000,
        stream_rows=ROWS, stream_chunk_s=CHUNK, stream_block_chunks=BLOCK,
        impl=impl, device=device))


def _docs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, size=n).astype(np.int32) for n in lengths]


def _decontam(device="cpu", impl="ref"):
    return Decontaminator(DecontamConfig(ngram_n=5, log2_m=12, vocab=1000,
                                         impl=impl, device=device))


def _spans(prof):
    """(name without the prefix, start, end, event) of each span."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            t0 = e.start_ns()
            out.append((e.name()[len(trace.PREFIX):], t0,
                        t0 + e.duration_ns(), e))
    return out


def _parents(spans):
    """name -> the set of names of the innermost span enclosing each of its
    spans (None at the top)."""
    got = {}
    for i, (name, t0, t1, _) in enumerate(spans):
        around = [(b - a, n) for j, (n, a, b, _) in enumerate(spans)
                  if j != i and a <= t0 and t1 <= b and (b - a) > (t1 - t0)]
        got.setdefault(name, set()).add(min(around)[1] if around else None)
    return got


def _raise(*args, **kwargs):
    raise AssertionError("a span entered the profiler while none records")


def test_span_off_is_the_shared_null_context(monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert trace.span("dedup.sign") is trace.span("stream.stage")
    with trace.span("dedup.sign"):
        pass
    # the whole instrumented path, with no profiler recording
    dd = _deduper()
    assert dd.add_batch(_docs([40, 70, 9])).shape == (3,)
    dc = _decontam()
    st = dc.update_stream_many(dc.init_stream(2),
                               _docs([2 * 2 * 8])[0].reshape(2, 2, 8))
    assert dc.finalize_stream(st).shape == (2,)


def test_add_batch_span_tree():
    dd = _deduper()
    # the 100-symbol document signs as two segments of at most one block:
    # five rows in two groups of one block each, one read-back for both
    docs = _docs([100, 60, 33, 4])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dd.add_batch(docs)
    spans = _spans(prof)
    parents = _parents(spans)
    assert parents == {
        "dedup.add_batch": {None},
        "dedup.sign": {"dedup.add_batch"},
        "dedup.tile": {"dedup.sign"},
        # the tokens' staging under the signing, the lengths' under the
        # executor
        "stream.stage": {"dedup.sign", "stream.update_many"},
        "stream.update_many": {"dedup.sign"},
        "dedup.drain": {"dedup.sign"},
        "dedup.probe": {"dedup.add_batch"},
        "dedup.verify": {"dedup.add_batch"},
    }
    count = lambda name: sum(s[0] == name for s in spans)
    assert count("dedup.add_batch") == count("dedup.sign") == 1
    assert count("dedup.tile") == count("stream.update_many") == 2
    assert count("dedup.drain") == 1
    # a span is an operator event: the profiler repeats no annotation of it
    # on a device's timeline
    assert not any(s[3].is_user_annotation() for s in spans)


# the staging of a scan block: one a draw in the plain version, one for
# both draws otherwise
STAGINGS = {"ref": 2, "auto": 1}


@pytest.mark.parametrize("impl", sorted(STAGINGS))
def test_decontam_block_span_tree(impl):
    dc = _decontam(impl=impl)
    T, B, C = 2, 3, 8
    block = _docs([T * B * C])[0].reshape(T, B, C)
    st = dc.init_stream(B)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st = dc.update_stream_many(st, block)
        dc.finalize_stream(st)
    spans = _spans(prof)
    assert _parents(spans) == {
        "decontam.update": {None},
        "decontam.lookup": {"decontam.update"},
        "stream.stage": {"decontam.lookup"},
        "stream.update_many": {"decontam.update"},
        "decontam.finalize": {None},
    }
    assert sum(s[0] == "stream.stage" for s in spans) == STAGINGS[impl]


def _chunks_of(lengths):
    """Chunks the signing path stages for one group: full BLOCK-chunk
    blocks, then one power-of-two tail block."""
    n = max(1, -(-max(lengths) // CHUNK))
    full, rem = divmod(n, BLOCK)
    return full * BLOCK + (1 << int(np.ceil(np.log2(rem))) if rem else 0)


def test_staged_bytes_of_a_dedup_group():
    dd = _deduper()
    # the four longest documents pass one block (64 symbols) and sign as
    # two segments each, the second after 60 symbols (4 of history): three
    # groups of ROWS segments, in 9 chunks where one row a document (the
    # longest four, then the last two) would take 8 + 2
    lengths = [100, 90, 80, 70, 20, 3]
    rows = [64] * 4 + [40, 30, 20, 10, 20, 3]
    per_chunk = 4 * ROWS * CHUNK + 4 * ROWS    # int32 tokens and lengths
    assert _chunks_of(lengths[:4]) + _chunks_of(lengths[4:]) == 8 + 2
    want = per_chunk * (_chunks_of(rows[:4]) + _chunks_of([40, 30, 20, 20])
                        + _chunks_of([10, 3]))
    assert want == per_chunk * (4 + 4 + 1)
    before = stream.staged_bytes()
    dd.signature_many(_docs(lengths))
    assert stream.staged_bytes() - before == want


@pytest.mark.parametrize("impl", sorted(STAGINGS))
def test_staged_bytes_of_a_scan_block(impl):
    dc = _decontam(impl=impl)
    T, B, C = 3, 5, 16
    st = dc.init_stream(B)
    before = stream.staged_bytes()
    dc.update_stream_many(st, _docs([T * B * C])[0].reshape(T, B, C))
    # int32 tokens for each staging, and no lengths
    assert stream.staged_bytes() - before == STAGINGS[impl] * 4 * T * B * C


# the port's seven context-local counters, by their public getters
COUNTERS = {"stream.dispatch_count": stream.dispatch_count,
            "stream.staged_bytes": stream.staged_bytes,
            "stream.graph_captures": stream.graph_captures,
            "dedup.candidate_count": dedup.candidate_count,
            "dedup.segment_count": dedup.segment_count,
            "sessions.dispatch_count": sessions.dispatch_count,
            "shard.merge_count": shard.merge_count}


@pytest.mark.parametrize("impl", sorted(STAGINGS))
def test_counters_are_context_local(impl):
    """Work run in a copied context moves every counter there, and none
    outside it."""
    dc = _decontam(impl=impl)
    st = dc.init_stream(2)
    block = _docs([16])[0].reshape(1, 2, 8)
    hll = tplan.SketchPlan(tplan.HashSpec(family="cyclic", n=5),
                           (("hll", tplan.HLLSpec(b=4)),))
    index = dedup.BandShardedLSHIndex(n_bands=2)
    index.insert(0, [k.tobytes() for k in _keys([[1, 2]])[0]])
    pool = sessions.SessionPool(tplan.DecodeSpec(n=2, log2_m=6), 2,
                                np.arange(16, dtype=np.uint32),
                                device="cpu")
    dd = _deduper()

    def work():
        dc.update_stream_many(st, block)
        # one row of one chunk
        dd.signature_many(_docs([9]))
        shard.run_sharded(hll, _docs([2 * 16], 1)[0].reshape(2, 16),
                          mesh=shard.data_mesh(2, "cpu"))
        index.probe_batch(_keys([[1, 5], [1, 9]]))
        pool.admit()
        # a capture needs a card: on the CPU, the counter's own bump
        stream._captures.add()
        return {name: get() for name, get in COUNTERS.items()}

    before = {name: get() for name, get in COUNTERS.items()}
    inner = contextvars.copy_context().run(work)
    # the signing's tokens and lengths: (1, ROWS, CHUNK) and (1, ROWS)
    assert inner["stream.staged_bytes"] == (
        before["stream.staged_bytes"] + STAGINGS[impl] * 4 * 16
        + 4 * ROWS * CHUNK + 4 * ROWS)
    # two update_many of one chunk on the plain path
    assert inner["stream.dispatch_count"] == (
        before["stream.dispatch_count"] + 2)
    assert inner["dedup.segment_count"] == (
        before["dedup.segment_count"] + 1)
    assert inner["stream.graph_captures"] == (
        before["stream.graph_captures"] + 1)
    # two from the index, one from the batch's earlier row
    assert inner["dedup.candidate_count"] == (
        before["dedup.candidate_count"] + 3)
    assert inner["sessions.dispatch_count"] == (
        before["sessions.dispatch_count"] + 1)
    merges = before["shard.merge_count"]
    assert inner["shard.merge_count"] == {
        **merges, "maximum": merges.get("maximum", 0) + 1}
    assert {name: get() for name, get in COUNTERS.items()} == before


@pytest.mark.parametrize("many", [True, False])
def test_decontam_lookup_span_nests_in_update(many):
    """The two gathers run on the one staged block inside the span
    ``decontam.lookup``, which sits inside ``decontam.update``, once a
    call, with the staging inside it."""
    dc = _decontam(impl="auto")
    T, B, C = 2, 3, 8
    block = _docs([T * B * C])[0].reshape(T, B, C)
    st = dc.init_stream(B)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if many:
            dc.update_stream_many(st, block)
        else:
            dc.update_stream(st, block[0])
    spans = _spans(prof)
    assert _parents(spans)["stream.stage"] == {"decontam.lookup"}
    assert sum(s[0] == "stream.stage" for s in spans) == 1
    assert _parents(spans)["decontam.lookup"] == {"decontam.update"}
    assert sum(s[0] == "decontam.lookup" for s in spans) == 1


def _keys(rows):
    """(D, bands) uint32 band keys -> void keys, as ``_band_keys`` gives."""
    a = np.ascontiguousarray(np.asarray(rows, np.uint32)[..., None])
    return a.view(np.dtype((np.void, 4)))[..., 0]


def test_candidate_count_by_hand():
    index = dedup.BandShardedLSHIndex(n_bands=2)
    stored = _keys([[1, 2], [1, 3], [4, 5]])
    for doc_id, row in zip((10, 11, 12), stored):
        index.insert(doc_id, [k.tobytes() for k in row])
    batch = _keys([[1, 5],     # index: 10, 11 (band 0), 12 (band 1)
                   [1, 9],     # index: 10, 11; batch: 0 (band 0)
                   [7, 5],     # index: 12; batch: 0 (band 1)
                   [1, 5]])    # index: 10, 11, 12; batch: 0, 1, 2
    before = dedup.candidate_count()
    index_cand, batch_cand = index.probe_batch(batch)
    assert [sorted(c) for c in index_cand] == [[10, 11, 12], [10, 11], [12],
                                               [10, 11, 12]]
    assert [sorted(c) for c in batch_cand] == [[], [0], [0], [0, 1, 2]]
    assert dedup.candidate_count() - before == (3 + 2 + 1 + 3) + (0 + 1 + 1
                                                                  + 3)


def test_second_block_of_a_shape_captures_no_graph(cuda):
    plan = tplan.SketchPlan(tplan.HashSpec(family="cyclic", n=5, L=32),
                            (("sig", tplan.MinHashSpec(k=16)),))
    rng = np.random.default_rng(3)
    ops = {"sig": {"a": torch.from_numpy(
        rng.integers(0, 1 << 32, 16, dtype=np.uint32) | 1).to(cuda),
                   "b": torch.from_numpy(
        rng.integers(0, 1 << 32, 16, dtype=np.uint32)).to(cuda)}}
    T, B, C = 3, 8, 64
    chunks = torch.from_numpy(rng.integers(0, 1 << 32, (T, B, C),
                                           dtype=np.uint32)).to(cuda)
    lengths = np.full((T, B), C, np.int32)
    state = stream.init_state(plan, B, device=cuda)
    state = stream.update_many(plan, state, chunks, lengths=lengths,
                               operands=ops)
    captures, staged = stream.graph_captures(), stream.staged_bytes()
    stream.update_many(plan, state, chunks, lengths=lengths, operands=ops)
    torch.cuda.synchronize(cuda)
    assert stream.graph_captures() == captures
    # the host lengths go over through pinned memory, and nothing else
    assert stream.staged_bytes() - staged == 4 * T * B
