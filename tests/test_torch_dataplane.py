"""The port's data plane (n-gram statistics, decontamination, DataPlane)
against the JAX package's, with the reference's draws carried across by
``repro_torch.convert``.

* ``NgramStats``: registers, table, token count, ``query_hashes`` and
  ``heavy_hitter_count`` are bit-equal; ``distinct_ngrams`` agrees to rtol
  1e-5 (a float32 sum taken in another order). Chunked
  ``update_stream``/``update_stream_many`` equal the whole-batch update,
  as tests/test_stream.py:330 holds for the reference.
* ``Decontaminator``: the filter, contamination and flags are bit-equal;
  the stream scan equals the whole-batch scan (tests/test_stream.py:361).
* ``DataPlane``: telemetry over 5 steps equals the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import decontam as jdecontam
from repro.data import dedup as jdedup
from repro.data import pipeline as jpipeline
from repro.data import stats as jstats
from repro_torch import convert
from repro_torch.data import decontam, pipeline, stats
from repro_torch.kernels import stream

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

VOCAB = 4096


def _stats_pair(family="cyclic", **kw):
    ref = jstats.NgramStats(jstats.StatsConfig(vocab=VOCAB, family=family,
                                               **kw))
    port = stats.NgramStats(stats.StatsConfig(vocab=VOCAB, family=family,
                                              device="cpu", **kw))
    port.rebind_params(convert.stats_params_from_jax(ref.export_params(),
                                                     "cpu"))
    return ref, port


def _decontam_pair(**kw):
    ref = jdecontam.Decontaminator(jdecontam.DecontamConfig(vocab=VOCAB,
                                                            **kw))
    port = decontam.Decontaminator(decontam.DecontamConfig(
        vocab=VOCAB, device="cpu", **kw))
    params = ref.export_stream(ref.init_stream(1))["params"]
    port.rebind_params(convert.decontam_params_from_jax(params, "cpu"))
    return ref, port


def _toks(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(
        np.uint32)


def _assert_state_equal(got, want):
    np.testing.assert_array_equal(got["hll"].numpy(), np.asarray(want["hll"]))
    np.testing.assert_array_equal(got["cms"].numpy(), np.asarray(want["cms"]))
    assert (stats.NgramStats.token_count(got)
            == jstats.NgramStats.token_count(want))


@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_stats_update_and_queries_match(family):
    ref, port = _stats_pair(family)
    js, ts = ref.init_state(), port.init_state()
    for seed, shape in ((0, (4, 300)), (1, (2, 3, 64))):
        toks = _toks(shape, seed)
        # the reference's update takes (B, S); leading dims flatten alike
        js = ref.update(js, toks.reshape(-1, shape[-1]))
        ts = port.update(ts, toks)
    _assert_state_equal(ts, js)
    assert ts["hll"].dtype == ts["cms"].dtype == torch.int32
    np.testing.assert_allclose(port.distinct_ngrams(ts),
                               ref.distinct_ngrams(js), rtol=1e-5)
    q = _toks((5, 20), 2)
    q[:, :8] = _toks((300,), 0)[:8]              # a window seen in batch 1
    np.testing.assert_array_equal(
        port.query_hashes(q).numpy(),
        np.asarray(ref.query_hashes(jnp.asarray(q))))
    hh = port.heavy_hitter_count(ts, q)
    np.testing.assert_array_equal(hh, ref.heavy_hitter_count(js, q))
    assert (hh >= 1).all()


@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_stats_streaming_equals_whole_batch(family):
    ref, port = _stats_pair(family)
    toks = _toks((4, 384), 3)
    want = port.update(port.init_state(), toks)
    _assert_state_equal(want, ref.update(ref.init_state(), toks))
    ss = port.init_stream(4)
    for c in range(0, 384, 48):
        ss = port.update_stream(ss, toks[:, c : c + 48])
    got = port.finalize_stream(ss)
    ss = port.init_stream(4)
    blocks = toks.reshape(4, 8, 48).transpose(1, 0, 2)
    ss = port.update_stream_many(ss, blocks[:4])
    ss = port.update_stream_many(ss, torch.from_numpy(
        np.ascontiguousarray(blocks[4:])), lengths=np.full((4, 4), 48))
    got_many = port.finalize_stream(ss)
    for g in (got, got_many):
        for k in ("hll", "cms"):
            assert torch.equal(g[k], want[k])
        assert port.token_count(g) == port.token_count(want) == 4 * 384
    # a second stream continues from the finalized state exactly
    toks2 = _toks((4, 128), 4)
    want2 = port.update(want, toks2)
    ss2 = port.update_stream(port.init_stream(4, state=got), toks2)
    got2 = port.finalize_stream(ss2)
    for k in ("hll", "cms"):
        assert torch.equal(got2[k], want2[k])
    _assert_state_equal(got2, ref.update(ref.update(ref.init_state(), toks),
                                         toks2))


def test_token_count_carries_past_2_32():
    _, port = _stats_pair()
    state = port.init_state()
    state["tokens"] = np.array([0xFFFFFFF0, 2], np.uint32)
    state = port.update(state, _toks((2, 16), 5))
    assert state["tokens"].tolist() == [0x10, 3]
    assert port.token_count(state) == (3 << 32) | 0x10


def test_decontam_matches_reference():
    ref, port = _decontam_pair(log2_m=14, max_hit_frac=0.15)
    ev = _toks((4, 64), 4)
    ref.add_eval_set(ev)
    port.add_eval_set(ev)
    assert port.bits.dtype == torch.uint32
    np.testing.assert_array_equal(port.bits.numpy(), np.asarray(ref.bits))
    batch = _toks((5, 256), 5)
    batch[0, :64] = ev[0]                         # planted contamination
    batch[3, 100:164] = ev[2]
    got = port.contamination(batch)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref.contamination(batch))
    np.testing.assert_array_equal(port.flag(batch), ref.flag(batch))
    assert port.flag(batch)[[0, 3]].all() and not port.flag(batch)[1]
    # the stream scan equals the whole-batch scan
    ss = port.init_stream(5)
    assert set(ss["stream"]) == {"tail", "tail_b", "seen", "sketch"}
    for c in range(0, 256, 32):
        ss = port.update_stream(ss, batch[:, c : c + 32])
    np.testing.assert_allclose(port.finalize_stream(ss), got, rtol=1e-6)
    ss = port.init_stream(5)
    ss = port.update_stream_many(
        ss, batch.reshape(5, 8, 32).transpose(1, 0, 2),
        lengths=np.full((8, 5), 32))
    np.testing.assert_allclose(port.finalize_stream(ss), got, rtol=1e-6)


def test_stream_validates_the_second_stream():
    _, port = _decontam_pair(log2_m=10)
    plan, st = port.plan, port.init_stream(2)["stream"]
    chunk = _toks((2, 16), 6)
    ops = {"bloom": {"bits": port.bits}}
    with pytest.raises(ValueError, match="second stream chunk_b"):
        stream.update(plan, st, chunk, operands=ops)
    with pytest.raises(ValueError, match="chunk_b shape"):
        stream.update(plan, st, chunk, chunk_b=chunk[:, :8], operands=ops)


def test_dataplane_telemetry_matches_reference(monkeypatch, tmp_path):
    cfg = dict(seq_len=128, batch_size=4, vocab=VOCAB, seed=1)

    class Carried(pipeline.MinHashDeduper):
        """The corpus deduper, with the reference's draw carried in."""

        def __init__(self, dcfg):
            super().__init__(dcfg)
            jd = jdedup.MinHashDeduper(jdedup.DedupConfig(
                vocab=dcfg.vocab, seed=dcfg.seed, family=dcfg.family))
            self.import_params(convert.params_from_jax(
                jd.export_state()["params"], "cpu"))

    monkeypatch.setattr(pipeline, "MinHashDeduper", Carried)
    jst, tst = _stats_pair()
    jdc, tdc = _decontam_pair()
    jdp = jpipeline.DataPlane(jpipeline.PipelineConfig(**cfg), stats=jst,
                              decontam=jdc)
    tdp = pipeline.DataPlane(pipeline.PipelineConfig(device="cpu", **cfg),
                             stats=tst, decontam=tdc)
    np.testing.assert_array_equal(tdp.corpus.stream, jdp.corpus.stream)
    # step 2's rows are eval rows: they flag and are resampled
    ev = jdp.corpus.batch_for_step(2)
    jdc.add_eval_set(ev)
    tdc.add_eval_set(ev)
    assert tdc.flag(ev).all()
    for step in range(5):
        np.testing.assert_array_equal(tdp.next_batch(step)["tokens"],
                                      jdp.next_batch(step)["tokens"])
    got, want = tdp.telemetry(), jdp.telemetry()
    assert got["tokens_seen"] == want["tokens_seen"] == 5 * 4 * 128
    for k in ("docs_kept", "docs_deduped"):
        assert got[k] == want[k]
    assert got["docs_deduped"] > 0
    np.testing.assert_allclose(got["distinct_ngrams"],
                               want["distinct_ngrams"], rtol=1e-5)
    # the snapshots of both planes hold the same tree
    from repro.data import durable as jdurable
    from repro_torch.data import durable
    tdp.snapshot(str(tmp_path / "port"), 5)
    jdp.snapshot(str(tmp_path / "ref"), 5)
    got_tree, _ = durable.load(str(tmp_path / "port"))
    want_tree, _ = jdurable.load(str(tmp_path / "ref"))
    for part in ("params", "stats"):
        for key, sub in want_tree[part].items():
            if isinstance(sub, dict):
                for k, v in sub.items():
                    np.testing.assert_array_equal(got_tree[part][key][k], v)
            else:
                np.testing.assert_array_equal(got_tree[part][key], sub)
