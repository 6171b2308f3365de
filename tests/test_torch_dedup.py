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


def test_band_packing_round_trip_matches_reference():
    shard = {b"k1": [0, 5], b"zz": [3], b"": [7, 8, 9]}
    packed = dedup.pack_band(shard)
    want = jdedup.pack_band(shard)
    for key in want:
        np.testing.assert_array_equal(packed[key], want[key])
    assert dedup.unpack_band(packed) == shard


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="multi-device"):
        dedup.MinHashDeduper(dedup.DedupConfig(data_shards=2, device="cpu"))
    with pytest.raises(NotImplementedError, match="threewise"):
        dedup.MinHashDeduper(dedup.DedupConfig(family="threewise",
                                               device="cpu"))


def test_deduper_kernel_matches_plain_on_card(cuda):
    docs, _ = _docs()
    kern = dedup.MinHashDeduper(dedup.DedupConfig(vocab=8192, device="cuda",
                                                  impl="kernel"))
    plain = dedup.MinHashDeduper(dedup.DedupConfig(vocab=8192, device="cuda",
                                                   impl="ref"))
    np.testing.assert_array_equal(kern.signature_many(docs[:100]),
                                  plain.signature_many(docs[:100]))
