"""The unfused data paths — the families outside the fused engine
(THREEWISE, ID37; BUFFERED-GENERAL in the stats) — against the JAX
package, with the reference's draws carried across. Exact everywhere.

* ``MinHashDeduper`` signs THREEWISE and ID37 through the bucketed path:
  ``signature_many``, ``signature_unfused``, ``add_batch`` flags and the
  module's ``signature_batch`` / ``signature_batch_fused`` equal the
  reference's (tests/test_plan_api.py:307, test_sketch_fused.py:101-107).
* ``exact_duplicate_mask`` equals the reference's with its k=4 draw
  carried in, for the fused and the unfused families.
* ``NgramStats`` on the unfused path: registers, table, token count,
  estimates and heavy-hitter counts equal the reference's; the stream API
  refuses an unfused family, as the reference does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import dedup as jdedup
from repro.data import stats as jstats
from repro_torch import convert
from repro_torch.data import dedup, stats

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

VOCAB = 500


def _dedup_pair(family, **kw):
    cfg = dict(family=family, ngram_n=4, n_signatures=16, lsh_bands=4,
               vocab=VOCAB, threshold=0.6, **kw)
    ref = jdedup.MinHashDeduper(jdedup.DedupConfig(**cfg))
    port = dedup.MinHashDeduper(dedup.DedupConfig(device="cpu", **cfg))
    port.import_params(convert.params_from_jax(ref.export_state()["params"],
                                               "cpu"))
    return ref, port


def _docs(n, seed, lo=1, hi=90):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, VOCAB, size=int(m)).astype(np.int32)
            for m in rng.integers(lo, hi, size=n)]
    for i in range(5, n, 5):
        docs[i] = docs[i - 3].copy()
    return docs


@pytest.mark.parametrize("family", ["threewise", "id37"])
def test_unfused_signing_matches_reference(family):
    ref, port = _dedup_pair(family)
    assert port.plan is None
    # lengths from below the window (sentinel signatures) to three buckets
    docs = _docs(14, 1)
    np.testing.assert_array_equal(port.signature_many(docs),
                                  ref.signature_many(docs))
    for d in docs[:4]:
        np.testing.assert_array_equal(port.signature_unfused(d),
                                      np.asarray(ref.signature_unfused(d)))
    np.testing.assert_array_equal(port.add_batch(docs), ref.add_batch(docs))
    toks = np.random.default_rng(2).integers(0, VOCAB, (5, 24)).astype(
        np.uint32)
    want = jdedup.signature_batch(ref.fam, ref.fam_params, ref.mh,
                                  ref.mh_params, jnp.asarray(toks))
    for fn in (dedup.signature_batch, dedup.signature_batch_fused):
        got = fn(port.fam, port.fam_params, port.mh, port.mh_params, toks)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", ["cyclic", "general", "threewise",
                                    "id37"])
def test_exact_duplicate_mask_matches_reference(family):
    ref, port = _dedup_pair(family)
    toks = np.random.default_rng(3).integers(0, VOCAB, (7, 20)).astype(
        np.uint32)
    toks[3] = toks[1]
    toks[6] = toks[1]
    toks[5] = toks[0]
    want = jdedup.exact_duplicate_mask(ref.fam, ref.fam_params,
                                       jnp.asarray(toks))
    mh = {k: torch.from_numpy(np.array(v))
          for k, v in jdedup._exact_mh_params().items()}
    got = dedup.exact_duplicate_mask(port.fam, port.fam_params, toks,
                                     mh_params=mh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [False, False, False, True, False, True, True]
    # its own draw finds the same duplicates
    np.testing.assert_array_equal(
        dedup.exact_duplicate_mask(port.fam, port.fam_params, toks).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("family", ["threewise", "id37", "buffered_general"])
def test_unfused_stats_match_reference(family):
    cfg = dict(family=family, ngram_n=4, vocab=VOCAB, hll_b=6,
               cms_log2_width=8)
    ref = jstats.NgramStats(jstats.StatsConfig(**cfg))
    port = stats.NgramStats(stats.StatsConfig(device="cpu", seed=3, **cfg))
    port.rebind_params(ref.export_params())
    assert port.plan is None
    rng = np.random.default_rng(4)
    js, ts = ref.init_state(), port.init_state()
    for _ in range(3):
        t = rng.integers(0, VOCAB, (4, 30)).astype(np.int32)
        js, ts = ref.update(js, t), port.update(ts, t)
    np.testing.assert_array_equal(ts["hll"].numpy(), np.asarray(js["hll"]))
    np.testing.assert_array_equal(ts["cms"].numpy(), np.asarray(js["cms"]))
    assert port.token_count(ts) == ref.token_count(js) == 360
    np.testing.assert_allclose(port.distinct_ngrams(ts),
                               ref.distinct_ngrams(js), rtol=1e-5)
    q = rng.integers(0, VOCAB, (3, 10)).astype(np.int32)
    np.testing.assert_array_equal(port.query_hashes(q).numpy(),
                                  np.asarray(ref.query_hashes(
                                      jnp.asarray(q, jnp.uint32))))
    np.testing.assert_array_equal(port.heavy_hitter_count(ts, q),
                                  ref.heavy_hitter_count(js, q))
    with pytest.raises(ValueError, match="fused family"):
        port.init_stream(2)
