"""repro_torch.kernels.stream over a data mesh, against the JAX package's
sharded streams (tests/test_stream_sharded.py, test_stream_scan.py's
sharded scan, test_durable.py's elastic restores) and the port's own
one-device calls. Exact everywhere (bit-equal); torch on one CPU thread,
inputs from numpy seeds, d virtual CPU shards (the reference's 8 virtual
CPU devices, tests/conftest.py).

* ``run_stream`` with each executor (host, grid, scan) at d in {1, 2, 4,
  8}, B in {1, 5, 8} (padding rows never submit a symbol), both families:
  equal to one-shot ``api.run`` and to the reference's sharded
  ``run_stream`` at the same d; a sharded call counts the dispatches of
  the same call without a mesh.
* Elastic ``import_state``: a stream exported at one shard count resumes
  at another, from either package into either package.
* The durable stats and decontam snapshots saved at one d and restored at
  another give the uninterrupted run's bits.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import durable as jdurable
from repro.data import stats as jstats
from repro.kernels import api as japi
from repro.kernels import plan as jplan
from repro.kernels import stream as jstream
from repro_torch import convert
from repro_torch.data import decontam, durable, stats
from repro_torch.kernels import api, shard, stream
from repro_torch.kernels import plan as tplan

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


def _sketches(P):
    return (("sig", P.MinHashSpec(k=16)), ("card", P.HLLSpec(b=4)),
            ("dec", P.BloomSpec(k=3, log2_m=14)),
            ("freq", P.CountMinSpec(depth=3, log2_width=8)))


def _plans(family, n=8):
    return (jplan.SketchPlan(jplan.HashSpec(family=family, n=n, L=32),
                             _sketches(jplan)),
            tplan.SketchPlan(tplan.HashSpec(family=family, n=n, L=32),
                             _sketches(tplan)))


def _u32(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    return {"sig": {"a": _u32(rng, 16) | 1, "b": _u32(rng, 16)},
            "dec": {"bits": _u32(rng, 1 << 9)},
            "freq": {"a": _u32(rng, 3) | 1, "b": _u32(rng, 3)}}


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("family", ["cyclic", "general"])
@pytest.mark.parametrize("B", [1, 5, 8])
def test_sharded_streaming_bit_identical(family, d, B):
    jp, tp = _plans(family)
    S = 300
    rng = np.random.default_rng(B)
    x, xb = _u32(rng, B, S), _u32(rng, B, S)
    ops = _operands()
    nw = rng.integers(0, S - 8 + 2, size=B).astype(np.int32)
    want = api.run(tp, x, h1v_b=xb, n_windows=nw, operands=ops, device="cpu")
    ref = jstream.run_stream(jp, jnp.asarray(x), chunk_s=64,
                             h1v_b=jnp.asarray(xb), n_windows=jnp.asarray(nw),
                             operands=ops, data_shards=d)
    _equal(want, ref)
    for executor in ("host", "grid", "scan"):
        before = stream.dispatch_count()
        got = stream.run_stream(tp, x, h1v_b=xb, n_windows=nw, operands=ops,
                                chunk_s=64, executor=executor,
                                data_shards=d, device="cpu")
        # the CPU's scan block is its eager loop: one dispatch a chunk, as
        # without a mesh (test_torch_stream_exec.py)
        assert stream.dispatch_count() - before == (
            1 if executor == "grid" else 5), executor
        _equal(got, ref)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_scan_executor_sharded_bit_identical(d):
    """test_stream_scan.py's case: six rows, some idle or one window long,
    at no multiple of 4 or 8."""
    jp = jplan.SketchPlan(jplan.HashSpec(family="cyclic", n=8),
                          (("sig", jplan.MinHashSpec(k=16)),
                           ("card", jplan.HLLSpec(b=4))))
    tp = tplan.SketchPlan(tplan.HashSpec(family="cyclic", n=8),
                          (("sig", tplan.MinHashSpec(k=16)),
                           ("card", tplan.HLLSpec(b=4))))
    rng = np.random.default_rng(1)
    ops = {"sig": {"a": _u32(rng, 16) | 1, "b": _u32(rng, 16)}}
    B, S = 6, 300
    x = _u32(rng, B, S)
    nw = np.array([0, 5, 100, S - 7, 1, 42], np.int32)
    want = japi.run(jp, jnp.asarray(x), n_windows=jnp.asarray(nw),
                    operands=ops)
    got = stream.run_stream(tp, x, chunk_s=64, n_windows=nw, operands=ops,
                            executor="scan", data_shards=d, device="cpu")
    _equal(got, want)


def test_sharded_updates_pad_rows_and_check_the_mesh():
    """A sharded carry takes chunks of fewer rows than its padded batch
    (the rest idle), refuses more, and refuses an update on another
    mesh; ``update_many`` and ``feed`` equal the per-chunk updates."""
    _, tp = _plans("cyclic", n=5)
    ops = _operands(3)
    rng = np.random.default_rng(4)
    chunks, chunks_b = _u32(rng, 3, 5, 16), _u32(rng, 3, 5, 16)
    lens = rng.integers(0, 17, size=(3, 5)).astype(np.int32)
    mesh = shard.data_mesh(4, device="cpu")
    one = stream.init_state(tp, 5, device="cpu")
    many = stream.init_state(tp, 5, device="cpu", mesh=mesh)
    assert stream.state_batch(tp, many) == 8
    fed = stream.feed(tp, [(chunks[:2], lens[:2], chunks_b[:2]),
                           (chunks[2:], lens[2:], chunks_b[2:])],
                      stream.init_state(tp, 5, device="cpu", data_shards=4),
                      operands=ops, mesh=mesh)
    for t in range(3):
        one = stream.update(tp, one, chunks[t], chunk_b=chunks_b[t],
                            lengths=lens[t], operands=ops)
        many = stream.update(tp, many, chunks[t], chunk_b=chunks_b[t],
                             lengths=lens[t], operands=ops, mesh=mesh)
    block = stream.update_many(tp, stream.init_state(tp, 5, device="cpu",
                                                     mesh=mesh),
                               chunks, chunk_b=chunks_b, lengths=lens,
                               operands=ops)
    want = stream.finalize(tp, one)
    for st in (many, block, fed):
        _equal(stream.finalize(tp, st, batch=5), {k: v.numpy()
                                                  for k, v in want.items()})
        exported = stream.export_state(tp, st, batch=5)
        _equal(exported["sketch"], stream.export_state(tp, one)["sketch"])
    with pytest.raises(ValueError, match="chunk rows 9 > stream state"):
        stream.update(tp, many, _u32(rng, 9, 16), chunk_b=_u32(rng, 9, 16),
                      operands=ops)
    with pytest.raises(ValueError, match="laid out on"):
        stream.update(tp, many, chunks[0], chunk_b=chunks_b[0],
                      operands=ops, data_shards=2)
    with pytest.raises(ValueError, match="laid out on"):
        stream.update(tp, one, chunks[0], chunk_b=chunks_b[0],
                      operands=ops, mesh=mesh)


@pytest.mark.parametrize("d_save,d_load", [(4, 1), (4, 2), (1, 4), (2, 8)])
@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
def test_elastic_import_state_across_packages(d_save, d_load, direction):
    """Half a stream at ``d_save`` shards in one package, exported,
    imported at ``d_load`` into the other, the rest there: the carry of an
    uninterrupted one-device run."""
    jp, tp = _plans("general", n=5)
    ops = _operands(5)
    rng = np.random.default_rng(6)
    B = 5
    chunks, chunks_b = _u32(rng, 4, B, 24), _u32(rng, 4, B, 24)
    lens = rng.integers(0, 25, size=(4, B)).astype(np.int32)
    whole = stream.update_many(tp, stream.init_state(tp, B, device="cpu"),
                               chunks, chunk_b=chunks_b, lengths=lens,
                               operands=ops)
    want = stream.export_state(tp, whole)
    if direction == "port->ref":
        st = stream.update_many(
            tp, stream.init_state(tp, B, device="cpu", data_shards=d_save),
            chunks[:2], chunk_b=chunks_b[:2], lengths=lens[:2],
            operands=ops)
        tree = stream.export_state(tp, st, batch=B)
        js = jstream.import_state(jp, tree, data_shards=d_load)
        js = jstream.update_many(jp, js, jnp.asarray(chunks[2:]),
                                 chunk_b=jnp.asarray(chunks_b[2:]),
                                 lengths=jnp.asarray(lens[2:]),
                                 operands=ops, data_shards=d_load)
        got = jstream.export_state(jp, js, batch=B)
    else:
        js = jstream.init_state(jp, B, data_shards=d_save)
        js = jstream.update_many(jp, js, jnp.asarray(chunks[:2]),
                                 chunk_b=jnp.asarray(chunks_b[:2]),
                                 lengths=jnp.asarray(lens[:2]),
                                 operands=ops, data_shards=d_save)
        tree = jstream.export_state(jp, js, batch=B)
        st = stream.import_state(tp, tree, device="cpu", data_shards=d_load)
        assert stream.state_batch(tp, st) == B + (-B % d_load)
        st = stream.update_many(tp, st, chunks[2:], chunk_b=chunks_b[2:],
                                lengths=lens[2:], operands=ops)
        got = stream.export_state(tp, st, batch=B)
    for key in ("tail", "tail_b", "seen"):
        np.testing.assert_array_equal(np.asarray(got[key]), want[key],
                                      err_msg=key)
    _equal(got["sketch"], want["sketch"])


def _chunks(B, n_chunks, C, seed=0, vocab=4096):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(n_chunks, B, C)).astype(np.uint32)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_stats_stream_resume_bit_identical(tmp_path, family, d):
    """A stats stream at d shards killed at a chunk boundary, restored into
    an instance of another seed, the tail replayed: registers, table and
    token count of the uninterrupted run (the reference's, at d too)."""
    cfg = stats.StatsConfig(vocab=4096, family=family, data_shards=d,
                            device="cpu")
    toks = _chunks(3, 4, 64, seed=d)            # B = 3 divides no d > 1
    ref = jstats.NgramStats(jstats.StatsConfig(vocab=4096, family=family,
                                               data_shards=d))
    params = convert.stats_params_from_jax(ref.export_params(), "cpu")
    jss = ref.init_stream(3)
    for c in toks:
        jss = ref.update_stream(jss, c)
    want = ref.finalize_stream(jss)
    st1 = stats.NgramStats(cfg)
    st1.rebind_params(params)
    ss1 = st1.init_stream(3)
    for c in toks[:2]:
        ss1 = st1.update_stream(ss1, c)
    durable.save_stats_stream(st1, ss1, str(tmp_path), epoch=2)
    st2 = stats.NgramStats(dataclasses.replace(cfg, seed=cfg.seed + 99))
    ss2, epoch = durable.restore_stats_stream(st2, str(tmp_path))
    assert epoch == 2
    for c in toks[2:]:
        ss2 = st2.update_stream(ss2, c)
    got = st2.finalize_stream(ss2)
    for k in ("hll", "cms", "tokens"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("d_save,d_load", [(1, 4), (4, 1), (2, 8), (4, 2)])
def test_stats_stream_elastic_restore_across_shard_counts(tmp_path, d_save,
                                                          d_load):
    """A snapshot written at one shard count restores onto another, with
    ``update_stream_many`` blocks; the reference restores the port's
    snapshot at ``d_load`` too."""
    toks = _chunks(5, 4, 64, seed=7)
    base = stats.NgramStats(stats.StatsConfig(vocab=4096, device="cpu"))
    ss = base.update_stream_many(base.init_stream(5), toks)
    want = base.finalize_stream(ss)
    st1 = stats.NgramStats(stats.StatsConfig(vocab=4096, device="cpu",
                                             data_shards=d_save))
    st1.rebind_params(base.export_params())
    ss1 = st1.update_stream_many(st1.init_stream(5), toks[:2])
    durable.save_stats_stream(st1, ss1, str(tmp_path), epoch=2)
    st2 = stats.NgramStats(stats.StatsConfig(vocab=4096, seed=123,
                                             device="cpu",
                                             data_shards=d_load))
    ss2, _ = durable.restore_stats_stream(st2, str(tmp_path))
    got = st2.finalize_stream(st2.update_stream_many(ss2, toks[2:]))
    ref = jstats.NgramStats(jstats.StatsConfig(vocab=4096, seed=5,
                                               data_shards=d_load))
    jss, _ = jdurable.restore_stats_stream(ref, str(tmp_path))
    for c in toks[2:]:
        jss = ref.update_stream(jss, c)
    jgot = ref.finalize_stream(jss)
    for k in ("hll", "cms", "tokens"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(jgot[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("d_save,d_load", [(1, 2), (2, 1), (4, 4)])
def test_decontam_stream_resume_across_shard_counts(tmp_path, d_save,
                                                    d_load):
    """The Bloom leg: the restored scan carries the filter and both family
    draws, so resumed hit fractions equal the uninterrupted run's."""
    rng = np.random.default_rng(3)
    evalset = rng.integers(0, 4096, size=(4, 160)).astype(np.uint32)
    batch = rng.integers(0, 4096, size=(5, 128)).astype(np.uint32)
    batch[0, :] = evalset[0, :128]            # a fully contaminated row
    batch[1, 40:] = evalset[1, : 128 - 40]    # a partly contaminated row
    cfg = decontam.DecontamConfig(vocab=4096, log2_m=14, device="cpu",
                                  data_shards=d_save)
    dc = decontam.Decontaminator(cfg)
    dc.add_eval_set(evalset)
    ss = dc.init_stream(5)
    for c in range(0, 128, 32):
        ss = dc.update_stream(ss, batch[:, c:c + 32])
    want = dc.finalize_stream(ss)
    dc1 = decontam.Decontaminator(cfg)
    dc1.add_eval_set(evalset)
    ss1 = dc1.init_stream(5)
    for c in range(0, 64, 32):
        ss1 = dc1.update_stream(ss1, batch[:, c:c + 32])
    durable.save_decontam_stream(dc1, ss1, str(tmp_path), epoch=2)
    # another seed and no eval set: both come back from the snapshot
    dc2 = decontam.Decontaminator(dataclasses.replace(
        cfg, seed=cfg.seed + 99, data_shards=d_load))
    ss2, _ = durable.restore_decontam_stream(dc2, str(tmp_path))
    ss2 = dc2.update_stream_many(
        ss2, np.stack([batch[:, c:c + 32] for c in range(64, 128, 32)]))
    got = dc2.finalize_stream(ss2)
    np.testing.assert_array_equal(got, want)
    assert got[0] > cfg.max_hit_frac
    base = decontam.Decontaminator(dataclasses.replace(cfg, data_shards=None))
    base.add_eval_set(evalset)
    np.testing.assert_array_equal(
        base.finalize_stream(base.update_stream(base.init_stream(5), batch)),
        want)


def test_sharded_dedup_streaming_flags():
    """Signing at 4 shards with a per-shard tile of 8 rows (a group of 32
    documents): the one-device flags and signatures."""
    from repro_torch.data import dedup
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 4096, size=int(n)).astype(np.int32)
            for n in rng.integers(20, 500, size=40)]
    docs.append(docs[2].copy())
    kw = dict(vocab=4096, stream_rows=8, stream_chunk_s=128, device="cpu")
    with dedup.MinHashDeduper(dedup.DedupConfig(**kw)) as base, \
         dedup.MinHashDeduper(dedup.DedupConfig(data_shards=4,
                                                **kw)) as sharded:
        np.testing.assert_array_equal(sharded.signature_many(docs),
                                      base.signature_many(docs))
        flags = sharded.add_batch(docs)
        np.testing.assert_array_equal(flags, base.add_batch(docs))
        assert flags[-1]
