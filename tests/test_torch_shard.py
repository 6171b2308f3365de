"""repro_torch.kernels.shard (the multi-device layer) against the JAX
package's repro.kernels.shard and against the port's own one-device calls.
Exact everywhere (bit-equal); torch on one CPU thread, inputs from numpy
seeds.

* ``run_sharded`` at d in {1, 2, 4, 8} virtual CPU shards, both families, a
  plan of all four sketches, B in {1, 5, 8} (B = 1 and 5 divide no d > 1:
  padding, whole empty shards): equal to the reference's ``run_sharded``
  at the same d (its 8 virtual CPU devices, tests/conftest.py) and to the
  port's ``api.run``;
* leading dims and default windows; an explicit ``DataMesh``; global
  carries merged exactly once (a CountMin ``init`` is not added d times);
  row sketches need no merge; ``data_mesh`` is cached; the validation
  errors; ``rowwise``;
* dedup, stats and decontam at ``data_shards = d`` equal to one device and
  to the reference at d.

The reference's tests/test_shard.py holds the same cases for the JAX
package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import decontam as jdecontam
from repro.data import dedup as jdedup
from repro.data import stats as jstats
from repro.kernels import plan as jplan
from repro.kernels import shard as jshard
from repro_torch import convert
from repro_torch.data import decontam, dedup, stats
from repro_torch.kernels import api, shard, stream
from repro_torch.kernels import plan as tplan

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


def _sketches(P):
    return (("sig", P.MinHashSpec(k=32)), ("card", P.HLLSpec(b=4)),
            ("dec", P.BloomSpec(k=3, log2_m=14)),
            ("freq", P.CountMinSpec(depth=3, log2_width=8)))


def _plans(family, n=8):
    return (jplan.SketchPlan(jplan.HashSpec(family=family, n=n, L=32),
                             _sketches(jplan)),
            tplan.SketchPlan(tplan.HashSpec(family=family, n=n, L=32),
                             _sketches(tplan)))


def _u32(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _inputs(B, S=300, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=_u32(rng, B, S), xb=_u32(rng, B, S),
        nw=rng.integers(1, S - 8 + 2, size=B).astype(np.int32),
        operands={"sig": {"a": _u32(rng, 32) | 1, "b": _u32(rng, 32)},
                  "dec": {"bits": _u32(rng, 1 << 9)},
                  "freq": {"a": _u32(rng, 3) | 1, "b": _u32(rng, 3)}})


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def _host(out):
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("family", ["cyclic", "general"])
@pytest.mark.parametrize("B", [1, 5, 8])
def test_run_sharded_bit_identical(family, d, B):
    jp, tp = _plans(family)
    a = _inputs(B, seed=7 * B)
    got = _host(shard.run_sharded(tp, a["x"], h1v_b=a["xb"],
                                  n_windows=a["nw"], operands=a["operands"],
                                  data_shards=d, device="cpu"))
    _equal(got, _host(api.run(tp, a["x"], h1v_b=a["xb"], n_windows=a["nw"],
                              operands=a["operands"], device="cpu")))
    want = jshard.run_sharded(jp, jnp.asarray(a["x"]),
                              h1v_b=jnp.asarray(a["xb"]),
                              n_windows=jnp.asarray(a["nw"]),
                              operands=a["operands"], data_shards=d)
    _equal(got, want)


@pytest.mark.parametrize("d", [1, 4])
def test_run_sharded_leading_dims_and_default_windows(d):
    plan = tplan.SketchPlan(tplan.HashSpec(family="cyclic", n=8),
                            (("sig", tplan.MinHashSpec(k=16)),))
    rng = np.random.default_rng(3)
    x = _u32(rng, 2, 3, 200)
    ops = {"sig": {"a": _u32(rng, 16) | 1, "b": _u32(rng, 16)}}
    got = shard.run_sharded(plan, x, operands=ops, data_shards=d,
                            device="cpu")
    assert tuple(got["sig"].shape) == (2, 3, 16)
    assert torch.equal(got["sig"], api.run(plan, x, operands=ops,
                                           device="cpu")["sig"])


def test_run_sharded_explicit_mesh_and_run_auto():
    _, tp = _plans("cyclic")
    a = _inputs(5)
    kw = dict(h1v_b=a["xb"], n_windows=a["nw"], operands=a["operands"])
    want = _host(api.run(tp, a["x"], device="cpu", **kw))
    mesh = shard.DataMesh((torch.device("cpu"),) * 2)
    assert mesh == shard.data_mesh(2, device="cpu") and mesh.size == 2
    _equal(_host(shard.run_sharded(tp, a["x"], mesh=mesh, **kw)), want)
    # run_auto: api.run without a mesh or a count, run_sharded with one
    _equal(_host(shard.run_auto(tp, a["x"], device="cpu", **kw)), want)
    _equal(_host(shard.run_auto(tp, a["x"], mesh=mesh, **kw)), want)
    _equal(_host(shard.run_auto(tp, a["x"], data_shards=3, device="cpu",
                                **kw)), want)


@pytest.mark.parametrize("d", [2, 4])
def test_global_carries_merge_exactly_once(d):
    """A CountMin and an HLL ``init`` are folded in once, after the
    shards' partials merge; MinHash and Bloom carries ride their rows."""
    jp, tp = _plans("general")
    a = _inputs(5, seed=11)
    rng = np.random.default_rng(12)
    ops = {k: dict(v) for k, v in a["operands"].items()}
    ops["freq"]["init"] = rng.integers(0, 1 << 20, (3, 256)).astype(np.int32)
    ops["card"] = {"init": rng.integers(0, 6, 16).astype(np.int32)}
    ops["sig"]["init"] = _u32(rng, 5, 32)
    ops["dec"]["init"] = rng.integers(0, 50, 5).astype(np.int32)
    kw = dict(h1v_b=a["xb"], n_windows=a["nw"], operands=ops)
    got = _host(shard.run_sharded(tp, a["x"], data_shards=d, device="cpu",
                                  **kw))
    _equal(got, _host(api.run(tp, a["x"], device="cpu", **kw)))
    _equal(got, jshard.run_sharded(jp, jnp.asarray(a["x"]), data_shards=d,
                                   **kw))
    # the carry counted once: without it the table is exactly init less
    bare = {k: {o: v for o, v in ops[k].items() if o != "init"}
            for k in ops}
    none = _host(shard.run_sharded(tp, a["x"], h1v_b=a["xb"],
                                   n_windows=a["nw"], operands=bare,
                                   data_shards=d, device="cpu"))
    np.testing.assert_array_equal(got["freq"] - none["freq"],
                                  ops["freq"]["init"])


def test_row_sketches_need_no_merge():
    """MinHash and Bloom rows depend on their own windows only: the sharded
    output is the shards' one-device outputs side by side."""
    plan = tplan.SketchPlan(tplan.HashSpec(family="cyclic", n=8),
                            (("sig", tplan.MinHashSpec(k=8)),
                             ("dec", tplan.BloomSpec(k=3, log2_m=14))))
    rng = np.random.default_rng(0)
    ops = {"sig": {"a": _u32(rng, 8) | 1, "b": _u32(rng, 8)},
           "dec": {"bits": _u32(rng, 1 << 9)}}
    x, xb = _u32(rng, 4, 128), _u32(rng, 4, 128)
    got = shard.run_sharded(plan, x, h1v_b=xb, operands=ops, data_shards=2,
                            device="cpu")
    halves = [api.run(plan, x[r], h1v_b=xb[r], operands=ops, device="cpu")
              for r in (slice(0, 2), slice(2, 4))]
    for name in ("sig", "dec"):
        want = np.concatenate([h[name].numpy() for h in halves])
        np.testing.assert_array_equal(got[name].numpy(), want)


def test_data_mesh_is_cached_per_devices_and_count():
    assert shard.data_mesh(2, device="cpu") is shard.data_mesh(2,
                                                               device="cpu")
    assert shard.data_mesh(device="cpu") is shard.data_mesh(1, device="cpu")
    mesh = shard.data_mesh(3, device="cpu")
    assert mesh.axis_names == ("data",) and mesh.size == 3
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert hash(mesh) == hash(shard.DataMesh(("cpu",) * 3))
    # a CUDA device without an index is the first card
    assert shard.DataMesh(("cuda",)).devices == (torch.device("cuda", 0),)


def test_mesh_validation():
    with pytest.raises(ValueError, match="data_shards"):
        shard.data_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="data_shards"):
        shard.data_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="one type"):
        shard.DataMesh(("cpu", "cuda:0"))
    with pytest.raises(ValueError, match="at least one device"):
        shard.DataMesh(())
    plan = tplan.SketchPlan(tplan.HashSpec(n=8),
                            (("sig", tplan.MinHashSpec(k=8)),))
    rng = np.random.default_rng(0)
    ops = {"sig": {"a": _u32(rng, 8) | 1, "b": _u32(rng, 8)}}
    twod = shard.DataMesh(("cpu", "cpu"), axis_names=("a", "b"))
    with pytest.raises(ValueError, match="1-D data mesh"):
        shard.run_sharded(plan, _u32(rng, 2, 64), operands=ops, mesh=twod)
    with pytest.raises(ValueError, match="1-D data mesh"):
        stream.run_stream(plan, _u32(rng, 2, 64), operands=ops, chunk_s=16,
                          mesh=twod)
    with pytest.raises(ValueError, match="1-D data mesh"):
        shard.rowwise(lambda x: x, twod, 1)
    # the shared validation front end behaves as api.run's: short rows are
    # legal fully masked rows, missing operands raise the same error
    short = shard.run_sharded(plan, _u32(rng, 2, 4), operands=ops,
                              data_shards=1, device="cpu")
    assert (short["sig"].view(torch.int32) == -1).all()
    with pytest.raises(ValueError, match="needs operands"):
        shard.run_sharded(plan, _u32(rng, 2, 64), data_shards=1,
                          device="cpu")


def test_rowwise_splits_rows_and_replicates_the_rest():
    mesh = shard.data_mesh(4, device="cpu")
    seen = []

    def fn(tree, scale, table):
        seen.append(tree["x"].shape[0])
        return {"y": tree["x"] * scale + table[:1]}, tree["n"] + 1

    fn4 = shard.rowwise(fn, mesh, n_row=1)
    x = torch.arange(24).reshape(8, 3)
    table = torch.tensor([5, 6])
    out, n = fn4({"x": x, "n": torch.arange(8)}, 2, table)
    assert seen == [2, 2, 2, 2]
    assert torch.equal(out["y"], x * 2 + 5)
    assert torch.equal(n, torch.arange(8) + 1)
    with pytest.raises(ValueError, match="only 1 argument"):
        fn4({"x": x, "n": torch.arange(8)})
    with pytest.raises(ValueError, match="do not split"):
        fn4({"x": x[:6], "n": torch.arange(6)}, 2, table)


# ---------------------------------------------------------------------------
# services: the data_shards knob changes nothing but the shard count
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_dedup_sharded_matches_single_device_and_reference(d):
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 4096, size=int(s)).astype(np.int32)
            for s in rng.integers(40, 300, size=30)]
    docs.append(docs[4].copy())
    kw = dict(vocab=4096, threshold=0.5, stream_rows=8, stream_chunk_s=64)
    ref = jdedup.MinHashDeduper(jdedup.DedupConfig(data_shards=d, **kw))
    params = convert.params_from_jax(ref.export_state()["params"], "cpu")
    base = dedup.MinHashDeduper(dedup.DedupConfig(device="cpu", **kw))
    sharded = dedup.MinHashDeduper(dedup.DedupConfig(
        device="cpu", data_shards=d, lsh_workers=4, **kw))
    for dd in (base, sharded):
        dd.import_params(params)
    want = ref.add_batch(docs)
    np.testing.assert_array_equal(base.add_batch(docs), want)
    np.testing.assert_array_equal(sharded.add_batch(docs), want)
    assert base._index.shards == sharded._index.shards
    for x, y in zip(sharded._sigs, ref._sigs):
        np.testing.assert_array_equal(x, y)
    sharded.close()


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_stats_sharded_matches_single_device_and_reference(d):
    toks = np.random.default_rng(1).integers(
        0, 1000, size=(5, 256)).astype(np.uint32)
    ref = jstats.NgramStats(jstats.StatsConfig(vocab=1000, data_shards=d))
    params = convert.stats_params_from_jax(ref.export_params(), "cpu")
    want = ref.update(ref.init_state(), toks)
    for shards in (None, d):
        st = stats.NgramStats(stats.StatsConfig(vocab=1000, device="cpu",
                                                data_shards=shards))
        st.rebind_params(params)
        got = st.update(st.init_state(), toks)
        for leg in ("hll", "cms"):
            np.testing.assert_array_equal(got[leg].numpy(),
                                          np.asarray(want[leg]))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_decontam_sharded_matches_single_device_and_reference(d):
    rng = np.random.default_rng(2)
    ev = rng.integers(0, 1000, size=(4, 64)).astype(np.uint32)
    batch = rng.integers(0, 1000, size=(5, 128)).astype(np.uint32)
    batch[1, :64] = ev[0]
    ref = jdecontam.Decontaminator(jdecontam.DecontamConfig(
        vocab=1000, log2_m=14, data_shards=d))
    params = convert.decontam_params_from_jax(
        ref.export_stream(ref.init_stream(1))["params"], "cpu")
    ref.add_eval_set(ev)
    want = ref.contamination(batch)
    assert want[1] > 0
    for shards in (None, d):
        dc = decontam.Decontaminator(decontam.DecontamConfig(
            vocab=1000, log2_m=14, device="cpu", data_shards=shards))
        dc.rebind_params(params)
        dc.add_eval_set(ev)
        np.testing.assert_array_equal(dc.contamination(batch), want)
