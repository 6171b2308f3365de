"""repro_torch.kernels.stream: ``run_stream``'s three executors and the
carry's export and import, against the JAX package. Exact everywhere.

* ``run_stream`` with ``executor`` in {host, grid, scan} equals the
  reference's ``run_stream`` and one-shot ``api.run``, bit for bit, for
  both families and a plan of all four sketches, down to ``chunk_s = n``,
  with ragged tails, idle rows and pinned ``n_chunks`` (the reference's
  tests/test_stream.py and test_stream_scan.py cases).
* ``dispatch_count``: one a chunk for ``host``, one a stream for ``grid``
  (tests/test_stream_scan.py:142); ``scan`` is one a chunk here, where
  its block runs eagerly, and one a stream on a card.
* A reference ``export_state`` tree imports into the port and continues
  bit-identically, and the reverse; ``import_state`` refuses a tree of
  another plan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels import plan as jplan
from repro.kernels import stream as jstream
from repro_torch.kernels import shard, stream
from repro_torch.kernels import plan as tplan

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


def _sketches(P):
    return (("sig", P.MinHashSpec(k=8)), ("hll", P.HLLSpec(b=6)),
            ("cms", P.CountMinSpec(depth=2, log2_width=8)),
            ("bl", P.BloomSpec(k=3, log2_m=12)))


def _plans(family, n):
    return (jplan.SketchPlan(jplan.HashSpec(family=family, n=n),
                             _sketches(jplan)),
            tplan.SketchPlan(tplan.HashSpec(family=family, n=n),
                             _sketches(tplan)))


def _ops(seed=0):
    rng = np.random.default_rng(seed)
    u = lambda k: rng.integers(0, 1 << 32, size=k, dtype=np.uint32)
    return {"sig": {"a": u(8) | 1, "b": u(8)},
            "cms": {"a": u(2) | 1, "b": u(2)},
            "bl": {"bits": u(128)}}


def _x(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                                dtype=np.uint32)


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("family", ["cyclic", "general"])
@pytest.mark.parametrize("executor", ["host", "grid", "scan"])
def test_run_stream_matches_reference(family, executor):
    n = 5
    jp, tp = _plans(family, n)
    ops = _ops(1)
    x, xb = _x((3, 37), 2), _x((3, 37), 3)
    # row 1 idle, row 2 ends early: a ragged stream
    nw = np.array([33, 0, 10])
    want = japi.run(jp, jnp.asarray(x), h1v_b=jnp.asarray(xb), n_windows=nw,
                    operands=ops)
    for chunk_s, n_chunks in ((n, None), (8, None), (8, 9), (64, None)):
        got = stream.run_stream(tp, x, h1v_b=xb, n_windows=nw, operands=ops,
                                chunk_s=chunk_s, executor=executor,
                                n_chunks=n_chunks, device="cpu")
        _equal(got, want)
    ref = jstream.run_stream(jp, jnp.asarray(x), h1v_b=jnp.asarray(xb),
                             n_windows=nw, operands=ops, chunk_s=8,
                             executor="host")
    _equal(stream.run_stream(tp, x, h1v_b=xb, n_windows=nw, operands=ops,
                             chunk_s=8, executor=executor, device="cpu"), ref)


def test_run_stream_short_rows_and_leading_dims():
    jp, tp = _plans("cyclic", 6)
    ops = _ops(4)
    # rows shorter than the window sign to the sentinel, as one shot does
    x, xb = _x((2, 3, 4), 5), _x((2, 3, 4), 6)
    want = japi.run(jp, jnp.asarray(x), h1v_b=jnp.asarray(xb), operands=ops)
    for executor in ("host", "grid", "scan"):
        got = stream.run_stream(tp, x, h1v_b=xb, operands=ops, chunk_s=3,
                                executor=executor, device="cpu")
        assert tuple(got["sig"].shape) == (2, 3, 8)
        _equal(got, want)


def test_dispatch_count_per_executor():
    _, tp = _plans("cyclic", 4)
    ops = _ops(7)
    x, xb = _x((2, 50), 8), _x((2, 50), 9)
    # on the CPU the scan's block runs its chunk loop eagerly, one dispatch
    # a chunk; on a card it is one graph replay (tests/test_torch_on_card.py)
    for executor, want in (("host", 7), ("grid", 1), ("scan", 7)):
        before = stream.dispatch_count()
        stream.run_stream(tp, x, h1v_b=xb, operands=ops, chunk_s=8,
                          executor=executor, device="cpu")
        assert stream.dispatch_count() - before == want, executor


def test_run_stream_validation():
    _, tp = _plans("cyclic", 4)
    ops = _ops(10)
    x = _x((2, 20), 11)
    with pytest.raises(ValueError, match="unknown executor"):
        stream.run_stream(tp, x, h1v_b=x, operands=ops, chunk_s=4,
                          executor="loop", device="cpu")
    with pytest.raises(ValueError, match="chunk_s must be >= 1"):
        stream.run_stream(tp, x, h1v_b=x, operands=ops, chunk_s=0,
                          device="cpu")
    with pytest.raises(ValueError, match="n_chunks=2 < ceil"):
        stream.run_stream(tp, x, h1v_b=x, operands=ops, chunk_s=4,
                          n_chunks=2, device="cpu")
    with pytest.raises(ValueError, match="do not pass 'init'"):
        stream.run_stream(tp, x, h1v_b=x, chunk_s=4, device="cpu",
                          operands={**ops, "hll": {"init": np.zeros(64)}})
    with pytest.raises(ValueError, match="second stream h1v_b"):
        stream.run_stream(tp, x, operands=ops, chunk_s=4, device="cpu")
    # the sharded stream is ported: two shards give the one-device bits
    want = stream.run_stream(tp, x, h1v_b=x, operands=ops, chunk_s=4,
                             device="cpu")
    _equal(stream.run_stream(tp, x, h1v_b=x, operands=ops, chunk_s=4,
                             data_shards=2, device="cpu"),
           {k: v.numpy() for k, v in want.items()})


@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_state_crosses_both_ways(family):
    """Half a stream in one package, exported, imported into the other,
    the rest there: both finish with the carry of an uninterrupted run."""
    n = 4
    jp, tp = _plans(family, n)
    ops = _ops(12)
    B, C = 3, 6
    chunks, chunks_b = _x((4, B, C), 13), _x((4, B, C), 14)
    lens = np.array([[6, 6, 2], [6, 0, 6], [3, 6, 6], [6, 6, 0]], np.int32)

    def ref_run(st, ts):
        for t in ts:
            st = jstream.update(jp, st, jnp.asarray(chunks[t]),
                                chunk_b=jnp.asarray(chunks_b[t]),
                                lengths=lens[t], operands=ops, donate=False)
        return st

    def port_run(st, ts):
        for t in ts:
            st = stream.update(tp, st, chunks[t], chunk_b=chunks_b[t],
                               lengths=lens[t], operands=ops)
        return st

    whole = jstream.export_state(jp, ref_run(jstream.init_state(jp, B),
                                             range(4)))
    # reference first half -> port second half
    half = jstream.export_state(jp, ref_run(jstream.init_state(jp, B),
                                            range(2)))
    st = port_run(stream.import_state(tp, half, device="cpu"), range(2, 4))
    got = stream.export_state(tp, st)
    # port first half -> reference second half
    half_t = stream.export_state(tp, port_run(
        stream.init_state(tp, B, device="cpu"), range(2)))
    back = jstream.export_state(jp, ref_run(jstream.import_state(jp, half_t),
                                            range(2, 4)))
    for tree in (got, back):
        assert set(tree) == set(whole) == {"tail", "tail_b", "seen",
                                           "sketch"}
        for k in ("tail", "tail_b", "seen"):
            assert tree[k].dtype == whole[k].dtype
            np.testing.assert_array_equal(tree[k], whole[k])
        for k in whole["sketch"]:
            assert tree["sketch"][k].dtype == whole["sketch"][k].dtype
            np.testing.assert_array_equal(tree["sketch"][k],
                                          whole["sketch"][k])
    # batch slicing keeps the first rows of the row states only
    part = stream.export_state(tp, st, batch=2)
    assert part["seen"].shape == (2,) and part["sketch"]["sig"].shape == (2, 8)
    assert part["sketch"]["cms"].shape == (2, 256)


def test_import_state_checks_the_plan():
    _, tp = _plans("cyclic", 4)
    st = stream.export_state(tp, stream.init_state(tp, 2, device="cpu"))
    other = tplan.SketchPlan(tplan.HashSpec(family="cyclic", n=4),
                             (("sig", tplan.MinHashSpec(k=8)),))
    with pytest.raises(ValueError, match="has tail_b but the plan has no"):
        stream.import_state(other, st, device="cpu")
    no_b = {k: v for k, v in st.items() if k != "tail_b"}
    with pytest.raises(ValueError, match="no tail_b"):
        stream.import_state(tp, no_b, device="cpu")
    wide = tplan.SketchPlan(tplan.HashSpec(family="cyclic", n=6),
                            _sketches(tplan))
    with pytest.raises(ValueError, match="tail shape"):
        stream.import_state(wide, st, device="cpu")
    lacking = dict(st, sketch={k: v for k, v in st["sketch"].items()
                               if k != "hll"})
    with pytest.raises(ValueError, match="lacks sketches"):
        stream.import_state(tp, lacking, device="cpu")
    # an import onto a mesh re-pads for it: exported again, the same tree
    mesh = shard.data_mesh(4, device="cpu")
    back = stream.export_state(tp, stream.import_state(tp, st, mesh=mesh,
                                                       device="cpu"),
                               batch=2)
    for key in ("tail", "tail_b", "seen"):
        np.testing.assert_array_equal(back[key], st[key])
    for name in st["sketch"]:
        np.testing.assert_array_equal(back["sketch"][name],
                                      st["sketch"][name])


def test_update_many_leaves_the_callers_state_unchanged():
    _, tp = _plans("general", 5)
    ops = _ops(15)
    s0 = stream.init_state(tp, 2, device="cpu")
    s1 = stream.update_many(tp, s0, _x((3, 2, 7), 16),
                            chunk_b=_x((3, 2, 7), 17), operands=ops)
    snap = stream.export_state(tp, s1)
    s2 = stream.update_many(tp, s1, _x((3, 2, 7), 18),
                            chunk_b=_x((3, 2, 7), 19), operands=ops)
    again = stream.export_state(tp, s1)
    for k in ("tail", "tail_b", "seen"):
        np.testing.assert_array_equal(again[k], snap[k])
    for k in snap["sketch"]:
        np.testing.assert_array_equal(again["sketch"][k], snap["sketch"][k])
    assert not torch.equal(s2["sketch"]["cms"], s1["sketch"]["cms"])
