"""repro_torch.kernels.stream: chunked runs equal one shot, bit for bit.

Mirrors tests/test_stream.py for the MinHash plan: the port's
``update``/``update_many``/``feed`` over fixed chunks equal its one-shot
``api.run`` and the reference's ``stream.run_stream`` and ``api.run`` on the
same inputs, down to ``chunk_s = n``, with ragged tails, idle rows and
documents shorter than the window.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels import plan as jplan
from repro.kernels import stream as jstream
from repro_torch.kernels import api, stream
from repro_torch.kernels import plan as tplan

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

K = 16


def _plans(family, n):
    return (jplan.SketchPlan(jplan.HashSpec(family=family, n=n),
                             (("sig", jplan.MinHashSpec(k=K)),)),
            tplan.SketchPlan(tplan.HashSpec(family=family, n=n),
                             (("sig", tplan.MinHashSpec(k=K)),)))


def _ops(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(0, 1 << 32, size=K, dtype=np.uint32) | 1,
            "b": rng.integers(0, 1 << 32, size=K, dtype=np.uint32)}


def _x(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                                dtype=np.uint32)


def _blocks(x, nw, n, chunk_s, T):
    """api.run's n_windows -> per-row symbol budgets, cut into (T, B, C)
    blocks of chunks with their (T, B) lengths (run_stream's tiling)."""
    B, S = x.shape
    sym = np.where(nw > 0, nw + n - 1, 0)
    nc = max(1, -(-S // chunk_s))
    nc += -nc % T
    xp = np.zeros((B, nc * chunk_s), np.uint32)
    xp[:, :S] = x
    chunks = xp.reshape(B, nc, chunk_s).transpose(1, 0, 2)
    lens = np.clip(sym[None, :] - np.arange(nc)[:, None] * chunk_s, 0,
                   chunk_s).astype(np.int32)
    for t in range(0, nc, T):
        yield np.ascontiguousarray(chunks[t : t + T]), lens[t : t + T]


@pytest.mark.parametrize("family", ["cyclic", "general"])
@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("chunk_kind", ["n", "n+1", "64", "1024"])
def test_chunked_equals_one_shot(family, n, chunk_kind):
    B, S = 4, 300
    jp, tp = _plans(family, n)
    x, ops = _x((B, S), seed=n), _ops()
    # ragged: per-row window counts from 0 (fully masked) to full
    nw = np.array([0, 1, S // 2, S - n + 1], np.int32)
    chunk_s = {"n": n, "n+1": n + 1, "64": 64, "1024": 1024}[chunk_kind]
    want = api.run(tp, x, n_windows=nw, operands={"sig": ops},
                   device="cpu")["sig"].numpy()
    jops = {"sig": {k: jnp.asarray(v) for k, v in ops.items()}}
    np.testing.assert_array_equal(want, np.asarray(japi.run(
        jp, jnp.asarray(x), n_windows=jnp.asarray(nw), operands=jops,
        impl="ref")["sig"]))
    np.testing.assert_array_equal(want, np.asarray(jstream.run_stream(
        jp, jnp.asarray(x), chunk_s=chunk_s, n_windows=jnp.asarray(nw),
        operands=jops, impl="ref")["sig"]))
    state = stream.init_state(tp, B, device="cpu")
    state = stream.feed(tp, _blocks(x, nw, n, chunk_s, T=4), state,
                        operands={"sig": ops})
    np.testing.assert_array_equal(stream.finalize(tp, state)["sig"].numpy(),
                                  want)


def test_update_many_equals_update_loop():
    _, tp = _plans("general", 8)
    x, ops = _x((3, 290), seed=2), _ops(1)
    nw = np.array([283, 100, 7], np.int32)
    s1 = stream.init_state(tp, 3, device="cpu")
    s2 = stream.init_state(tp, 3, device="cpu")
    for chunks, lens in _blocks(x, nw, 8, 37, T=2):
        s1 = stream.update_many(tp, s1, torch.from_numpy(chunks),
                                lengths=lens, operands={"sig": ops})
        for c, ln in zip(chunks, lens):
            s2 = stream.update(tp, s2, c, lengths=ln, operands={"sig": ops})
    for key in ("tail", "seen"):
        assert torch.equal(s1[key], s2[key])
    assert torch.equal(s1["sketch"]["sig"], s2["sketch"]["sig"])


def _four(family):
    """A plan of all four sketches in both packages, with numpy operands."""
    sk = lambda m: (("sig", m.MinHashSpec(k=K)), ("hll", m.HLLSpec(b=6)),
                    ("cms", m.CountMinSpec(depth=3, log2_width=7)),
                    ("bloom", m.BloomSpec(k=3, log2_m=10)))
    plans = tuple(m.SketchPlan(m.HashSpec(family=family, n=5), sk(m))
                  for m in (jplan, tplan))
    rng = np.random.default_rng(5)
    u32 = lambda n: rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    ops = {"sig": _ops(6), "cms": {"a": u32(3) | 1, "b": u32(3)},
           "bloom": {"bits": u32(1 << 5)}}
    return plans, ops


def _donation_case(dev):
    """A ragged block with idle rows: (T, B, C) chunks, both streams, and
    (T, B) lengths where row 1 idles in chunks 1-2 and row 3 from chunk 2."""
    rng = np.random.default_rng(8)
    T, B, C = 4, 4, 23
    chunks = rng.integers(0, 1 << 32, size=(T, B, C), dtype=np.uint32)
    chunks_b = rng.integers(0, 1 << 32, size=(T, B, C), dtype=np.uint32)
    lens = rng.integers(1, C + 1, size=(T, B)).astype(np.int32)
    lens[1:3, 1] = 0
    lens[2:, 3] = 0
    return (torch.from_numpy(chunks).to(dev),
            torch.from_numpy(chunks_b).to(dev), lens)


def _check_donated_update_many(tp, ops, dev):
    chunks, chunks_b, lens = _donation_case(dev)
    T, B, _ = chunks.shape
    ops = {name: {k: torch.from_numpy(v).to(dev) for k, v in o.items()}
           for name, o in ops.items()}
    # the caller's state carries a warm start from one update
    start = stream.init_state(tp, B, device=dev)
    start = stream.update(tp, start, chunks[0], chunk_b=chunks_b[0],
                          lengths=lens[0], operands=ops)
    before = {k: v.clone() for k, v in start["sketch"].items()}
    tails = (start["tail"].clone(), start["tail_b"].clone(),
             start["seen"].clone())
    many = stream.update_many(tp, start, chunks, chunk_b=chunks_b,
                              lengths=lens, operands=ops)
    loop = start
    for t in range(T):
        loop = stream.update(tp, loop, chunks[t], chunk_b=chunks_b[t],
                             lengths=lens[t], operands=ops)
    for key in ("tail", "tail_b", "seen"):
        assert torch.equal(many[key], loop[key]), key
    for name in many["sketch"]:
        assert torch.equal(many["sketch"][name], loop["sketch"][name]), name
        # the caller's carry is never donated: unchanged, not aliased
        assert torch.equal(start["sketch"][name], before[name]), name
        assert (many["sketch"][name].data_ptr()
                != start["sketch"][name].data_ptr()), name
    assert all(torch.equal(a, b) for a, b in zip(
        (start["tail"], start["tail_b"], start["seen"]), tails))
    return start, chunks, chunks_b, lens, ops, many


@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_donated_update_many_equals_update_loop(family):
    """update_many donates its own carry from the second chunk on: the same
    carry as T update calls for all four sketches, with ragged lengths and
    idle rows, equal to the reference's update_many, and the caller's state
    untouched."""
    (jp, tp), ops = _four(family)
    start, chunks, chunks_b, lens, _, many = _check_donated_update_many(
        tp, ops, "cpu")
    jstate = {k: (jnp.asarray(v.numpy()) if k != "sketch" else
                  {n: jnp.asarray(t.numpy()) for n, t in v.items()})
              for k, v in start.items()}
    want = jstream.update_many(
        jp, jstate, jnp.asarray(chunks.numpy()),
        chunk_b=jnp.asarray(chunks_b.numpy()), lengths=jnp.asarray(lens),
        operands={n: {k: jnp.asarray(v) for k, v in o.items()}
                  for n, o in ops.items()}, impl="ref")
    for name, got in many["sketch"].items():
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want["sketch"][name]))


def test_donated_update_many_equals_update_loop_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels "
                    "there)")
    for family in ("cyclic", "general"):
        (_, tp), ops = _four(family)
        _check_donated_update_many(tp, ops, "cuda")


def test_short_documents_sign_to_sentinel():
    _, tp = _plans("cyclic", 8)
    x = _x((3, 5))                               # S < n
    state = stream.init_state(tp, 3, device="cpu")
    state = stream.update(tp, state, x, operands={"sig": _ops()})
    assert (stream.finalize(tp, state)["sig"].numpy() == 0xFFFFFFFF).all()
    assert state["seen"].tolist() == [5, 5, 5]


def test_rows_advance_independently():
    # rows pause and resume (idle rows included); the result equals one-shot
    # hashing of each row's concatenated stream in both packages
    jp, tp = _plans("cyclic", 8)
    ops = _ops(3)
    rng = np.random.default_rng(0)
    B, C = 3, 16
    feeds = [[], [], []]
    state = stream.init_state(tp, B, device="cpu")
    for _ in range(12):
        lengths = rng.integers(0, C + 1, size=B)
        chunk = rng.integers(0, 1 << 32, size=(B, C), dtype=np.uint32)
        for r in range(B):
            feeds[r].extend(chunk[r, : lengths[r]].tolist())
        state = stream.update(tp, state, chunk, lengths=lengths,
                              operands={"sig": ops})
    got = stream.finalize(tp, state)["sig"].numpy()
    width = max(max(len(f) for f in feeds), 8)
    x = np.zeros((B, width), np.uint32)
    nw = np.zeros((B,), np.int32)
    for r, f in enumerate(feeds):
        x[r, : len(f)] = f
        nw[r] = max(0, len(f) - 8 + 1)
    np.testing.assert_array_equal(got, api.run(
        tp, x, n_windows=nw, operands={"sig": ops}, device="cpu")["sig"])
    np.testing.assert_array_equal(got, np.asarray(japi.run(
        jp, jnp.asarray(x), n_windows=jnp.asarray(nw), impl="ref",
        operands={"sig": {k: jnp.asarray(v) for k, v in ops.items()}}
    )["sig"]))


def test_carry_seeds_the_signature():
    # a carried signature continues: the result is its min with the chunk's
    _, tp = _plans("cyclic", 8)
    ops = _ops(4)
    x = _x((3, 64), seed=4)
    fresh = stream.init_state(tp, 3, device="cpu")
    fresh = stream.update(tp, fresh, x, operands={"sig": ops})
    carry = np.full((3, K), 0xFFFFFFFF, np.uint32)
    carry[1] = 7
    seeded = stream.init_state(tp, 3, carry={"sig": carry}, device="cpu")
    seeded = stream.update(tp, seeded, x, operands={"sig": ops})
    np.testing.assert_array_equal(
        seeded["sketch"]["sig"].numpy(),
        np.minimum(fresh["sketch"]["sig"].numpy(), carry))


def test_update_validation():
    _, tp = _plans("cyclic", 8)
    ops = {"sig": _ops()}
    state = stream.init_state(tp, 2, device="cpu")
    with pytest.raises(ValueError, match="do not pass 'init'"):
        stream.update(tp, state, _x((2, 16)),
                      operands={"sig": {**ops["sig"],
                                        "init": state["sketch"]["sig"]}})
    with pytest.raises(ValueError, match="lengths shape"):
        stream.update(tp, state, _x((2, 16)), lengths=np.zeros((3,)),
                      operands=ops)
    with pytest.raises(ValueError, match="lengths must be non-negative"
                                         ".*row 1 has -5"):
        stream.update(tp, state, _x((2, 16)), lengths=[3, -5], operands=ops)
    with pytest.raises(ValueError, match="lengths must be <= 16"
                                         ".*row 0 has 50"):
        stream.update(tp, state, _x((2, 16)), lengths=[50, 3], operands=ops)
    with pytest.raises(ValueError, match="chunk rows 4 != stream state"):
        stream.update(tp, state, _x((4, 16)), operands=ops)
    with pytest.raises(ValueError, match="chunks must be"):
        stream.update_many(tp, state, _x((2, 16)), operands=ops)
    with pytest.raises(ValueError, match="carry for sketches not in plan"):
        stream.init_state(tp, 2, carry={"ghost": np.zeros((2, K))},
                          device="cpu")
    with pytest.raises(ValueError, match="impl='kernel'"):
        stream.update(tp, state, _x((2, 16)), operands=ops, impl="kernel")
    with pytest.raises(ValueError, match="chunk_b given but no sketch"):
        stream.update(tp, state, _x((2, 16)), chunk_b=_x((2, 16)),
                      operands=ops)
    bloom = tplan.SketchPlan(tplan.HashSpec(family="cyclic", n=8),
                             (("bl", tplan.BloomSpec(k=2, log2_m=8)),))
    bstate = stream.init_state(bloom, 2, device="cpu")
    assert bstate["sketch"]["bl"].dtype == torch.int32
    with pytest.raises(ValueError, match="needs a second stream chunk_b"):
        stream.update(bloom, bstate, _x((2, 16)),
                      operands={"bl": {"bits": np.zeros(8, np.uint32)}})


# one malformed (T, B, C) block a case, and the error each call raises on
# it: update takes its first chunk, update_many the block, run_stream the
# block's chunks side by side as one (B, T*C) stream (its window counts in
# place of the lengths), where the case applies to run_stream at all
BT, BB, BC = 3, 2, 16
BAD_BLOCKS = {
    "rank": {"update": "chunk must be (B, C), got shape (1, 2, 16)",
             "update_many": "chunks must be (T, B, C), got shape (2, 16)"},
    "rows": {"update": "chunk rows 4 != stream state rows 2",
             "update_many": "chunk rows 4 != stream state rows 2"},
    "no_second_stream": {
        "update": "plan contains a BloomSpec: the double-hashing probe "
                  "stride needs a second stream chunk_b",
        "update_many": "plan contains a BloomSpec: the double-hashing "
                       "probe stride needs a second stream chunk_b",
        "run_stream": "plan contains a BloomSpec: the double-hashing "
                      "probe stride needs a second stream h1v_b"},
    "extra_second_stream": {
        "update": "chunk_b given but no sketch in the plan",
        "update_many": "chunk_b given but no sketch in the plan",
        "run_stream": "h1v_b given but no sketch in the plan"},
    "second_stream_shape": {
        "update": "chunk_b shape (2, 8) != chunk shape (2, 16)",
        "update_many": "chunk_b shape (3, 2, 8) != chunk shape (3, 2, 16)",
        "run_stream": "h1v_b shape (2, 24) != h1v shape (2, 48)"},
    "negative_lengths": {
        "update": "lengths must be non-negative; row 1 has -5",
        "update_many": "lengths must be non-negative; row "
                       "(np.int64(0), np.int64(1)) has -5",
        "run_stream": "n_windows must be non-negative; row 1 has -5"},
    "long_lengths": {
        "update": "lengths must be <= 16; row 0 has 50",
        "update_many": "lengths must be <= 16; row "
                       "(np.int64(0), np.int64(0)) has 50"},
    "lengths_shape": {
        "update": "lengths shape (3,) != batch (2,)",
        "update_many": "lengths shape (3, 3) != chunk stack (3, 2)",
        "run_stream": "n_windows shape (3,) != batch (2,)"},
    "init": {"update": "sketch 'sig': do not pass 'init' to stream.update "
                       "— the stream carry supplies every sketch's state",
             "update_many": "sketch 'sig': do not pass 'init' to "
                            "stream.update_many — the stream carry supplies "
                            "every sketch's state",
             "run_stream": "sketch 'sig': do not pass 'init' to run_stream "
                           "— the stream carry supplies every sketch's "
                           "state"},
    "foreign_mesh": {
        "update": "the stream state is laid out on None, not on DataMesh",
        "update_many": "the stream state is laid out on None, not on "
                       "DataMesh"},
}


def _bad_call(case, call):
    """``call`` on the malformed block of ``case``, as a thunk."""
    _, plan = _plans("cyclic", 8)
    ops = {"sig": _ops()}
    chunk, chunk_b, lengths, kw = _x((BB, BC)), None, None, {}
    if case in ("no_second_stream", "second_stream_shape"):
        plan = tplan.SketchPlan(tplan.HashSpec(family="cyclic", n=8),
                                (("bl", tplan.BloomSpec(k=2, log2_m=8)),))
        ops = {"bl": {"bits": np.zeros(8, np.uint32)}}
        if case == "second_stream_shape":
            chunk_b = _x((BB, BC // 2), seed=1)
    elif case == "extra_second_stream":
        chunk_b = _x((BB, BC), seed=1)
    elif case == "rank":
        chunk = _x((1, BB, BC))
    elif case == "rows":
        chunk = _x((4, BC))
    elif case == "negative_lengths":
        lengths = np.array([3, -5])
    elif case == "long_lengths":
        lengths = np.array([50, 3])
    elif case == "lengths_shape":
        lengths = np.array([3, 3, 3])
    elif case == "init":
        ops = {"sig": {**ops["sig"], "init": np.zeros((BB, K), np.uint32)}}
    elif case == "foreign_mesh":
        kw = {"data_shards": 2}
    state = stream.init_state(plan, BB, device="cpu")
    if call == "update":
        return lambda: stream.update(plan, state, chunk, chunk_b=chunk_b,
                                     lengths=lengths, operands=ops, **kw)
    if call == "update_many":
        stack = lambda a: None if a is None else np.stack([a] * BT)
        chunks = chunk[0] if case == "rank" else stack(chunk)
        return lambda: stream.update_many(
            plan, state, chunks, chunk_b=stack(chunk_b),
            lengths=stack(lengths), operands=ops, **kw)
    side = lambda a: None if a is None else np.concatenate([a] * BT, axis=1)
    return lambda: stream.run_stream(
        plan, side(chunk), h1v_b=side(chunk_b), n_windows=lengths,
        operands=ops, chunk_s=BC, device="cpu", **kw)


@pytest.mark.parametrize("case,call", [(case, call)
                                       for case in sorted(BAD_BLOCKS)
                                       for call in sorted(BAD_BLOCKS[case])])
def test_malformed_block_raises_the_same_error(case, call):
    """Each call checks a block in one place and names the fault as it
    always has: the row by its index in the counts the caller passed."""
    with pytest.raises(ValueError) as err:
        _bad_call(case, call)()
    assert str(err.value).startswith(BAD_BLOCKS[case][call]), str(err.value)
