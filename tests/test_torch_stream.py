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
    hll = tplan.SketchPlan(tplan.HashSpec(family="cyclic", n=8),
                           (("card", tplan.HLLSpec(b=8)),))
    with pytest.raises(NotImplementedError, match="HLLSpec epilogue"):
        stream.init_state(hll, 2, device="cpu")
