"""The port's session pool and telemetry against the JAX package's.

* Both pools take the same h1 table, canary filter and logits sequence
  through admit, a ragged prime, greedy steps (with top-k), evict and
  re-admit, and reset; their exported trees (carry, params, free list,
  clock) are bit-equal after every call, and ``telemetry.snapshot`` gives
  the same counts (the ``dispatches`` counter is per process: compared as
  the rise over the run).
* A snapshot crosses between the packages (``convert.session_state_from_jax``
  / ``session_state_to_jax``) and both continue bit-identically.
* The recursion equals a from-scratch hash of the last n-1 symbols at every
  step, n = 33 > L included (tests/test_serve_plane.py:178), and the u64
  counters carry across 2^32 (tests/test_serve_plane.py:338).
* A sampled step stays within the top-k and never picks a banned token.
"""
import numpy as np
import pytest
import torch

from repro.kernels.plan import DecodeSpec as JDecodeSpec
from repro.serve import sessions as jsess
from repro.serve import telemetry as jtele
from repro_torch import convert
from repro_torch.kernels import api
from repro_torch.kernels.plan import DecodeSpec
from repro_torch.serve import sessions, telemetry

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


def _assert_trees_equal(port_tree, jax_tree):
    assert set(port_tree["carry"]) == set(jax_tree["carry"])
    for key, want in jax_tree["carry"].items():
        got = port_tree["carry"][key]
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    for key, want in jax_tree["params"].items():
        np.testing.assert_array_equal(port_tree["params"][key], want)
    np.testing.assert_array_equal(port_tree["free"], jax_tree["free"])
    assert int(port_tree["t"]) == int(jax_tree["t"])


def _snap_equal(port_pool, jax_pool, port_d0, jax_d0):
    a, b = telemetry.snapshot(port_pool), jtele.snapshot(jax_pool)
    assert a.pop("dispatches") - port_d0 == b.pop("dispatches") - jax_d0
    assert a == b


def _pools(spec_kw, C, V, seed, canary=True):
    rng = np.random.default_rng(seed)
    h1 = rng.integers(0, 2**32, size=V, dtype=np.uint32)
    jspec, spec = JDecodeSpec(**spec_kw), DecodeSpec(**spec_kw)
    cb = (rng.integers(0, 2**32, size=spec.canary_words, dtype=np.uint32)
          if canary and spec.has_canary else None)
    jp = jsess.SessionPool(jspec, C, h1, canary_bits=cb, impl="ref")
    pp = sessions.SessionPool(spec, C, h1, canary_bits=cb, device="cpu")
    return rng, jp, pp


@pytest.mark.parametrize("n,L", [(3, 32), (4, 20), (33, 32)])
def test_pool_lifecycle_matches_reference(n, L):
    spec_kw = dict(n=n, L=L, log2_m=9, k=2, canary_log2_m=8)
    C, V = 6, 200
    rng, jp, pp = _pools(spec_kw, C, V, seed=n * 10 + L)
    jd0, pd0 = jsess.dispatch_count(), sessions.dispatch_count()

    def check():
        _assert_trees_equal(pp.export_state(), jp.export_state())

    np.testing.assert_array_equal(pp.admit(C), jp.admit(C))
    check()
    # long enough that n = 33 rows get ready and the filters fill
    toks = rng.integers(0, V, size=(C, 40), dtype=np.int32)
    lens = np.array([40, 3, 0, 25, 40, 1], np.int32)
    jp.prime(toks, lens)
    pp.prime(toks, lens)
    check()
    for i in range(10):
        lg = rng.standard_normal((C, V)).astype(np.float32)
        top_k = 5 if i % 2 else 0
        ta = jp.step(lg, temperature=0.0, top_k=top_k)
        tb = pp.step(lg, temperature=0.0, top_k=top_k)
        assert tb.dtype == torch.int32
        np.testing.assert_array_equal(tb.numpy(), np.asarray(ta))
        check()
        if i == 4:
            for p in (jp, pp):
                p.evict([1, 4])
            check()
            np.testing.assert_array_equal(pp.admit(2), jp.admit(2))
            check()
        if i == 7:
            for p in (jp, pp):
                p.reset([2])
            check()
    _snap_equal(pp, jp, pd0, jd0)
    snap = telemetry.snapshot(pp)
    assert snap["banned_candidates"] > 0 and snap["decode_steps"] > 0
    assert sorted(pp.active_slots) == sorted(np.asarray(jp.active_slots))
    assert pp.free_count == jp.free_count == 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_packages_and_continues(direction):
    spec_kw = dict(n=4, L=32, log2_m=8, k=3, canary_log2_m=7)
    C, V = 4, 96
    rng, jp, pp = _pools(spec_kw, C, V, seed=21)
    src, dst = (jp, pp) if direction == "jax_to_port" else (pp, jp)
    src.admit(C)
    src.prime(rng.integers(0, V, size=(C, 6), dtype=np.int32))
    for _ in range(3):
        src.step(rng.standard_normal((C, V)).astype(np.float32),
                 temperature=0.0)
    tree = src.export_state()
    if direction == "jax_to_port":
        dst.import_state(convert.session_state_from_jax(tree, "cpu"))
    else:
        dst.import_state(convert.session_state_to_jax(tree))
    for _ in range(4):
        lg = rng.standard_normal((C, V)).astype(np.float32)
        ta = src.step(lg, temperature=0.0, top_k=7)
        tb = dst.step(lg, temperature=0.0, top_k=7)
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    a, b = pp.export_state(), jp.export_state()
    _assert_trees_equal(a, b)


def _window_hash(h1, toks, L):
    """From-scratch CYCLIC hash of a window (the recursion's ground truth)."""
    h = 0
    m = (1 << L) - 1
    for t in toks:
        h = (((h << 1) | (h >> (L - 1))) & m) ^ (int(h1[t]) & m)
    return h


@pytest.mark.parametrize("n", [2, 5, 33])
def test_pool_recursion_exact_vs_from_scratch(n):
    spec = DecodeSpec(n=n, L=32, log2_m=6)
    V, C, T = 97, 4, 70
    rng = np.random.default_rng(n)
    h1 = rng.integers(0, 2**32, size=V, dtype=np.uint32)
    pool = sessions.SessionPool(spec, C, h1, device="cpu")
    pool.admit(C)
    streams = rng.integers(0, V, size=(C, T), dtype=np.int32)
    for t in range(T):
        pool.prime(streams[:, t : t + 1])
        prefix = pool.state["prefix"].to(torch.int64).numpy()
        for i in range(C):
            want = _window_hash(h1, streams[i, max(0, t + 1 - (n - 1)):t + 1],
                                spec.L)
            assert int(prefix[i]) == want, (t, i)


def test_accum_u64_carries_across_2_32():
    lo = torch.tensor([0xFFFFFFF0], dtype=torch.int64).to(torch.uint32)
    hi = torch.tensor([3], dtype=torch.int64).to(torch.uint32)
    lo1, hi1 = sessions._accum_u64(lo, hi, torch.tensor([0x20]))
    assert int(telemetry.u64(lo1.numpy(), hi1.numpy())[0]) == (
        (3 << 32) + 0xFFFFFFF0 + 0x20)


def test_sampled_step_stays_in_top_k_and_unbanned():
    """Sampled draws are not threefry's, so the check is the distribution's
    support: every token lies within its row's top-k of the masked logits
    and is not banned; a fixed generator seed repeats the draws."""
    spec = DecodeSpec(n=2, log2_m=6)
    C, V, K = 8, 64, 5
    rng = np.random.default_rng(3)
    h1 = rng.integers(0, 2**32, size=V, dtype=np.uint32)
    pools = [sessions.SessionPool(spec, C, h1, device="cpu")
             for _ in range(2)]
    prompt = rng.integers(0, V, size=(C, 3), dtype=np.int32)
    for p in pools:
        p.admit(C)
        p.prime(prompt)
    for _ in range(6):
        lg = rng.standard_normal((C, V)).astype(np.float32)
        st = pools[0].state
        ready = (st["count"] >= spec.n - 1) & (st["active"] != 0)
        out = api.decode(spec, lg, st["prefix"], ready, st["bloom"], h1,
                         device="cpu")
        masked = out["logits"]
        kth = torch.topk(masked, K, dim=-1).values[:, -1]
        toks = [p.step(lg, generator=torch.Generator().manual_seed(9),
                       temperature=0.8, top_k=K) for p in pools]
        assert torch.equal(toks[0], toks[1])
        t = toks[0].to(torch.int64)
        picked = masked[torch.arange(C), t]
        assert (picked >= kth).all()
        words = out["banned"].to(torch.int64)[torch.arange(C), t // 32]
        assert ((words >> (t % 32)) & 1 == 0).all()


def test_pool_rejects_what_the_slice_lacks():
    spec = DecodeSpec(n=3, log2_m=6)
    h1 = np.arange(10, dtype=np.uint32)
    # row sharding is ported: the capacity must divide the shard count
    with pytest.raises(ValueError, match="must divide the data mesh"):
        sessions.SessionPool(spec, 3, h1, device="cpu", data_shards=2)
    assert sessions.SessionPool(spec, 4, h1, device="cpu",
                                data_shards=2).mesh.size == 2
    pool = sessions.SessionPool(spec, 3, h1, device="cpu")
    with pytest.raises(ValueError, match="only 3 free"):
        pool.admit(4)
    with pytest.raises(ValueError, match="logits shape"):
        pool.step(np.zeros((3, 9), np.float32))
    with pytest.raises(ValueError, match="canary_bits given"):
        sessions.SessionPool(spec, 3, h1, device="cpu",
                             canary_bits=np.zeros(1, np.uint32))


# ---------------------------------------------------------------------------
# row-wise sharding over a data mesh (tests/test_serve_plane.py:374-455)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_pool_sharded_bitparity_any_shard_count(d, temperature):
    """The pool on d virtual CPU shards gives the one-device tokens and
    carry, greedy and sampled (the noise is drawn before the split); greedy
    it also equals the reference's pool on its d-device mesh."""
    from repro.kernels import shard as jshard
    spec_kw = dict(n=4, log2_m=9, canary_log2_m=10, canary_k=2)
    V, C = 96, 8
    rng = np.random.default_rng(13)
    h1 = rng.integers(0, 2**32, size=V, dtype=np.uint32)
    spec = DecodeSpec(**spec_kw)
    cb = rng.integers(0, 2**32, size=spec.canary_words, dtype=np.uint32)
    prompts = rng.integers(0, V, size=(C, 5)).astype(np.int32)
    lens = rng.integers(0, 6, size=C)
    one = sessions.SessionPool(spec, C, h1, canary_bits=cb, device="cpu")
    shd = sessions.SessionPool(spec, C, h1, canary_bits=cb, device="cpu",
                               data_shards=d)
    jpool = jsess.SessionPool(JDecodeSpec(**spec_kw), C, h1, canary_bits=cb,
                              impl="ref", mesh=jshard.data_mesh(d))
    for p in (one, shd, jpool):
        p.admit(C)
        p.prime(prompts, lens)
        p.evict([3])
    gens = [torch.Generator().manual_seed(21) for _ in range(2)]
    for _ in range(5):
        lg = rng.standard_normal((C, V)).astype(np.float32)
        ta = one.step(lg, generator=gens[0], temperature=temperature,
                      top_k=7)
        tb = shd.step(lg, generator=gens[1], temperature=temperature,
                      top_k=7)
        assert torch.equal(ta, tb)
        if temperature == 0.0:
            tj = jpool.step(lg, temperature=0.0, top_k=7)
            np.testing.assert_array_equal(tb.numpy(), np.asarray(tj))
    a, b = one.export_state(), shd.export_state()
    for key in a["carry"]:
        np.testing.assert_array_equal(a["carry"][key], b["carry"][key],
                                      err_msg=key)
    assert telemetry.snapshot(one) == {**telemetry.snapshot(shd),
                                       "dispatches": telemetry.snapshot(
                                           one)["dispatches"]}
    if temperature == 0.0:
        _assert_trees_equal(b, jpool.export_state())


def test_pool_capacity_must_divide_mesh():
    spec = DecodeSpec(n=3, log2_m=6)
    with pytest.raises(ValueError, match="must divide"):
        sessions.SessionPool(spec, 6, np.arange(8, dtype=np.uint32),
                             device="cpu", data_shards=4)
    pool = sessions.SessionPool(spec, 8, np.arange(8, dtype=np.uint32),
                                device="cpu", data_shards=4)
    with pytest.raises(ValueError, match="logits shape"):
        pool.step(np.zeros((6, 8), np.float32))
