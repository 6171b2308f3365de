"""The limits the port's kernels once had on the card, lifted, against the
JAX package, which never had them.

On the CPU: the plan wrapper's grouping of a plan's sketches into launches
of at most eight (:func:`repro_torch.kernels.sketch_fused.sketch_groups`);
a ten-sketch plan through ``api.run`` against ``repro.kernels.api.run``,
both families, bit for bit; the decode plane's plain version at V in {1,
31, 33, 96} (one partial packed word, one word short of full, one past a
word, three full words) against the reference's Pallas kernel in interpret
mode.

The same limits on the card are checked in tests/test_torch_on_card.py
(which imports no JAX, so it runs on a card's machine) and by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels import plan as jplan
from repro_torch.kernels import api, decode, sketch_fused
from repro_torch.kernels import plan as tplan

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


def _u32(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


# ten sketches, at least two of each kind (tests/test_torch_on_card.py
# holds the same plan on the card)
_TEN = [("sig_a", "minhash", {"k": 8}), ("hll_a", "hll", {"b": 6}),
        ("cms_a", "cms", {"depth": 3, "log2_width": 8}),
        ("bl_a", "bloom", {"k": 3, "log2_m": 12}),
        ("sig_b", "minhash", {"k": 5}), ("hll_b", "hll", {"b": 9,
                                                           "rank_bits": 12}),
        ("cms_b", "cms", {"depth": 2, "log2_width": 13}),
        ("bl_b", "bloom", {"k": 2, "log2_m": 10}),
        ("sig_c", "minhash", {"k": 3}), ("hll_c", "hll", {"b": 4})]


def _ten_plans(family, n=5, L=32):
    kinds = lambda mod: {"minhash": mod.MinHashSpec, "hll": mod.HLLSpec,
                         "cms": mod.CountMinSpec, "bloom": mod.BloomSpec}
    return tuple(mod.SketchPlan(mod.HashSpec(family=family, n=n, L=L),
                                tuple((nm, kinds(mod)[kind](**kw))
                                      for nm, kind, kw in _TEN))
                 for mod in (jplan, tplan))


def _ten_case(plan, rng, B=4, S=120):
    """numpy h1v, h1v_b, n_windows, w_start and operands with carries for
    every sketch of ``plan`` (dense Bloom filters, so whole windows hit)."""
    W = S - plan.hash.n + 1
    ops_ = {}
    for name, spec in plan.sketches:
        if isinstance(spec, tplan.MinHashSpec):
            ops_[name] = {"a": _u32(rng, spec.k) | 1, "b": _u32(rng, spec.k),
                          "init": _u32(rng, B, spec.k)}
        elif isinstance(spec, tplan.HLLSpec):
            ops_[name] = {"init": rng.integers(0, 3, size=1 << spec.b)
                          .astype(np.int32)}
        elif isinstance(spec, tplan.CountMinSpec):
            ops_[name] = {"a": _u32(rng, spec.depth) | 1,
                          "b": _u32(rng, spec.depth),
                          "init": rng.integers(0, 9, size=(
                              spec.depth, spec.width)).astype(np.int32)}
        else:
            ops_[name] = {"bits": _u32(rng, spec.n_words)
                          | _u32(rng, spec.n_words),
                          "init": rng.integers(0, 50, size=B).astype(
                              np.int32)}
    nw = np.array([W, W // 2, 0, W][:B], np.int32)
    ws = np.array([0, 3, 1, W - 4][:B], np.int32)
    return _u32(rng, B, S), _u32(rng, B, S), nw, ws, ops_


@pytest.mark.parametrize("count", [1, 7, 8, 9, 10, 16, 17, 25])
def test_sketch_groups_partition_in_order(count):
    sketches = [(f"s{i}", object()) for i in range(count)]
    groups = sketch_fused.sketch_groups(sketches)
    assert [s for g in groups for s in g] == sketches       # exact, in order
    assert all(1 <= len(g) <= 8 for g in groups)
    assert len(groups) == -(-count // 8)
    assert all(len(g) == 8 for g in groups[:-1])            # only the last short


@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_ten_sketch_plan_matches_reference(family):
    jp, tp = _ten_plans(family)
    x, xb, nw, ws, ops_ = _ten_case(tp, np.random.default_rng(
        17 if family == "cyclic" else 18))
    j = lambda a: jnp.asarray(a)
    want = japi.run(jp, j(x), h1v_b=j(xb), n_windows=j(nw), w_start=j(ws),
                    operands={nm: {k: j(v) for k, v in d.items()}
                              for nm, d in ops_.items()}, impl="ref")
    got = api.run(tp, x, h1v_b=xb, n_windows=nw, w_start=ws, operands=ops_,
                  impl="ref", device="cpu")
    assert list(got) == [name for name, _ in tp.sketches]
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    # the wrapper's own plain path takes the whole plan too
    t = torch.from_numpy
    direct = sketch_fused.sketch_plan_fused(
        t(x), t(xb), t(nw), {nm: {k: t(v) for k, v in d.items()}
                             for nm, d in ops_.items()},
        plan=tp, w_start=t(ws))
    for name in want:
        np.testing.assert_array_equal(direct[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("V", [1, 31, 33, 96])
def test_decode_plain_matches_pallas_at_narrow_vocab(V):
    kw = dict(n=4, L=32, log2_m=8, k=2, canary_log2_m=9, canary_k=3)
    jspec, spec = jplan.DecodeSpec(**kw), tplan.DecodeSpec(**kw)
    rng = np.random.default_rng(V)
    B = 6
    dense = lambda *shape: _u32(rng, *shape) | _u32(rng, *shape)
    logits = rng.standard_normal((B, V)).astype(np.float32)
    prefix = _u32(rng, B)
    ready = np.array([1, 1, 0, 1, 0, 1], bool)
    filt, h1, cb = dense(B, spec.n_words), _u32(rng, V), dense(
        spec.canary_words)
    want = japi.decode(jspec, logits, prefix, ready, filt, h1,
                       canary_bits=cb, impl="pallas")
    got = decode.decode_masks_fused(
        torch.from_numpy(logits), torch.from_numpy(prefix),
        torch.from_numpy(ready), torch.from_numpy(filt),
        torch.from_numpy(h1), spec=spec,
        canary_bits=torch.from_numpy(cb))
    assert set(got) == set(want) == {"logits", "banned", "canary"}
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    W = -(-V // 32)
    assert got["banned"].shape == (B, W)
    if V % 32:      # the packed words' bits past V stay zero
        tail = ~np.uint32((1 << (V % 32)) - 1)
        assert not (got["banned"].numpy()[:, -1] & tail).any()
        assert not (got["canary"].numpy()[:, -1] & tail).any()
