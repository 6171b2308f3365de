"""The plan engine's HLL, CountMin and Bloom epilogues against the JAX
package's, bit for bit.

``repro_torch.kernels.api.run(impl="ref")`` (and ``"auto"`` on CPU tensors)
is held against ``repro.kernels.api.run`` for each spec alone and in mixed
plans, both families, n in {1, 2, 5, 8}, L in {16, 32}, with padded
``n_windows``, ``w_start`` and ``init`` carries, and CountMin on both
sides of the reference's in-kernel width threshold; one mixed case also
against the reference's Pallas kernel in interpret mode. Mirrors
tests/test_sketch_fused.py, test_countmin.py and test_plan_api.py. The
CUDA kernel runs only on the card: its case skips without one, and
``chip_smoke.py`` holds it against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels import plan as jplan
from repro_torch.kernels import api, sketch_fused
from repro_torch.kernels import plan as tplan

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernel "
                    "there)")
    return torch.device("cuda")


def _spec(mod, kind, **kw):
    return {"minhash": mod.MinHashSpec, "hll": mod.HLLSpec,
            "cms": mod.CountMinSpec, "bloom": mod.BloomSpec}[kind](**kw)


def _plans(family, n, L, sketches):
    """sketches: [(name, kind, kwargs)] -> (reference plan, port plan)."""
    return tuple(mod.SketchPlan(mod.HashSpec(family=family, n=n, L=L),
                                tuple((nm, _spec(mod, kind, **kw))
                                      for nm, kind, kw in sketches))
                 for mod in (jplan, tplan))


def _case(plan, rng, B=3, S=90, carry=True):
    """numpy inputs for a port plan: h1v, h1v_b, n_windows, w_start,
    operands (with init carries when ``carry``)."""
    u32 = lambda *shape: rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    W = max(0, S - plan.hash.n + 1)
    ops = {}
    for name, spec in plan.sketches:
        if isinstance(spec, tplan.MinHashSpec):
            ops[name] = {"a": u32(spec.k) | 1, "b": u32(spec.k)}
            init = u32(B, spec.k)
        elif isinstance(spec, tplan.HLLSpec):
            ops[name] = {}
            init = rng.integers(0, 4, size=1 << spec.b).astype(np.int32)
        elif isinstance(spec, tplan.CountMinSpec):
            ops[name] = {"a": u32(spec.depth) | 1, "b": u32(spec.depth)}
            init = rng.integers(0, 9, size=(spec.depth, spec.width)).astype(
                np.int32)
        else:
            # a dense filter, so that whole windows hit
            ops[name] = {"bits": u32(spec.n_words) | u32(spec.n_words)}
            init = rng.integers(0, 50, size=B).astype(np.int32)
        if carry:
            ops[name]["init"] = init
    nw = ws = None
    if carry:
        nw = np.array([0, W // 2, W + 9][:B] + [W] * (B - 3), np.int32)
        ws = np.array([3, 0, max(W - 5, 0)][:B] + [1] * (B - 3), np.int32)
    xb = u32(B, S) if plan.needs_second_stream else None
    return u32(B, S), xb, nw, ws, ops


def _j(a):
    return None if a is None else jnp.asarray(a)


def _jrun(jp, x, xb, nw, ws, ops, **kw):
    out = japi.run(jp, _j(x), h1v_b=_j(xb), n_windows=_j(nw), w_start=_j(ws),
                   operands={nm: {k: _j(v) for k, v in d.items()}
                             for nm, d in ops.items()}, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _check(jp, tp, x, xb, nw, ws, ops, impls=("ref", "auto"), **jkw):
    want = _jrun(jp, x, xb, nw, ws, ops, **jkw)
    for impl in impls:
        got = api.run(tp, x, h1v_b=xb, n_windows=nw, w_start=ws,
                      operands=ops, impl=impl, device="cpu")
        for name, spec in tp.sketches:
            g = got[name]
            assert g.device.type == "cpu"
            assert g.dtype == (torch.uint32 if isinstance(
                spec, tplan.MinHashSpec) else torch.int32)
            np.testing.assert_array_equal(g.numpy(), want[name])
    return want


_SINGLE = [
    ("hll", dict(b=4)), ("hll", dict(b=12)), ("hll", dict(b=6, rank_bits=3)),
    ("hll", dict(b=8, rank_bits=30)),
    ("cms", dict(depth=4, log2_width=8)), ("cms", dict(depth=4,
                                                       log2_width=12)),
    ("cms", dict(depth=4, log2_width=16)), ("cms", dict(depth=2,
                                                        log2_width=13)),
    ("bloom", dict(k=4, log2_m=10)), ("bloom", dict(k=1, log2_m=5)),
    ("bloom", dict(k=7, log2_m=16)),
]


@pytest.mark.parametrize("family", ["cyclic", "general"])
@pytest.mark.parametrize("kind,kw", _SINGLE,
                         ids=[f"{k}-{'-'.join(map(str, v.values()))}"
                              for k, v in _SINGLE])
@pytest.mark.parametrize("carry", [False, True])
def test_each_epilogue_matches_reference(family, kind, kw, carry):
    jp, tp = _plans(family, 8, 32, [("s", kind, kw)])
    rng = np.random.default_rng(len(kind) + sum(kw.values()))
    _check(jp, tp, *_case(tp, rng, carry=carry))


@pytest.mark.parametrize("family", ["cyclic", "general"])
@pytest.mark.parametrize("n", [1, 2, 5, 8])
@pytest.mark.parametrize("L", [16, 32])
def test_mixed_plan_matches_reference(family, n, L):
    # every epilogue behind one hash pass, HLL at the plan's default rank
    # bits (L - n + 1 - b under the CYCLIC discard)
    sketches = [("sig", "minhash", dict(k=16)), ("card", "hll", dict(b=5)),
                ("freq", "cms", dict(depth=3, log2_width=9)),
                ("bl", "bloom", dict(k=3, log2_m=9))]
    jp, tp = _plans(family, n, L, sketches)
    rng = np.random.default_rng(10 * n + L)
    _check(jp, tp, *_case(tp, rng, B=4, S=70))


def test_stats_and_decontam_plans_at_published_widths():
    # the data plane's two plans at StatsConfig's and DecontamConfig's
    # defaults: HLL b=12 + CountMin 4 x 2^16, and Bloom 2^22 bits with k=4
    rng = np.random.default_rng(3)
    for sketches in ([("hll", "hll", dict(b=12)),
                      ("cms", "cms", dict(depth=4, log2_width=16))],
                     [("bloom", "bloom", dict(k=4, log2_m=22))]):
        for family in ("cyclic", "general"):
            jp, tp = _plans(family, 8, 32, sketches)
            _check(jp, tp, *_case(tp, rng, B=4, S=300), impls=("ref",))


def test_mixed_plan_matches_reference_pallas_interpret():
    sketches = [("card", "hll", dict(b=6)),
                ("freq", "cms", dict(depth=2, log2_width=14)),
                ("bl", "bloom", dict(k=2, log2_m=12))]
    jp, tp = _plans("cyclic", 5, 32, sketches)
    _check(jp, tp, *_case(tp, np.random.default_rng(1), B=2, S=40),
           impl="pallas", block_b=2, block_s=128)


def test_leading_dims_and_output_shapes():
    sketches = [("sig", "minhash", dict(k=8)), ("card", "hll", dict(b=4)),
                ("freq", "cms", dict(depth=2, log2_width=6)),
                ("bl", "bloom", dict(k=2, log2_m=8))]
    jp, tp = _plans("general", 4, 32, sketches)
    rng = np.random.default_rng(4)
    _, _, _, _, ops = _case(tp, rng, carry=False)
    x = rng.integers(0, 1 << 32, size=(2, 3, 50), dtype=np.uint32)
    xb = rng.integers(0, 1 << 32, size=(2, 3, 50), dtype=np.uint32)
    got = api.run(tp, x, h1v_b=xb, operands=ops, device="cpu")
    want = _jrun(jp, x, xb, None, None, ops, impl="ref")
    shapes = {"sig": (2, 3, 8), "card": (16,), "freq": (2, 64), "bl": (2, 3)}
    for name, shape in shapes.items():
        assert tuple(got[name].shape) == shape
        np.testing.assert_array_equal(got[name].numpy(), want[name])


def test_short_rows_and_second_stream_validation():
    _, tp = _plans("cyclic", 8, 32, [("bl", "bloom", dict(k=2, log2_m=8)),
                                     ("card", "hll", dict(b=4))])
    rng = np.random.default_rng(5)
    x, xb, _, _, ops = _case(tp, rng, S=5, carry=False)      # S < n
    got = api.run(tp, x, h1v_b=xb, operands=ops, device="cpu")
    assert got["bl"].tolist() == [0, 0, 0]
    assert not got["card"].any()
    x, xb, _, _, ops = _case(tp, rng, carry=False)
    with pytest.raises(ValueError, match="needs a second stream h1v_b"):
        api.run(tp, x, operands=ops, device="cpu")
    with pytest.raises(ValueError, match="h1v_b shape"):
        api.run(tp, x, h1v_b=xb[:, :-1], operands=ops, device="cpu")
    with pytest.raises(ValueError, match="operand 'bits' shape"):
        api.run(tp, x, h1v_b=xb, device="cpu",
                operands={**ops, "bl": {"bits": ops["bl"]["bits"][:3]}})
    with pytest.raises(ValueError, match="init carry shape"):
        api.run(tp, x, h1v_b=xb, device="cpu",
                operands={**ops, "card": {"init": np.zeros(15, np.int32)}})
    _, mh = _plans("cyclic", 8, 32, [("sig", "minhash", dict(k=4))])
    with pytest.raises(ValueError, match="no sketch in the plan consumes"):
        api.run(mh, x, h1v_b=xb, device="cpu",
                operands={"sig": {"a": np.ones(4), "b": np.ones(4)}})
    _, cm = _plans("cyclic", 8, 32, [("f", "cms", dict(depth=3,
                                                       log2_width=6))])
    with pytest.raises(ValueError, match=r"operand 'a' shape \(4,\) != \(3,\)"):
        api.run(cm, x, device="cpu",
                operands={"f": {"a": np.ones(4), "b": np.ones(3)}})


def test_kernel_matches_plain_on_card(cuda):
    sketches = [("sig", "minhash", dict(k=64)), ("card", "hll", dict(b=12)),
                ("freq", "cms", dict(depth=4, log2_width=16)),
                ("bl", "bloom", dict(k=4, log2_m=20))]
    for family in ("cyclic", "general"):
        _, tp = _plans(family, 8, 32, sketches)
        x, xb, nw, ws, ops = _case(tp, np.random.default_rng(6), B=16,
                                   S=600)
        before = sketch_fused.LAUNCHES
        kw = dict(h1v_b=xb, n_windows=nw, w_start=ws, operands=ops,
                  device=cuda)
        got = api.run(tp, x, impl="kernel", **kw)
        want = api.run(tp, x, impl="ref", **kw)
        assert sketch_fused.LAUNCHES == before + 1
        for name in got:
            assert torch.equal(got[name], want[name]), name


def test_donated_init_is_checked():
    """sketch_plan_fused(donate=True) hands each init to the kernel as its
    output, so an init of the wrong shape, type or device is rejected (on
    the CPU as on the card); a right one gives the undonated result."""
    _, tp = _plans("cyclic", 5, 32, [("hll", "hll", {"b": 6}),
                                     ("cms", "cms", {"depth": 2,
                                                     "log2_width": 8})])
    rng = np.random.default_rng(3)
    x, _, nw, ws, ops = _case(tp, rng)
    x, nw = torch.from_numpy(x), torch.from_numpy(nw)
    ops = {n: {k: torch.from_numpy(v) for k, v in o.items()}
           for n, o in ops.items()}
    run = lambda o, **kw: sketch_fused.sketch_plan_fused(
        x, None, nw, o, plan=tp, **kw)
    want = run(ops)
    got = run({n: {k: v.clone() for k, v in o.items()}
               for n, o in ops.items()}, donate=True)
    for name in want:
        assert torch.equal(got[name], want[name])
    hll_init = ops["hll"]["init"]
    for bad, match in ((hll_init[:-1], "shape"),
                       (hll_init.to(torch.int64), "dtype"),
                       (hll_init.to("meta"), "expected cpu"),
                       (hll_init.numpy(), "must be a tensor")):
        with pytest.raises((ValueError, TypeError), match=match):
            run({**ops, "hll": {"init": bad}}, donate=True)


def test_tile_looping_grid_matches_plain_on_card(cuda):
    """The grid holds fewer blocks than tiles: few rows of many segments
    (B = 8 at S = 70,000, and B = 1 at S = 300,000), ragged n_windows and
    w_start, HLL in shared memory (b = 4, 12, 14) and in global memory
    (b = 15, 16), both families, a four-sketch plan, and donated
    carries."""
    rng = np.random.default_rng(11)
    for family in ("cyclic", "general"):
        for b in (4, 12, 14, 15, 16):
            sketches = [("sig", "minhash", {"k": 16}), ("hll", "hll",
                                                        {"b": b}),
                        ("cms", "cms", {"depth": 4, "log2_width": 16}),
                        ("bloom", "bloom", {"k": 4, "log2_m": 16})]
            _, tp = _plans(family, 8, 32, sketches)
            for B, S in ((8, 70_000), (1, 300_000), (1024, 519)):
                x, xb, _, _, ops = _case(tp, rng, B=B, S=S)
                W = S - 8 + 1
                nw = rng.integers(W // 2, W + 1, size=B).astype(np.int32)
                ws = rng.integers(0, 9, size=B).astype(np.int32)
                if B > 2:
                    nw[B // 2] = 0                     # an idle row
                args = [torch.from_numpy(a).to(cuda) for a in (x, xb, nw, ws)]
                ops = {n: {k: torch.from_numpy(v).to(cuda)
                           for k, v in o.items()} for n, o in ops.items()}
                want = sketch_fused.sketch_plan_fused(
                    *[a.cpu() for a in args[:3]],
                    {n: {k: v.cpu() for k, v in o.items()}
                     for n, o in ops.items()}, plan=tp, w_start=args[3].cpu())
                for donate in (False, True):
                    o = {n: {k: v.clone() for k, v in d.items()}
                         for n, d in ops.items()}
                    got = sketch_fused.sketch_plan_fused(
                        *args[:3], o, plan=tp, w_start=args[3], donate=donate)
                    for name in want:
                        assert torch.equal(got[name].cpu(), want[name]), (
                            family, b, B, S, donate, name)
                        assert donate == (got[name].data_ptr()
                                          == o[name]["init"].data_ptr())


def test_plan_row_past_65535_segments_on_card(cuda):
    """One row of 65,600 segments of 1,024 windows (a row this long keeps
    the longest segment): more than the 65,535 a grid dimension holds, which
    bounded a row while a block took one (row, segment). The stats plan,
    against its plain version on the card."""
    _, tp = _plans("cyclic", 8, 32, [("hll", "hll", {"b": 12}),
                                     ("cms", "cms", {"depth": 4,
                                                     "log2_width": 16})])
    gen = torch.Generator(device=cuda).manual_seed(2)
    S = 65_600 * 1024 + 7
    x = torch.randint(0, 1 << 32, (1, S), generator=gen, device=cuda,
                      dtype=torch.int64).to(torch.uint32)
    nw = torch.full((1,), S - 7, dtype=torch.int32, device=cuda)
    ws = torch.full((1,), 3, dtype=torch.int32, device=cuda)
    ops = {"hll": {}, "cms": {
        "a": torch.randint(0, 1 << 32, (4,), generator=gen, device=cuda,
                           dtype=torch.int64).to(torch.uint32),
        "b": torch.randint(0, 1 << 32, (4,), generator=gen, device=cuda,
                           dtype=torch.int64).to(torch.uint32)}}
    got = api.run(tp, x, n_windows=nw, w_start=ws, operands=ops,
                  impl="kernel")
    want = api.run(tp, x, n_windows=nw, w_start=ws, operands=ops, impl="ref")
    for name in want:
        assert torch.equal(got[name], want[name]), name
