"""repro_torch.kernels.api.run against repro.kernels.api.run, bit for bit.

The port's plain path (``impl="ref"``, and ``"auto"`` on CPU tensors) is
held against the reference's jnp executor over both families, k in
{1, 16, 64, 100}, padded ``n_windows``, ``w_start``, ``init`` carries and
``S < n``; one small case per family also against the reference's Pallas
kernel in interpret mode. The CUDA kernel itself runs only on the card:
its case here skips without one, and ``chip_smoke.py`` holds it against
the plain version at the dedup path's shapes.
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


def _plans(family, n, sketches):
    j = jplan.SketchPlan(jplan.HashSpec(family=family, n=n, L=32),
                         tuple((nm, jplan.MinHashSpec(k=k))
                               for nm, k in sketches))
    t = tplan.SketchPlan(tplan.HashSpec(family=family, n=n, L=32),
                         tuple((nm, tplan.MinHashSpec(k=k))
                               for nm, k in sketches))
    return j, t


def _case(kind, k, n, seed):
    """Inputs for one case as numpy: h1v, n_windows, w_start, operands."""
    rng = np.random.default_rng(seed)
    B, S = (3, 5) if kind == "short" else (3, 200)
    x = rng.integers(0, 1 << 32, size=(B, S), dtype=np.uint32)
    ops = {"a": rng.integers(0, 1 << 32, size=k, dtype=np.uint32) | 1,
           "b": rng.integers(0, 1 << 32, size=k, dtype=np.uint32)}
    W = max(0, S - n + 1)
    nw = ws = None
    if kind in ("padded", "carry"):
        nw = np.array([0, W // 2, W + 9], np.int32)     # over-long clamps
    if kind == "carry":
        ws = np.array([3, 0, W - 5], np.int32)
        ops["init"] = rng.integers(0, 1 << 32, size=(B, k), dtype=np.uint32)
    return x, nw, ws, ops


def _jrun(jp, x, nw, ws, ops, name="sig", **kw):
    j = lambda a: None if a is None else jnp.asarray(a)
    out = japi.run(jp, j(x), n_windows=j(nw), w_start=j(ws),
                   operands={name: {k: j(v) for k, v in ops.items()}}, **kw)
    return np.asarray(out[name])


@pytest.mark.parametrize("family", ["cyclic", "general"])
@pytest.mark.parametrize("k", [1, 16, 64, 100])
@pytest.mark.parametrize("kind", ["plain", "padded", "carry", "short"])
def test_run_ref_matches_reference(family, k, kind):
    n = 8
    jp, tp = _plans(family, n, [("sig", k)])
    x, nw, ws, ops = _case(kind, k, n, seed=k)
    want = _jrun(jp, x, nw, ws, ops, impl="ref")
    for impl in ("ref", "auto"):
        got = api.run(tp, x, n_windows=nw, w_start=ws,
                      operands={"sig": ops}, impl=impl, device="cpu")["sig"]
        assert got.dtype == torch.uint32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    if kind == "short":
        assert (want == 0xFFFFFFFF).all()


@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_run_matches_reference_pallas_interpret(family):
    n, k = 8, 16
    jp, tp = _plans(family, n, [("sig", k)])
    x, nw, ws, ops = _case("carry", k, n, seed=5)
    want = _jrun(jp, x, nw, ws, ops, impl="pallas", block_b=2, block_s=128)
    got = api.run(tp, torch.from_numpy(x), n_windows=nw, w_start=ws,
                  operands={"sig": ops})["sig"]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 25])
def test_window_edge_cases_match(n):
    # n = 1 has no halo; n = 25 is the paper's longest window
    jp, tp = _plans("cyclic", n, [("sig", 32)])
    x, nw, ws, ops = _case("carry", 32, n, seed=n)
    np.testing.assert_array_equal(
        api.run(tp, x, n_windows=nw, w_start=ws, operands={"sig": ops},
                device="cpu")["sig"].numpy(),
        _jrun(jp, x, nw, ws, ops, impl="ref"))


def test_multi_sketch_plan_and_leading_dims_match():
    sketches = [("s1", 16), ("s2", 40)]
    jp, tp = _plans("general", 5, sketches)
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 32, size=(2, 3, 120), dtype=np.uint32)
    ops = {nm: {"a": rng.integers(0, 1 << 32, size=k, dtype=np.uint32) | 1,
                "b": rng.integers(0, 1 << 32, size=k, dtype=np.uint32)}
           for nm, k in sketches}
    want = japi.run(jp, jnp.asarray(x), impl="ref",
                    operands={nm: {o: jnp.asarray(v) for o, v in d.items()}
                              for nm, d in ops.items()})
    got = api.run(tp, x, operands=ops, device="cpu")
    for nm, k in sketches:
        assert tuple(got[nm].shape) == (2, 3, k)
        np.testing.assert_array_equal(got[nm].numpy(), np.asarray(want[nm]))


def test_run_validation():
    _, tp = _plans("cyclic", 8, [("sig", 16)])
    x, _, _, ops = _case("plain", 16, 8, seed=1)
    with pytest.raises(ValueError, match="unknown impl"):
        api.run(tp, x, operands={"sig": ops}, impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="needs operands"):
        api.run(tp, x, operands={"sig": {"a": ops["a"]}}, device="cpu")
    with pytest.raises(ValueError, match="operand 'b' shape"):
        api.run(tp, x, operands={"sig": {**ops, "b": ops["b"][:3]}},
                device="cpu")
    with pytest.raises(ValueError, match="init carry shape"):
        api.run(tp, x, operands={"sig": {**ops, "init": np.zeros((2, 16))}},
                device="cpu")
    with pytest.raises(ValueError, match="n_windows must be non-negative"
                                         ".*row 1 has -4"):
        api.run(tp, x, n_windows=np.array([1, -4, 2]),
                operands={"sig": ops}, device="cpu")


def test_unported_epilogues_raise():
    plan = tplan.SketchPlan(tplan.HashSpec(family="cyclic", n=8),
                            (("card", tplan.HLLSpec(b=8)),))
    with pytest.raises(NotImplementedError, match="HLLSpec epilogue"):
        api.run(plan, np.zeros((2, 40), np.uint32), device="cpu")


def test_kernel_matches_plain_on_card(cuda):
    for family in ("cyclic", "general"):
        _, tp = _plans(family, 8, [("sig", 64)])
        x, nw, ws, ops = _case("carry", 64, 8, seed=3)
        before = sketch_fused.LAUNCHES
        got = api.run(tp, x, n_windows=nw, w_start=ws,
                      operands={"sig": ops}, impl="kernel", device=cuda)
        want = api.run(tp, x, n_windows=nw, w_start=ws,
                       operands={"sig": ops}, impl="ref", device=cuda)
        assert sketch_fused.LAUNCHES == before + 1
        assert torch.equal(got["sig"], want["sig"])
