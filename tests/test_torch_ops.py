"""repro_torch.kernels.ops.cyclic and .general against the JAX package's
ops, bit for bit.

The plain path (``impl="ref"``, and ``"auto"`` on CPU tensors) is held
against the reference's jnp oracles over n in {1, 2, 5, 8, 25, 32} and L
in {16, 32}, and one small case per family against the reference's Pallas
kernels in interpret mode. The CUDA kernels (``csrc/rolling.cu``) run
only on the card: their case skips without one, and ``chip_smoke.py``
holds them against the plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import gf2
from repro_torch.kernels import cyclic, general, ops

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernels "
                    "there)")
    return torch.device("cuda")


def _x(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                                dtype=np.uint32)


def _both(family, x, n, L, **jkw):
    """(port result as numpy, reference result as numpy)."""
    if family == "cyclic":
        got = ops.cyclic(x, n=n, L=L, device="cpu")
        want = jops.cyclic(jnp.asarray(x), n=n, L=L, **jkw)
    else:
        p = gf2.find_irreducible_host(L)
        got = ops.general(x, n=n, p=p, L=L, device="cpu")
        want = jops.general(jnp.asarray(x), n=n, p=p, L=L, **jkw)
    assert got.dtype == torch.uint32 and got.device.type == "cpu"
    return got.numpy(), np.asarray(want)


_CASES = [(n, L) for n in (1, 2, 5, 8, 25, 32) for L in (16, 32) if n <= L]
# n > L: every rotation is taken mod L (the reference's degraded regime),
# which the card's rolling kernels take too
_WIDE = [(9, 8), (20, 16), (33, 32)]


@pytest.mark.parametrize("family", ["cyclic", "general"])
@pytest.mark.parametrize("n,L", _CASES)
def test_rolling_hash_matches_reference(family, n, L):
    x = _x((3, 100), seed=10 * n + L)
    got, want = _both(family, x, n, L, impl="ref")
    assert got.shape == (3, 100 - n + 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", ["cyclic", "general"])
@pytest.mark.parametrize("n,L", _WIDE)
def test_rolling_hash_matches_reference_above_L(family, n, L):
    x = _x((3, 100), seed=10 * n + L)
    got, want = _both(family, x, n, L, impl="ref")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_rolling_hash_matches_reference_pallas_interpret(family):
    x = _x((2, 40), seed=1)
    got, want = _both(family, x, 5, 32, impl="pallas")
    np.testing.assert_array_equal(got, want)


def test_leading_dims_impls_and_validation():
    x = _x((2, 3, 30), seed=2)
    p = gf2.find_irreducible_host(32)
    for impl in ("ref", "auto"):
        c = ops.cyclic(torch.from_numpy(x), n=4, impl=impl)
        g = ops.general(torch.from_numpy(x), n=4, p=p, impl=impl)
        assert tuple(c.shape) == tuple(g.shape) == (2, 3, 27)
        np.testing.assert_array_equal(
            c.numpy(), np.asarray(jops.cyclic(jnp.asarray(x), n=4,
                                              impl="ref")))
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jops.general(jnp.asarray(x), n=4, p=p,
                                               impl="ref")))
    # the wrappers take the plain version on a CPU tensor
    t = torch.from_numpy(x[0])
    assert torch.equal(cyclic.cyclic_rolling(t, n=4), ops.cyclic(t, n=4))
    assert torch.equal(general.general_rolling(t, n=4, p=p),
                       ops.general(t, n=4, p=p))
    with pytest.raises(ValueError, match="sequence length 3 < window n=4"):
        ops.cyclic(x[..., :3], n=4, device="cpu")
    with pytest.raises(ValueError, match="impl='kernel'"):
        ops.general(x, n=4, p=p, impl="kernel", device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.cyclic(x, n=4, impl="pallas", device="cpu")
    meta = torch.zeros((2, 40), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        cyclic.cyclic_rolling(meta, n=4)


def test_kernels_match_plain_on_card(cuda):
    x = torch.from_numpy(_x((5, 9000), seed=3)).to(cuda)
    for n, L in ((1, 16), (8, 32), (25, 32), (32, 32)):
        p = gf2.find_irreducible_host(L)
        c0, g0 = cyclic.LAUNCHES, general.LAUNCHES
        assert torch.equal(ops.cyclic(x, n=n, L=L, impl="kernel"),
                           ops.cyclic(x, n=n, L=L, impl="ref"))
        assert torch.equal(ops.general(x, n=n, p=p, L=L, impl="kernel"),
                           ops.general(x, n=n, p=p, L=L, impl="ref"))
        assert (cyclic.LAUNCHES, general.LAUNCHES) == (c0 + 1, g0 + 1)


def test_kernels_match_plain_on_card_above_L(cuda):
    """n > L on the card: the first window's rotations reduce mod L and the
    shared halo is sized for n above 32."""
    x = torch.from_numpy(_x((5, 9000), seed=4)).to(cuda)
    for n, L in _WIDE + [(100, 32)]:
        p = gf2.find_irreducible_host(L)
        assert torch.equal(ops.cyclic(x, n=n, L=L, impl="kernel"),
                           ops.cyclic(x, n=n, L=L, impl="ref"))
        assert torch.equal(ops.general(x, n=n, p=p, L=L, impl="kernel"),
                           ops.general(x, n=n, p=p, L=L, impl="ref"))
