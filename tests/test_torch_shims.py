# lint: allow-deprecated-shims — this suite certifies the shims against the
# reference's, the module shim included
"""The deprecated single-sketch shims against the JAX package's, bit for
bit.

* ``ops.cyclic_minhash``, ``cyclic_hll`` and ``cyclic_bloom`` (one-sketch
  plans over ``api.run``) against the reference's, through its plain path
  (``impl="ref"``) and its Pallas kernel in interpret mode, with and
  without the Theorem-1 discard;
* the wrappers ``sketch_fused.cyclic_minhash_fused``, ``cyclic_hll_fused``
  and ``cyclic_bloom_fused`` (a raw ``hash_mask``) against the reference's
  in interpret mode;
* the oracles ``ref.minhash_fused_ref``, ``hll_fused_ref`` and
  ``bloom_fused_ref`` against the reference's oracles;
* the deprecation warnings, and the module shim
  ``repro_torch.kernels.cyclic_fused`` (a re-export that warns).

Inputs are numpy draws from seeded generators, B = 4 rows of S = 320
symbols with random ``n_windows``. The kernels' side (each shim through the
plan kernel on the card, one launch a call) is in
``tests/test_torch_on_card.py`` and ``chip_smoke.py``.
"""
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sketch_fused as jsf
from repro_torch.kernels import ops, ref, sketch_fused

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

B, S, N = 4, 320, 8
TILE = dict(block_b=2, block_s=256)   # the reference's Pallas tiles


def _draws(seed, log2_m=14):
    rng = np.random.default_rng(seed)
    u32 = lambda *shape: rng.integers(0, 2**32, shape, dtype=np.uint32)
    return {"x": u32(B, S), "xb": u32(B, S), "a": u32(16), "b": u32(16),
            "bits": u32(1 << (log2_m - 5)) | u32(1 << (log2_m - 5)),
            "nw": rng.integers(0, S - N + 2, B).astype(np.int32)}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _port_shim(shim, d, discard):
    if shim == "minhash":
        return ops.cyclic_minhash(d["x"], d["a"], d["b"], n=N,
                                  n_windows=d["nw"], discard=discard,
                                  device="cpu")
    if shim == "hll":
        return ops.cyclic_hll(d["x"], n=N, b=10, n_windows=d["nw"],
                              discard=discard, device="cpu")
    return ops.cyclic_bloom(d["x"], d["xb"], d["bits"], n=N, k=3, log2_m=14,
                            n_windows=d["nw"], discard=discard, device="cpu")


def _ref_shim(shim, d, discard, impl):
    j = _j(d)
    tile = TILE if impl == "pallas" else {}
    if shim == "minhash":
        return jops.cyclic_minhash(j["x"], j["a"], j["b"], n=N,
                                   n_windows=j["nw"], discard=discard,
                                   impl=impl, **tile)
    if shim == "hll":
        return jops.cyclic_hll(j["x"], n=N, b=10, n_windows=j["nw"],
                               discard=discard, impl=impl, **tile)
    return jops.cyclic_bloom(j["x"], j["xb"], j["bits"], n=N, k=3, log2_m=14,
                             n_windows=j["nw"], discard=discard, impl=impl,
                             **tile)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
@pytest.mark.parametrize("discard", [True, False])
@pytest.mark.parametrize("shim", ["minhash", "hll", "bloom"])
@pytest.mark.filterwarnings("ignore:ops.cyclic_:DeprecationWarning")
def test_ops_shims_match_reference(shim, discard, impl):
    d = _draws(seed=len(shim) + 10 * discard)
    got = _port_shim(shim, d, discard)
    want = np.asarray(_ref_shim(shim, d, discard, impl))
    assert got.device.type == "cpu" and got.dtype == {
        "minhash": torch.uint32, "hll": torch.int32,
        "bloom": torch.int32}[shim]
    np.testing.assert_array_equal(got.numpy(), want)
    if shim == "bloom":
        assert want.max() > 0        # a dense filter: real hits


@pytest.mark.parametrize("n", [1, 5, 8, 25])
@pytest.mark.parametrize("discard", [True, False])
def test_fused_wrappers_match_reference(n, discard):
    d = _draws(seed=n)
    nw = np.minimum(d["nw"], S - n + 1).astype(np.int32)
    hm = (1 << (32 - n + 1)) - 1 if discard else 0xFFFFFFFF
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    tnw, jnw = torch.from_numpy(nw), jnp.asarray(nw)
    j = _j(d)
    got = sketch_fused.cyclic_minhash_fused(t["x"], tnw, t["a"], t["b"], n=n,
                                            hash_mask=hm)
    want = jsf.cyclic_minhash_fused(j["x"], jnw, j["a"], j["b"], n=n,
                                    hash_mask=hm, interpret=True, **TILE)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    b = 6
    rank_bits = (32 - n + 1 if discard else 32) - b
    got = sketch_fused.cyclic_hll_fused(t["x"], tnw, n=n, b=b,
                                        rank_bits=rank_bits, hash_mask=hm)
    want = jsf.cyclic_hll_fused(j["x"], jnw, n=n, b=b, rank_bits=rank_bits,
                                hash_mask=hm, interpret=True, **TILE)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = sketch_fused.cyclic_bloom_fused(t["x"], t["xb"], tnw, t["bits"],
                                          n=n, k=3, log2_m=14, hash_mask=hm)
    want = jsf.cyclic_bloom_fused(j["x"], j["xb"], jnw, j["bits"], n=n, k=3,
                                  log2_m=14, hash_mask=hm, interpret=True,
                                  **TILE)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,L", [(1, 32), (8, 32), (25, 32), (5, 16)])
def test_oracles_match_reference_oracles(n, L):
    d = _draws(seed=100 + n)
    x, xb = d["x"] & ((1 << L) - 1), d["xb"] & ((1 << L) - 1)
    nw = np.minimum(d["nw"], S - n + 1).astype(np.int32)
    for hm in ((1 << (L - n + 1)) - 1, 0xFFFFFFFF):
        got = ref.minhash_fused_ref(x, nw, d["a"], d["b"], n=n, L=L,
                                    hash_mask=hm)
        want = jref.minhash_fused_ref(jnp.asarray(x), jnp.asarray(nw),
                                      jnp.asarray(d["a"]),
                                      jnp.asarray(d["b"]), n=n, L=L,
                                      hash_mask=hm)
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = ref.hll_fused_ref(x, nw, n=n, b=5, rank_bits=L - n + 1 - 5,
                                L=L, hash_mask=hm)
        want = jref.hll_fused_ref(jnp.asarray(x), jnp.asarray(nw), n=n, b=5,
                                  rank_bits=L - n + 1 - 5, L=L, hash_mask=hm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = ref.bloom_fused_ref(x, xb, nw, d["bits"], n=n, k=3, log2_m=14,
                                  L=L, hash_mask=hm)
        want = jref.bloom_fused_ref(jnp.asarray(x), jnp.asarray(xb),
                                    jnp.asarray(nw), jnp.asarray(d["bits"]),
                                    n=n, k=3, log2_m=14, L=L, hash_mask=hm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,L,hm", [(8, 32, (1 << 25) - 1),
                                    (8, 32, 0xFFFFFFFF), (4, 16, 0xFFFF),
                                    (4, 16, (1 << 13) - 1)])
def test_legacy_hash_spec_matches_reference(n, L, hm):
    got = sketch_fused._legacy_hash_spec(n, L, hm)
    want = jsf._legacy_hash_spec(n, L, hm)
    assert (got.family, got.n, got.L, got.discard, got.hash_mask) == (
        want.family, want.n, want.L, want.discard, want.hash_mask)


def test_legacy_hash_spec_refuses_other_masks():
    with pytest.raises(ValueError, match="matches neither"):
        sketch_fused._legacy_hash_spec(8, 32, 0xFFFF)
    with pytest.raises(ValueError, match="bits must have shape"):
        sketch_fused.cyclic_bloom_fused(
            torch.zeros((1, 16), dtype=torch.uint32),
            torch.zeros((1, 16), dtype=torch.uint32),
            torch.full((1,), 9, dtype=torch.int32),
            torch.zeros((3,), dtype=torch.uint32), n=8, k=2, log2_m=10)


@pytest.mark.parametrize("shim", ["minhash", "hll", "bloom"])
def test_ops_shims_warn(shim):
    d = _draws(seed=7)
    with pytest.warns(DeprecationWarning,
                      match=f"ops.cyclic_{shim} is deprecated"):
        _port_shim(shim, d, True)


def test_cyclic_fused_module_is_a_deprecation_shim():
    """The module re-exports the byte path's wrapper and SIGMA, warns on
    import, and its wrapper equals the reference's module shim (Pallas in
    interpret mode) on the same bytes."""
    with pytest.warns(DeprecationWarning,
                      match="repro_torch.kernels.cyclic_fused is deprecated"):
        shim = importlib.reload(
            importlib.import_module("repro_torch.kernels.cyclic_fused"))
    assert shim.cyclic_rolling_fused is sketch_fused.cyclic_rolling_fused
    assert shim.SIGMA == sketch_fused.SIGMA == 256
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jshim = importlib.import_module("repro.kernels.cyclic_fused")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (3, 300)).astype(np.int32)
    table = rng.integers(0, 2**32, 256, dtype=np.uint32)
    got = shim.cyclic_rolling_fused(torch.from_numpy(tokens),
                                    torch.from_numpy(table), n=8)
    want = jshim.cyclic_rolling_fused(jnp.asarray(tokens),
                                      jnp.asarray(table), n=8,
                                      interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
