"""The port's decode plane (``api.decode``: candidate hashing, the
Theorem-2 discard, no-repeat and canary Bloom probes, logit masking)
against the JAX package's, on the same numpy inputs.

The reference runs as tests/test_serve_plane.py runs it: the Pallas kernel
in interpret mode (``impl="pallas"``) and its jnp oracle (``impl="ref"``).
The port's plain version must equal both bit for bit: masked logits,
packed banned words and packed canary words, over the cases of
tests/test_serve_plane.py:55-160 — n in {2, 4, 8, 33} (33 > L is the
degraded regime), V in {1000, 4096} (1000 is no multiple of 32), L in {32,
20, 9}, canary on and off, rows that are not ready — and with the same
validation errors. The CUDA kernel runs only on the card: its case skips
here, and ``chip_smoke.py`` holds it against the plain version there.
"""
import numpy as np
import pytest
import torch

from repro.kernels import api as japi
from repro.kernels.plan import DecodeSpec as JDecodeSpec
from repro_torch.kernels import api, decode, ref
from repro_torch.kernels.plan import DecodeSpec

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py checks the kernel "
                    "there)")
    return torch.device("cuda")


def _inputs(rng, spec, B, V, ready=None):
    """Logits, prefix, ready, half-full filters, h1 and a half-full canary
    filter, so probes both hit and miss."""
    logits = rng.standard_normal((B, V)).astype(np.float32)
    prefix = rng.integers(0, 2**32, size=B, dtype=np.uint32)
    if ready is None:
        ready = rng.integers(0, 2, size=B).astype(bool)
    dense = lambda shape: (rng.integers(0, 2**32, size=shape, dtype=np.uint32)
                           | rng.integers(0, 2**32, size=shape,
                                          dtype=np.uint32))
    bloom = dense((B, spec.n_words))
    h1 = rng.integers(0, 2**32, size=V, dtype=np.uint32)
    canary = dense((spec.canary_words,)) if spec.has_canary else None
    return logits, prefix, ready, bloom, h1, canary


def _specs(**kw):
    return JDecodeSpec(**kw), DecodeSpec(**kw)


def _assert_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == (torch.float32 if key == "logits"
                                  else torch.uint32), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("n", [2, 4, 8, 33])
@pytest.mark.parametrize("V", [1000, 4096])
@pytest.mark.parametrize("canary", [0, 10])
def test_decode_matches_reference(n, V, canary):
    jspec, spec = _specs(n=n, L=32, log2_m=10, k=2, canary_log2_m=canary)
    rng = np.random.default_rng(n * 1000 + V + canary)
    logits, prefix, ready, bloom, h1, cb = _inputs(rng, spec, 9, V)
    want = japi.decode(jspec, logits, prefix, ready, bloom, h1,
                       canary_bits=cb, impl="ref")
    got = api.decode(spec, logits, prefix, ready, bloom, h1, canary_bits=cb,
                     device="cpu")
    _assert_equal(got, want)
    assert np.asarray(want["banned"]).any()      # the case bans something


@pytest.mark.parametrize("L", [32, 20, 9])
@pytest.mark.parametrize("n", [4, 33])
def test_decode_narrow_hash_matches_pallas(L, n):
    """The Pallas kernel itself (interpret mode), at L < 32 and in the
    degraded regime, with the ready flags given as ints."""
    jspec, spec = _specs(n=n, L=L, log2_m=8, k=3, canary_log2_m=9)
    rng = np.random.default_rng(L * 100 + n)
    logits, prefix, ready, bloom, h1, cb = _inputs(rng, spec, 5, 1000)
    ready = ready.astype(np.int32) * 3
    want = japi.decode(jspec, logits, prefix, ready, bloom, h1,
                       canary_bits=cb, impl="pallas")
    got = api.decode(spec, torch.from_numpy(logits), prefix,
                     torch.from_numpy(ready), bloom, h1, canary_bits=cb)
    _assert_equal(got, want)


def test_not_ready_rows_ban_nothing():
    jspec, spec = _specs(n=3, log2_m=6, canary_log2_m=6)
    rng = np.random.default_rng(1)
    logits, prefix, _, _, h1, _ = _inputs(rng, spec, 3, 64)
    full = np.full((3, spec.n_words), 0xFFFFFFFF, np.uint32)     # bans all
    cb = np.full((spec.canary_words,), 0xFFFFFFFF, np.uint32)
    ready = np.array([True, False, True])
    want = japi.decode(jspec, logits, prefix, ready, full, h1,
                       canary_bits=cb, impl="ref")
    got = api.decode(spec, logits, prefix, ready, full, h1, canary_bits=cb,
                     device="cpu")
    _assert_equal(got, want)
    assert got["banned"][0].numpy().all() and not got["banned"][1].any()
    assert not got["canary"][1].any()
    np.testing.assert_array_equal(got["logits"][1].numpy(), logits[1])
    # banned logits are float32(-1e30) exactly
    assert (got["logits"][0] == np.float32(ref.NEG_LOGIT)).all()


def test_packed_mask_tail_is_zero():
    """V = 1000 ends mid-word: the last word's 8 tail bits stay zero even
    when every probe hits."""
    _, spec = _specs(n=2, log2_m=5)
    rng = np.random.default_rng(2)
    logits, prefix, _, _, h1, _ = _inputs(rng, spec, 2, 1000)
    out = api.decode(spec, logits, prefix, np.ones(2, bool),
                     np.full((2, 1), 0xFFFFFFFF, np.uint32), h1, device="cpu")
    words = out["banned"].to(torch.int64).numpy()
    assert words.shape == (2, 32)
    assert (words[:, :-1] == 0xFFFFFFFF).all()
    assert (words[:, -1] == 0xFF).all()


def test_theorem2_discard_high_bits_never_probed():
    _, spec = _specs(n=6, L=32, log2_m=10)
    high = np.uint32(~spec.hash_mask & 0xFFFFFFFF)
    rng = np.random.default_rng(7)
    logits, prefix, ready, bloom, h1, _ = _inputs(rng, spec, 6, 300)
    flip = rng.integers(0, 2**32, size=300, dtype=np.uint32) & high
    a = api.decode(spec, logits, prefix, ready, bloom, h1, device="cpu")
    b = api.decode(spec, logits, prefix, ready, bloom, h1 ^ flip,
                   device="cpu")
    assert torch.equal(a["banned"], b["banned"])


def test_decode_rejects_bad_args_like_reference():
    rng = np.random.default_rng(3)
    _, spec = _specs(n=3, log2_m=6)
    logits, prefix, ready, bloom, h1, _ = _inputs(rng, spec, 2, 40)
    # (error, message, spec or "canary" for the canary spec, arguments,
    # keywords)
    cases = [
        (TypeError, "DecodeSpec", object(), (logits, prefix, ready, bloom,
                                             h1), {}),
        (ValueError, "bloom words shape", None, (logits, prefix, ready,
                                                 bloom[:, :-1], h1), {}),
        (ValueError, "prefix shape", None, (logits, prefix[:-1], ready,
                                            bloom, h1), {}),
        (ValueError, "h1 shape", None, (logits, prefix, ready, bloom,
                                        h1[:-1]), {}),
        (ValueError, "canary_bits given", None,
         (logits, prefix, ready, bloom, h1),
         {"canary_bits": np.zeros(2, np.uint32)}),
        (ValueError, "pass", "canary", (logits, prefix, ready, bloom, h1),
         {}),
    ]
    for mod, Spec, extra in ((japi, JDecodeSpec, {}),
                             (api, DecodeSpec, {"device": "cpu"})):
        specs = {None: Spec(n=3, log2_m=6),
                 "canary": Spec(n=3, log2_m=6, canary_log2_m=8)}
        for exc, match, which, args, kw in cases:
            sp = specs[which] if which in (None, "canary") else which
            with pytest.raises(exc, match=match):
                mod.decode(sp, *args, **kw, **extra)


def test_kernel_impl_needs_a_card():
    _, spec = _specs(n=3, log2_m=6)
    rng = np.random.default_rng(4)
    logits, prefix, ready, bloom, h1, _ = _inputs(rng, spec, 2, 40)
    before = decode.LAUNCHES
    with pytest.raises(ValueError, match="impl='kernel'"):
        api.decode(spec, logits, prefix, ready, bloom, h1, impl="kernel",
                   device="cpu")
    # the wrapper itself takes the plain version on a CPU tensor only
    out = decode.decode_masks_fused(
        torch.from_numpy(logits), torch.from_numpy(prefix),
        torch.from_numpy(ready), torch.from_numpy(bloom),
        torch.from_numpy(h1), spec=spec)
    assert out["banned"].shape == (2, 2) and decode.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA or CPU tensors"):
        decode.decode_masks_fused(
            torch.zeros((2, 40), device="meta"), *[None] * 4, spec=spec)


def test_kernel_matches_plain_on_card(cuda):
    for canary in (0, 20):
        _, spec = _specs(n=4, L=32, log2_m=14, k=2, canary_log2_m=canary)
        rng = np.random.default_rng(5 + canary)
        args = _inputs(rng, spec, 16, 1000)
        dev = [torch.from_numpy(a).to(cuda) if a is not None else None
               for a in args]
        got = api.decode(spec, *dev[:5], canary_bits=dev[5], impl="kernel")
        want = api.decode(spec, *dev[:5], canary_bits=dev[5], impl="ref")
        for key in want:
            assert torch.equal(got[key], want[key]), key
