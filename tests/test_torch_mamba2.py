"""The port's Mamba-2 mixer (``repro_torch.nn.mamba2``) against the JAX
package's ``repro.nn.mamba2``: the depthwise causal conv with and without
history, the chunked SSD (against the reference, against the naive
recurrence, across chunk sizes, with an initial state and a padded
sequence, its gradients finite where the mask comes before the exp), the
forward with its cache, several decode steps against the reference's and
against the forward, and the gradients of the whole mixer.

Weights are the reference's ``mamba_init`` draw carried across by
``convert.lm_params_from_jax``; inputs come from seeded numpy generators;
float32 parameters and activations. Tolerances: the conv is the same
float32 multiply-adds in the same order, so atol/rtol 1e-6; the SSD and
the mixer sum in another order (matrix products from other libraries),
atol/rtol 1e-5, and the reference's own 2e-4 against the naive recurrence
(1e-4 / 1e-5 across chunk sizes); gradients within 1e-5 of their largest
magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.nn import mamba2 as jmamba
from repro.nn.sharding import unzip
from repro_torch import convert
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.nn import mamba2

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
# d_inner 64 = 4 heads of 16, N 8, conv 4, chunks of 16
_BASE = dict(name="m", n_layers=1, d_model=32, vocab=64, ssm_state=8,
             ssm_conv=4, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
             use_rope=False, param_dtype="float32",
             activation_dtype="float32")


def _cfgs(**kw):
    kw = {**_BASE, **kw}
    return (JModelConfig(unit=(JLayerSpec("mamba", "none"),), **kw),
            ModelConfig(unit=(LayerSpec("mamba", "none"),), **kw))


def _carried(**kw):
    jcfg, cfg = _cfgs(**kw)
    values, _ = unzip(jmamba.mamba_init(jax.random.PRNGKey(0), jcfg))
    params = mamba2.mamba_init(torch.Generator().manual_seed(0), cfg, "cpu")
    params.load_state_dict(convert.lm_params_from_jax(values, "cpu"))
    return jcfg, values, cfg, params


def _rand(rng, *shape, lo=None, hi=None):
    x = (rng.uniform(lo, hi, size=shape) if lo is not None
         else rng.standard_normal(shape))
    return x.astype(np.float32)


def _ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, S, H, P), _rand(rng, B, S, H, lo=0.01, hi=0.5),
            -_rand(rng, H, lo=0.5, hi=2.0), _rand(rng, B, S, N),
            _rand(rng, B, S, N))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jit(jfn, static=()):
    """The reference function compiled whole: faster on the CPU than op
    by op, which compiles each op for each shape."""
    return jax.jit(jfn, static_argnums=static)


def test_parameters_follow_reference_tree():
    _, values, cfg, params = _carried()
    sd = params.state_dict()
    want = convert.lm_params_from_jax(values, "cpu")
    assert set(sd) == set(want)
    for name, t in want.items():
        assert sd[name].shape == t.shape and sd[name].dtype == t.dtype, name
    assert sd["conv_w"].shape == (4, 64 + 16)
    for name in ("A_log", "dt_bias", "D"):
        assert sd[name].dtype == torch.float32
    # the port's own draw: the reference's constants
    own = mamba2.mamba_init(torch.Generator().manual_seed(0),
                            _cfgs(param_dtype="bfloat16")[1], "cpu")
    np.testing.assert_allclose(own.A_log.detach().numpy(),
                               np.asarray(values["A_log"]), rtol=1e-6)
    assert (own.dt_bias == -2.0).all() and (own.D == 1.0).all()
    assert own.wx.w.dtype == own.conv_w.dtype == torch.bfloat16
    assert own.A_log.dtype == torch.float32


@pytest.mark.parametrize("history", [False, True])
def test_depthwise_causal_conv_matches_reference(history):
    rng = np.random.default_rng(1)
    u, w, b = _rand(rng, 2, 9, 12), _rand(rng, 4, 12), _rand(rng, 12)
    hist = _rand(rng, 2, 3, 12) if history else None
    want = jmamba._depthwise_causal_conv(u, w, b, hist)
    got = mamba2._depthwise_causal_conv(*_t(u, w, b),
                                        None if hist is None else
                                        torch.from_numpy(hist))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    # causal: the first output sees only the history and the first input
    if not history:
        ref = (u[:, 0] * w[3] + b)
        np.testing.assert_allclose(got[:, 0].numpy(), ref, atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("S,chunk,init", [(50, 16, False), (50, 16, True),
                                          (10, 16, False), (64, 16, True),
                                          (33, 8, True)])
def test_ssd_chunked_matches_reference(S, chunk, init):
    """S = 50 at chunk 16 (a padded last chunk), S < chunk, whole chunks,
    with and without an initial state."""
    xh, dt, A, Bm, Cm = _ssd_inputs(2, 2, S, 3, 4, 8)
    rng = np.random.default_rng(3)
    state = _rand(rng, 2, 3, 8, 4) if init else None
    y, final = _jit(jmamba._ssd_chunked, (5,))(xh, dt, A, Bm, Cm, chunk,
                                               state)
    gy, gf = mamba2._ssd_chunked(*_t(xh, dt, A, Bm, Cm), chunk,
                                 None if state is None else
                                 torch.from_numpy(state))
    assert gy.shape == (2, S, 3, 4) and gf.dtype == torch.float32
    np.testing.assert_allclose(gy.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(gf.numpy(), np.asarray(final), **TOL)


def test_ssd_matches_naive_recurrence():
    """The reference's oracle on the port: chunked SSD == step by step
    h_t = exp(dt A) h + dt B x; y = C h (S = 50, chunk 16)."""
    B, S, H, P, N = 2, 50, 3, 4, 8
    xh, dt, A, Bm, Cm = _ssd_inputs(0, B, S, H, P, N)
    y, final = mamba2._ssd_chunked(*_t(xh, dt, A, Bm, Cm), 16)
    h = np.zeros((B, H, N, P))
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        g = np.exp(dt[:, t] * A)
        upd = np.einsum("bm,bh,bhp->bhmp", Bm[:, t], dt[:, t], xh[:, t])
        h = h * g[:, :, None, None] + upd
        ys[:, t] = np.einsum("bm,bhmp->bhp", Cm[:, t], h)
    np.testing.assert_allclose(y.numpy(), ys, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(final.numpy(), h, rtol=2e-4, atol=2e-4)


def test_ssd_chunk_invariance():
    """The reference's check on the port: chunk 8 and chunk 64 agree."""
    xh, dt, A, Bm, Cm = _ssd_inputs(1, 1, 64, 2, 4, 4)
    y1, f1 = mamba2._ssd_chunked(*_t(xh, dt, A, Bm, Cm), 8)
    y2, f2 = mamba2._ssd_chunked(*_t(xh, dt, A, Bm, Cm), 64)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("steep", [False, True])
def test_ssd_grads_finite_and_match_reference(steep):
    """d/d(inputs) of sum(y * r) + sum(final * q) against jax.grad, over a
    padded last chunk: finite and within 1e-5 of each gradient's largest
    magnitude (of all five gradients' at ``steep``). ``steep`` decays (dt up to 20, A down to -16) put the upper
    triangle's cum_i - cum_j past 88, where exp overflows float32: a mask
    after the exp would give inf * 0 = NaN in the backward."""
    xh, dt, A, Bm, Cm = _ssd_inputs(4, 2, 50, 3, 4, 8)
    if steep:
        rng = np.random.default_rng(9)
        dt = _rand(rng, 2, 50, 3, lo=5.0, hi=20.0)
        A = -_rand(rng, 3, lo=8.0, hi=16.0)
    rng = np.random.default_rng(5)
    r, q = _rand(rng, 2, 50, 3, 4), _rand(rng, 2, 3, 8, 4)

    def jloss(*args):
        y, f = jmamba._ssd_chunked(*args, 16)
        return jnp.sum(y * r) + jnp.sum(f * q)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        xh, dt, A, Bm, Cm)
    ins = [t.requires_grad_(True) for t in _t(xh, dt, A, Bm, Cm)]
    y, f = mamba2._ssd_chunked(*ins, 16)
    loss = (y * torch.from_numpy(r)).sum() + (f * torch.from_numpy(q)).sum()
    got = torch.autograd.grad(loss, ins)
    # steep: A's gradient is 0 in the reference and float32 noise from
    # cum_i - cum_j at |cum| ~ 5000 in the port, so the scale is the
    # largest gradient of all five inputs there
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for name, g, w in zip(("xh", "dt", "A", "Bm", "Cm"), got, want):
        w = np.asarray(w)
        assert bool(torch.isfinite(g).all()), name
        scale = top if steep else np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("S", [3, 20, 37])
def test_forward_cache_and_decode_match_reference(S):
    """``mamba_forward(return_cache=True)`` over S tokens (S = K-1, one
    chunk and a padded one, three chunks), then four ``mamba_decode``
    steps: outputs, conv history and state against the reference's; the
    decode updates the cache's tensors in place."""
    jcfg, values, cfg, params = _carried()
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, S, 32)
    fwd = _jit(functools.partial(jmamba.mamba_forward, return_cache=True),
               (1,))
    want, jcache = fwd(values, jcfg, x)
    with torch.no_grad():
        got, cache = mamba2.mamba_forward(params, cfg, torch.from_numpy(x),
                                          return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cache.conv.numpy(), np.asarray(jcache.conv),
                               **TOL)
    np.testing.assert_allclose(cache.state.numpy(), np.asarray(jcache.state),
                               **TOL)
    assert cache.length == int(jcache.length) == S
    mine = mamba2.init_mamba_cache(cfg, 2, device="cpu")
    mine.conv.copy_(cache.conv)
    mine.state.copy_(cache.state)
    cache = mine._replace(length=S)
    ptrs = (cache.conv.data_ptr(), cache.state.data_ptr())
    step = _jit(jmamba.mamba_decode, (1,))
    for i in range(4):
        xt = _rand(rng, 2, 1, 32)
        want, jcache = step(values, jcfg, xt, jcache)
        with torch.no_grad():
            got, cache = mamba2.mamba_decode(params, cfg,
                                             torch.from_numpy(xt), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(cache.state.numpy(),
                                   np.asarray(jcache.state), **TOL)
        np.testing.assert_allclose(cache.conv.numpy(),
                                   np.asarray(jcache.conv), **TOL)
        assert cache.length == S + i + 1
    assert (cache.conv.data_ptr(), cache.state.data_ptr()) == ptrs


def test_decode_continues_the_forward():
    """Forward over 24 tokens == forward over 16 (with its cache) then 8
    decode steps, position by position; and a forward from a cache
    (``init_cache``) over the last 8 gives the same outputs."""
    _, _, cfg, params = _carried()
    x = torch.from_numpy(_rand(np.random.default_rng(7), 1, 24, 32))
    with torch.no_grad():
        full = mamba2.mamba_forward(params, cfg, x)
        head, cache = mamba2.mamba_forward(params, cfg, x[:, :16],
                                           return_cache=True)
        c = mamba2.init_mamba_cache(cfg, 1, device="cpu")
        c.conv.copy_(cache.conv)
        c.state.copy_(cache.state)
        tail = mamba2.mamba_forward(params, cfg, x[:, 16:], init_cache=c)
        c = c._replace(length=16)
        steps = []
        for t in range(16, 24):
            y, c = mamba2.mamba_decode(params, cfg, x[:, t:t + 1], c)
            steps.append(y)
    np.testing.assert_allclose(head.numpy(), full[:, :16].numpy(), **TOL)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                               full[:, 16:].numpy(), **TOL)
    np.testing.assert_allclose(tail.numpy(), full[:, 16:].numpy(), **TOL)


def test_short_prompt_cache_raises():
    """A cache needs K-1 = 3 prompt tokens; the reference slices the
    wrong rows below that and its decode fails on the shape."""
    _, _, cfg, params = _carried()
    x = torch.zeros((1, 2, 32))
    with pytest.raises(ValueError, match="at least 3 tokens"):
        mamba2.mamba_forward(params, cfg, x, return_cache=True)
    assert mamba2.mamba_forward(params, cfg, x).shape == (1, 2, 32)


def test_init_cache_matches_reference():
    jcfg, _, cfg, _ = _carried()
    want = jmamba.init_mamba_cache(jcfg, 3)
    got = mamba2.init_mamba_cache(cfg, 3, device="cpu")
    assert got.conv.shape == want.conv.shape and got.conv.dtype == \
        torch.float32
    assert got.state.shape == want.state.shape and got.state.dtype == \
        torch.float32
    assert got.length == 0 and not got.conv.any() and not got.state.any()


def test_grads_match_reference():
    """d/d(params, x) of sum(out * r) over 40 tokens (three chunks, the
    last padded) against jax.grad: every gradient finite and within 1e-5
    of its largest magnitude."""
    jcfg, values, cfg, params = _carried()
    rng = np.random.default_rng(8)
    x, r = _rand(rng, 2, 40, 32), _rand(rng, 2, 40, 32)

    def jloss(p, xx):
        return jnp.sum(jmamba.mamba_forward(p, jcfg, xx) * r)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(values, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = (mamba2.mamba_forward(params, cfg, xt) * torch.from_numpy(r)).sum()
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       params.named_parameters()] + [xt])
    want = convert.lm_params_from_jax(jg, "cpu")
    want["x"] = torch.from_numpy(np.array(jgx))
    for name, g in zip(names + ["x"], grads):
        w = want[name].numpy()
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
