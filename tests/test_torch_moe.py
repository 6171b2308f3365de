"""The port's MoE feed-forward (``repro_torch.nn.moe``) against the JAX
package's ``repro.nn.moe``: the capacity rule, the dispatch rule, the
global, grouped and gathered dispatches (gated and GELU experts, softmax
and sigmoid routers, with and without capacity drops, planted ties), the
gradients, and the reference's own MoE oracles (``tests/test_models.py``:
the dense enumeration, grouped equal to global without drops, capacity
drops) on the port.

Weights are the reference's ``moe_init`` draw carried across by
``convert.lm_params_from_jax``; inputs come from seeded numpy generators.
Float32 parameters and activations, but for one bfloat16 case.
Tolerances: integer results are exact — the capacity, and the count of
dropped assignments behind ``dropped_frac`` (bit-equal to the op-by-op
reference's; the compiled reference's may sit one float32 step off, see
``_check``); the output then also shows which drop (a token dropped on
one side and not on the other moves its row by a whole expert's
output). Outputs and the load-balance
term within atol/rtol 1e-5, gradients within 1e-5 of their largest
magnitude: float32 sums in another order.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.nn import moe as jmoe
from repro.nn.sharding import unzip
from repro_torch import convert
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.nn import moe

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
_BASE = dict(name="t", n_layers=1, d_model=16, vocab=64, n_heads=2,
             n_kv_heads=2, head_dim=8, d_ff=0, n_experts=4, top_k=2,
             expert_d_ff=32, param_dtype="float32",
             activation_dtype="float32")


def _cfgs(**kw):
    kw = {**_BASE, **kw}
    return (JModelConfig(unit=(JLayerSpec("attn", "moe"),), **kw),
            ModelConfig(unit=(LayerSpec("attn", "moe"),), **kw))


def _carried(key=0, **kw):
    jcfg, cfg = _cfgs(**kw)
    values, _ = unzip(jmoe.moe_init(jax.random.PRNGKey(key), jcfg))
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    params.load_state_dict(convert.lm_params_from_jax(values, "cpu"))
    return jcfg, values, cfg, params


@functools.lru_cache(maxsize=None)
def _jit(jfn):
    """The reference function compiled whole (its config static): faster
    on the CPU than op by op, which compiles each op for each shape."""
    return jax.jit(jfn, static_argnums=1)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check(got, want, top_k: int = 2):
    """Outputs and load balance within TOL; the dropped assignments'
    count exact. (The compiled reference takes the mean of the keep mask
    as a sum times 1/n, so its ``dropped_frac`` may sit one float32 step
    from 1 - kept / n, the port's and the op-by-op reference's value.)"""
    out, aux = got
    wout, waux = want
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(wout), **TOL)
    n = out.shape[0] * out.shape[1] * top_k
    assert round(float(aux["dropped_frac"]) * n) == round(
        float(waux["dropped_frac"]) * n)
    np.testing.assert_allclose(float(aux["dropped_frac"]),
                               float(waux["dropped_frac"]), rtol=0,
                               atol=2 ** -23)
    np.testing.assert_allclose(float(aux["load_balance"]),
                               float(waux["load_balance"]), **TOL)


@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 16.0])
def test_capacity_matches_reference(cf):
    """C(T) over a grid of tokens, top-k and experts: the same integer
    (Python floats on both sides; 128-aligned above 8)."""
    for T, K, E in itertools.product((1, 7, 16, 24, 64, 1000, 1024, 16384),
                                     (1, 2, 4, 8), (4, 16, 384)):
        jcfg, cfg = _cfgs(n_experts=E, top_k=K, capacity_factor=cf)
        assert moe._capacity(cfg, T) == jmoe._capacity(jcfg, T), (T, K, E)


def test_parameters_follow_reference_tree():
    _, values, cfg, params = _carried()
    sd = params.state_dict()
    assert set(sd) == {"router.w", "w_in", "w_gate", "w_out"}
    assert sd["router.w"].dtype == torch.float32
    assert sd["w_in"].shape == (4, 16, 32) and sd["w_out"].shape == (4, 32, 16)
    np.testing.assert_array_equal(sd["w_out"].numpy(),
                                  np.asarray(values["w_out"]))
    gelu = moe.moe_init(torch.Generator().manual_seed(0),
                        _cfgs(mlp_gated=False, param_dtype="bfloat16")[1],
                        "cpu")
    assert not hasattr(gelu, "w_gate")
    assert gelu.w_in.dtype == torch.bfloat16
    assert gelu.router.w.dtype == torch.float32


@pytest.mark.parametrize("dispatch,B,S,path", [
    ("global", 4, 16, "global"), ("grouped", 4, 16, "grouped"),
    ("grouped", 16, 1, "global"), ("gathered_decode", 2, 2, "gathered"),
    ("gathered_decode", 5, 1, "global"), ("gathered_decode", 4, 1,
                                          "gathered")])
def test_dispatch_rule_matches_reference(monkeypatch, dispatch, B, S, path):
    """gathered only for T <= max(E // K, 4), grouped only for S > 1,
    else global; the output is the reference's ``moe_forward``'s."""
    jcfg, values, cfg, params = _carried(moe_dispatch=dispatch)
    taken = []
    for name, fn in (("global", "_moe_forward_global"),
                     ("grouped", "moe_forward_grouped"),
                     ("gathered", "_moe_forward_gathered")):
        orig = getattr(moe, fn)
        monkeypatch.setattr(moe, fn, lambda *a, _o=orig, _n=name: (
            taken.append(_n), _o(*a))[1])
    x = _x((B, S, 16))
    _check(moe.moe_forward(params, cfg, torch.from_numpy(x)),
           _jit(jmoe.moe_forward)(values, jcfg, x))
    assert taken == [path]


PATHS = {"global": (moe._moe_forward_global, jmoe._moe_forward_global,
                    (4, 16)),
         "grouped": (moe.moe_forward_grouped, jmoe.moe_forward_grouped,
                     (4, 16)),
         "gathered": (moe._moe_forward_gathered, jmoe._moe_forward_gathered,
                      (2, 2))}


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_paths_match_reference(path, gated, softmax, cf):
    """Each dispatch, gated (SwiGLU) and GELU experts, softmax and sigmoid
    routers, at the default capacity factor and at 0.25, where the global
    and grouped paths drop assignments (the gathered one never does)."""
    fn, jfn, (B, S) = PATHS[path]
    jcfg, values, cfg, params = _carried(mlp_gated=gated,
                                         router_softmax=softmax,
                                         capacity_factor=cf)
    x = _x((B, S, 16), seed=2)
    got = fn(params, cfg, torch.from_numpy(x))
    want = _jit(jfn)(values, jcfg, x)
    _check(got, want)
    dropped = float(got[1]["dropped_frac"])
    assert (dropped > 0) == (cf == 0.25 and path != "gathered")


@pytest.mark.parametrize("softmax", [True, False])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_planted_ties_go_to_the_lower_expert(path, softmax):
    """A zero router: every probability ties (1/E under softmax, 1/2 under
    sigmoid). jax.lax.top_k takes the lower indices first, so every token
    goes to experts 0..K-1; the port's stable sort does too, and with
    capacity 0.25 the same assignments drop."""
    fn, jfn, (B, S) = PATHS[path]
    jcfg, values, cfg, params = _carried(router_softmax=softmax,
                                         capacity_factor=0.25)
    values = dict(values, router={"w": np.zeros((16, 4), np.float32)})
    with torch.no_grad():
        params.router.w.zero_()
    x = _x((B, S, 16), seed=3)
    _, _, top_idx = moe._route(params, cfg, torch.from_numpy(x))
    assert (top_idx == torch.arange(cfg.top_k)).all()
    got = fn(params, cfg, torch.from_numpy(x))
    want = _jit(jfn)(values, jcfg, x)
    _check(got, want)
    if path != "gathered":
        assert float(got[1]["dropped_frac"]) > 0


def test_slots_keep_within_capacity_and_never_share():
    """Kept assignments take distinct rows, at most C an expert, in
    slot-major order: an earlier slot's assignment outranks a later
    one's."""
    rng = np.random.default_rng(4)
    E, C = 4, 8
    top_idx = torch.from_numpy(rng.integers(0, E, size=(64, 2)))
    keep, slot = moe._slots(top_idx, E, C)
    kept = slot[keep]
    assert len(set(kept.tolist())) == kept.numel()
    assert ((kept // C) == top_idx[keep]).all()
    for e in range(E):
        assert int((top_idx[keep] == e).sum()) == min(
            C, int((top_idx == e).sum()))
    # slot 0 is ranked before slot 1: its assignments drop last
    first = top_idx[:, 0]
    for e in range(E):
        n0 = int((first == e).sum())
        assert bool(keep[:, 0][first == e].all()) == (n0 <= C)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_grads_match_reference(path, gated):
    """d/d(params, x) of sum(out * r) + 0.1 * load_balance against
    ``jax.grad``, with drops (capacity factor 0.25) where the path has
    them."""
    fn, jfn, (B, S) = PATHS[path]
    jcfg, values, cfg, params = _carried(mlp_gated=gated,
                                         capacity_factor=0.25)
    x = _x((B, S, 16), seed=5)
    r = _x((B, S, 16), seed=6)

    def jloss(p, xx):
        out, aux = jfn(p, jcfg, xx)
        return jnp.sum(out * r) + 0.1 * aux["load_balance"]

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(values, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = fn(params, cfg, xt)
    loss = (out * torch.from_numpy(r)).sum() + 0.1 * aux["load_balance"]
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       params.named_parameters()] + [xt])
    want = convert.lm_params_from_jax(jg, "cpu")
    want["x"] = torch.from_numpy(np.array(jgx))
    for name, g in zip(names + ["x"], grads):
        w = want[name].numpy()
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


# -- the reference's MoE oracles (tests/test_models.py) on the port -----------

def test_moe_matches_dense_enumeration():
    """With no drops (capacity factor 8), the MoE is the explicit top-k
    expert sum, token by token; within the reference's 2e-3."""
    _, _, cfg, params = _carried(capacity_factor=8.0)
    x = torch.from_numpy(_x((2, 8, 16), seed=5))
    with torch.no_grad():
        out, aux = moe.moe_forward(params, cfg, x)
        assert float(aux["dropped_frac"]) == 0.0
        xt = x.reshape(-1, 16)
        probs = torch.softmax(xt @ params.router.w, -1)
        gv, ti = torch.topk(probs, 2)
        gv = gv / gv.sum(-1, keepdim=True)
        want = torch.zeros_like(xt)
        for t in range(xt.shape[0]):
            for k in range(2):
                e = int(ti[t, k])
                h = xt[t] @ params.w_in[e]
                g = xt[t] @ params.w_gate[e]
                want[t] += gv[t, k] * ((torch.nn.functional.silu(g) * h)
                                       @ params.w_out[e])
    np.testing.assert_allclose(out.reshape(-1, 16).numpy(), want.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_moe_grouped_matches_global_when_no_drops():
    """Grouped (per-row) dispatch equals the global one at a capacity
    factor of 8, within the reference's rtol 2e-4 / atol 2e-5."""
    _, _, cfg, params = _carried(capacity_factor=8.0)
    x = torch.from_numpy(_x((3, 16, 16), seed=7))
    with torch.no_grad():
        out_g, aux_g = moe._moe_forward_global(params, cfg, x)
        out_r, aux_r = moe.moe_forward_grouped(params, cfg, x)
    assert float(aux_g["dropped_frac"]) == 0.0
    assert float(aux_r["dropped_frac"]) == 0.0
    np.testing.assert_allclose(out_g.numpy(), out_r.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_moe_capacity_drops_tokens():
    """Two experts, top-1, capacity factor 0.25 over 64 tokens: some drop,
    as many as the reference's."""
    kw = dict(d_model=8, n_heads=1, n_kv_heads=1, n_experts=2, top_k=1,
              expert_d_ff=16, capacity_factor=0.25)
    jcfg, values, cfg, params = _carried(**kw)
    x = _x((4, 16, 8), seed=6)
    with torch.no_grad():
        got = moe.moe_forward(params, cfg, torch.from_numpy(x))
    assert float(got[1]["dropped_frac"]) > 0.0
    # op by op, the reference's dropped_frac is 1 - kept / n: bit-equal
    want = jmoe.moe_forward(values, jcfg, x)
    assert float(got[1]["dropped_frac"]) == float(want[1]["dropped_frac"])
    _check(got, want, top_k=1)


def test_bfloat16_experts_match_reference():
    """bfloat16 parameters and activations (the published configs'
    parameter dtype), global dispatch with drops: the drop share exact,
    the output within one bfloat16 step of its magnitude (2^-7
    relative: the expert products round to bfloat16 after sums taken in
    another order)."""
    jcfg, values, cfg, params = _carried(param_dtype="bfloat16",
                                         activation_dtype="bfloat16",
                                         capacity_factor=0.25)
    x = _x((4, 16, 16), seed=8)
    with torch.no_grad():
        out, aux = moe.moe_forward(params, cfg, torch.from_numpy(x))
    wout, waux = _jit(jmoe.moe_forward)(values, jcfg, x)
    assert out.dtype == torch.bfloat16
    n = 4 * 16 * 2
    assert round(float(aux["dropped_frac"]) * n) == round(
        float(waux["dropped_frac"]) * n) > 0
    w = np.asarray(wout, np.float32)
    np.testing.assert_allclose(out.float().numpy(), w, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(w).max())
