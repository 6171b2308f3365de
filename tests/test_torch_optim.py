"""The port's optimizers, schedule, clipping, gradient compression and
train step against the JAX package's (``repro/train/optim.py``,
``compress.py``, ``step.py``).

Inputs come from seeded numpy generators; the train-step cases carry the
reference's state (parameters, AdamW or Adafactor moments, step) across
with ``convert.train_state_from_jax``. Tolerances: the schedule, the
clipped gradients and three optimizer updates from the same gradients
agree to rtol 1e-5, a state entry within 1e-6 of its leaf's largest
magnitude (float32 ops in another order: the norm of the leaves' norms,
the scalars' pow and cos; a moment that cancels keeps the absolute error
of its terms). One AdamW train step from a carried
state: loss and grad norm to rtol 1e-4, lr to rtol 1e-6, every parameter
to atol 2e-6 (the update is lr * m / sqrt(v), lr = 1e-2; a step from the
zero state is not compared leaf by leaf, since its update is lr * sign(g)
and a gradient near 0 may take either sign). Microbatches equal the full
batch to the reference's own bound (loss rtol 1e-5, parameters 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.train import compress as jcompress
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.train import compress, optim, step

torch.set_num_threads(1)

SCHED = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)


def _tree():
    """A reference parameter tree: a vector, a small and a large matrix,
    and a ``blocks`` stack of two layers (one factored leaf, one 1-D)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (3,), "b": (64, 2), "big": (256, 160),
              "blocks": {"x": (2, 200, 144), "s": (2, 16)}}
    draw = lambda s: rng.standard_normal(s).astype(np.float32)
    return jax.tree_util.tree_map(draw, shapes,
                                  is_leaf=lambda x: isinstance(x, tuple))


def _port(tree):
    return convert.lm_params_from_jax(tree, "cpu")


def test_schedule_matches_reference():
    for kw in (dict(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
                    min_ratio=0.1), SCHED, {}):
        js, ts = joptim.Schedule(**kw), optim.Schedule(**kw)
        for s in range(0, 130, 3):
            got = ts(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_allclose(float(got), float(js(jnp.asarray(
                s, jnp.int32))), rtol=1e-6)
    # the reference's warm-up and decay figures
    s = optim.Schedule(peak_lr=1e-3, warmup_steps=10, decay_steps=100,
                       min_ratio=0.1)
    assert float(s(0)) < 2e-4
    assert float(s(9)) == pytest.approx(1e-3, rel=1e-3)
    assert float(s(1000)) == pytest.approx(1e-4, rel=1e-2)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree()
    want, wgn = joptim.clip_by_global_norm(tree, max_norm)
    names, grads = zip(*_port(tree).items())
    got, gn = optim.clip_by_global_norm(list(grads), max_norm)
    np.testing.assert_allclose(float(gn), float(wgn), rtol=1e-5)
    want = _port(want)
    for n, g in zip(names, got):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_three_updates_match_reference(name):
    """Three steps from the same gradients: parameters and state after
    each, the in-place update keeping every tensor's storage."""
    jopt = joptim.make_optimizer(name, joptim.Schedule(**SCHED))
    topt = optim.make_optimizer(name, optim.Schedule(**SCHED))
    jparams = _tree()
    axes = jax.tree_util.tree_map(lambda p: (None,) * p.ndim, jparams)
    jstate, _ = jopt.init(jparams, axes)
    params = _port(jparams)
    state = topt.init(params)
    ptrs = [t.data_ptr() for t in params.values()]
    rng = np.random.default_rng(1)
    for i in range(3):
        jgrads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 10.0 ** -i).astype(
                np.float32), jparams)
        jparams, jstate, jm = jopt.update(jgrads, jstate, jparams,
                                          jnp.asarray(i, jnp.int32))
        m = topt.update(_port(jgrads), state, params, i)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        want = _port(jparams)
        for n, p in params.items():
            np.testing.assert_allclose(p.numpy(), want[n].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=n)
        if name == "adamw":
            for k in ("mu", "nu"):
                want = _port(jstate[k])
                for n, t in state[k].items():
                    w = want[n].numpy()
                    np.testing.assert_allclose(t.numpy(), w, rtol=1e-5,
                                               atol=1e-6 * np.abs(w).max())
        else:
            want = _port(jstate)
            for n, s in state.items():
                for k, t in s.items():
                    w = want[f"{n}.{k}"].numpy()
                    np.testing.assert_allclose(t.numpy(), w, rtol=1e-5,
                                               atol=1e-6 * np.abs(w).max())
    assert [t.data_ptr() for t in params.values()] == ptrs


def test_adafactor_state_is_factored():
    """The reference's shapes, the choice taken on the stacked leaf."""
    params = {"big": torch.zeros(256, 512), "small": torch.zeros(4, 8),
              "vec": torch.zeros(300),
              "blocks.0.m": torch.zeros(128, 130),
              "blocks.1.m": torch.zeros(128, 130)}
    state = optim.adafactor(optim.Schedule()).init(params)
    assert set(state["big"]) == {"vr", "vc"}
    assert state["big"]["vr"].shape == (256,)
    assert state["big"]["vc"].shape == (512,)
    assert set(state["small"]) == {"v"} and set(state["vec"]) == {"v"}
    assert state["blocks.1.m"]["vr"].shape == (128,)
    assert state["blocks.1.m"]["vc"].shape == (130,)
    big = state["big"]["vr"].numel() + state["big"]["vc"].numel()
    assert big < params["big"].numel() / 100
    assert all(t.dtype == torch.float32 for s in state.values()
               for t in s.values())


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x.values() for t in _leaves(v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_updates_in_runs_equal_one_run(name, dtype, monkeypatch):
    """Runs of at most ``RUN_NUMEL`` elements (AdamW's float32 temporaries
    a run; Adafactor's updates of a leaf past it recomputed, not kept)
    give the very bits of one run over every tensor, over three steps."""
    def three(run_numel):
        monkeypatch.setattr(optim, "RUN_NUMEL", run_numel)
        opt = optim.make_optimizer(name, optim.Schedule(**SCHED))
        params = {n: p.to(dtype) for n, p in _port(_tree()).items()}
        state = opt.init(params)
        rng = np.random.default_rng(1)
        for i in range(3):
            grads = {n: torch.from_numpy((rng.standard_normal(tuple(
                p.shape)) * 10.0 ** -i).astype(np.float32)).to(dtype)
                for n, p in params.items()}
            m = opt.update(grads, state, params, i)
        return params, state, m, optim._runs(list(params.values()))

    p1, s1, m1, runs1 = three(1 << 40)
    p2, s2, m2, runs2 = three(5000)
    assert len(runs1) == 1 and len(runs2) > 3
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    for a, b in zip(_leaves(p1) + _leaves(s1), _leaves(p2) + _leaves(s2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_descend_quadratic(name):
    params = {"w": torch.tensor([2.0, -3.0, 1.5]),
              "b": torch.tensor([[1.0, -1.0]] * 64)}
    loss = lambda p: (p["w"] ** 2).sum() + (p["b"] ** 2).sum()
    opt = optim.make_optimizer(name, optim.Schedule(
        peak_lr=0.05, warmup_steps=1, decay_steps=100))
    state = opt.init(params)
    l0 = float(loss(params))
    for s in range(50):
        grads = {k: 2 * v for k, v in params.items()}
        m = opt.update(grads, state, params, s)
    assert float(loss(params)) < 0.2 * l0
    assert np.isfinite(float(m["grad_norm"]))


def _cfgs():
    return (jget_config("paper-tiny").smoke(),
            registry.get_config("paper-tiny").smoke())


def _tokens(cfg, seed, B=4, S=32):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def _port_state(cfg, jstate):
    state = step.init_state(0, cfg, optim.Schedule(**SCHED), device="cpu")
    host = jax.tree_util.tree_map(np.asarray, jstate)
    step.load_state(state, convert.train_state_from_jax(host, "cpu"))
    return state


def test_train_step_matches_reference():
    """One step from the reference's state after two of its own steps
    (``jax.jit(make_train_step(cfg))``), the port's state updated in
    place."""
    jcfg, cfg = _cfgs()
    batch = {"tokens": _tokens(cfg, 2)}
    jstate, _ = jstep.init_state(jax.random.PRNGKey(0), jcfg,
                                 joptim.Schedule(**SCHED))
    fn = jax.jit(jstep.make_train_step(jcfg, joptim.Schedule(**SCHED)))
    for _ in range(2):
        jstate, _ = fn(jstate, batch)
    state = _port_state(cfg, jstate)
    assert int(state["step"]) == 2
    jstate, jm = fn(jstate, batch)
    ptrs = [t.data_ptr() for t in step.state_tensors(state).values()]
    state, m = step.make_train_step(cfg, optim.Schedule(**SCHED))(state,
                                                                  batch)
    assert [t.data_ptr() for t in step.state_tensors(state).values()] == ptrs
    assert int(state["step"]) == int(jstate["step"]) == 3
    for k, rtol in (("loss", 1e-4), ("ce", 1e-4), ("grad_norm", 1e-4),
                    ("lr", 1e-6)):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol)
    want = convert.lm_params_from_jax(jstate["params"], "cpu")
    for n, p in state["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=2e-6, rtol=0, err_msg=n)


def test_microbatches_equal_full_batch_and_reference():
    """The reference's ``test_microbatch_equals_full_batch`` on the port,
    and the port's microbatched step against the reference's."""
    jcfg, cfg = _cfgs()
    batch = {"tokens": _tokens(cfg, 1)}
    jstate, _ = jstep.init_state(jax.random.PRNGKey(0), jcfg)
    _, jm2 = jax.jit(jstep.make_train_step(jcfg, num_microbatches=2))(
        jstate, batch)
    runs = [step.make_train_step(cfg, num_microbatches=n)(
        _port_state(cfg, jstate), batch) for n in (1, 2)]
    (s1, m1), (s2, m2) = runs
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    d = max(float((a - b).abs().max()) for a, b in zip(
        s1["params"].parameters(), s2["params"].parameters()))
    assert d < 2e-5
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(m2[k]), float(jm2[k]), rtol=1e-4)


def test_int8_pod_compression_is_identity_without_a_pod_axis():
    """No pod axis: the gradients pass through, as the reference's do
    outside a pod mesh, so the compressed step equals the plain one."""
    g = {"a": torch.randn(5, generator=torch.Generator().manual_seed(0))}
    assert compress.compress_pod_gradients(g) is g
    _, cfg = _cfgs()
    batch = {"tokens": _tokens(cfg, 3)}
    out = []
    for gc in (None, "int8_pod"):
        state = step.init_state(0, cfg, device="cpu")
        out.append(step.make_train_step(cfg, grad_compression=gc)(state,
                                                                  batch))
    for a, b in zip(out[0][0]["params"].parameters(),
                    out[1][0]["params"].parameters()):
        assert torch.equal(a, b)


def test_int8_quantization_unbiased_and_bounded():
    """The reference's test: stochastic rounding within one step of the
    value, the mean of 64 draws within 3 sigma of it."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 0.01
    acc = torch.zeros_like(x)
    errs = []
    n = 64
    for i in range(n):
        q, s = compress.quantize_int8(x, torch.Generator().manual_seed(i))
        assert q.dtype == torch.int8
        deq = compress.dequantize_int8(q, s)
        errs.append(float((deq - x).abs().max()))
        acc = acc + deq
    scale = float(x.abs().max()) / 127.0
    assert max(errs) <= scale + 1e-9
    assert float((acc / n - x).abs().mean()) < scale / np.sqrt(n) * 3
    # the reference's draw on the same values: the same bounds
    jq, js = jcompress.quantize_int8(jnp.asarray(x.numpy()),
                                     jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
    assert int(np.abs(np.asarray(jq, np.int32)).max()) <= 127
