"""The LM with MoE and Mamba-2 units against the JAX package's, at the
``.smoke()`` sizes of the four architectures that hold them: ``dbrx-132b``
and ``kimi-k2-1t-a32b`` (an MoE on every layer), ``mamba2-2.7b`` (Mamba
mixers, no feed-forward) and ``jamba-1.5-large-398b`` (an 8-layer unit of
seven Mamba and one attention mixer, MoE and dense feed-forwards in
turn): the forward logits and aux, the loss with every gradient, a train
step with AdamW and with Adafactor from a carried state (the state updated
in place), Adafactor's factored statistics of the stacked expert leaves,
checkpoints that each package restores from the other's, and the serving
engine on Mamba caches and MoE models with and without a data mesh.

Weights and states are the reference's, carried across by ``convert``;
inputs come from seeded numpy generators. The reference's functions run
compiled (faster on the CPU than op by op). Tolerances as in
tests/test_torch_train.py: logits within atol/rtol 1e-4, loss and ce
rtol 1e-4, a gradient leaf within 1e-4 of its largest magnitude (float32
sums in another order); ``load_balance`` rtol 1e-5; the dropped
assignments' count exact (``dropped_frac`` within one float32 step: the
compiled reference takes a mean as a sum times 1/n). A train step from a
carried state: loss and grad norm rtol 1e-4, lr 1e-6; each leaf's update
(new parameters less the carried ones) within 1e-3 of its norm, in norm:
an element whose gradient is near 0 has no relative bound, and the Adam
and Adafactor ratios m / sqrt(v) amplify its error up to lr (a step of
paper-tiny's dense leaves stays within atol 2e-6, tests/test_torch_optim.py,
an MoE's routed gradients do not); an optimizer-state entry within 1e-5
of its leaf's largest magnitude. Checkpoints are bit-exact.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.nn import lm as jlm
from repro.serve.engine import SamplerConfig as JSamplerConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import checkpoint as jckpt
from repro.train import optim as joptim
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import train as launch_train
from repro_torch.nn import lm
from repro_torch.serve.engine import SamplerConfig, ServeEngine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim, step

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

ARCHS = ["dbrx-132b", "kimi-k2-1t-a32b", "mamba2-2.7b",
         "jamba-1.5-large-398b"]
SCHED = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
# d_model and the expert width at 128, so the stacked (L, E, D, F) expert
# leaves reach Adafactor's factoring threshold (both last axes >= 128)
WIDE = dict(d_model=128, expert_d_ff=128)


def _cfgs(arch, **overrides):
    return (dataclasses.replace(jget_config(arch).smoke(), **overrides),
            dataclasses.replace(registry.get_config(arch).smoke(),
                                **overrides))


@functools.lru_cache(maxsize=None)
def _values(arch, overrides=()):
    jcfg, _ = _cfgs(arch, **dict(overrides))
    return jlm.init(jax.random.PRNGKey(0), jcfg)[0]


def _carried(arch, **overrides):
    jcfg, cfg = _cfgs(arch, **overrides)
    values = _values(arch, tuple(sorted(overrides.items())))
    params = lm.init(0, cfg, device="cpu")
    params.load_state_dict(convert.lm_params_from_jax(values, "cpu"))
    return jcfg, values, cfg, params


def _value_and_grad(jcfg):
    """The reference's loss and gradients, compiled once a model (the
    optimizer field does not enter the loss)."""
    return _compiled_loss(dataclasses.replace(jcfg, optimizer="adamw"))


@functools.lru_cache(maxsize=None)
def _compiled_loss(jcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss(p, jcfg, b), has_aux=True))


def _tokens(cfg, seed, B=2, S=24):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def _check_aux(got_lb, got_df, want_lb, want_df, n):
    np.testing.assert_allclose(float(got_lb), float(want_lb), rtol=1e-5)
    assert round(float(got_df) * n) == round(float(want_df) * n)
    np.testing.assert_allclose(float(got_df), float(want_df), rtol=0,
                               atol=2 ** -23)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    jcfg, values, cfg, params = _carried(arch)
    toks = _tokens(cfg, 1)
    want, want_aux = jax.jit(lambda p, t: jlm.forward(p, jcfg, t))(values,
                                                                   toks)
    with torch.no_grad():
        got, aux = lm.forward(params, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # aux: (load_balance, dropped_frac) of 2 x 24 tokens, top_k each
    n = toks.size * cfg.top_k
    _check_aux(aux[0], aux[1], want_aux[0], want_aux[1], n)
    if cfg.n_experts:
        assert float(aux[0]) > 0
    else:
        assert not aux.any()

    (jl, jm), jg = _value_and_grad(jcfg)(values, {"tokens": toks})
    loss, metrics = lm.loss(params, cfg, {"tokens": torch.from_numpy(toks)})
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       params.named_parameters()])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]),
                               rtol=1e-4)
    _check_aux(metrics["load_balance"], metrics["dropped_frac"],
               jm["load_balance"], jm["dropped_frac"], n)
    want = convert.lm_params_from_jax(jg, "cpu")
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_capacity_drops_reach_the_loss():
    """dbrx at capacity factor 0.1 (128 tokens, top 2 of 4 experts: 8
    slots an expert): assignments drop, the count the reference's, and the
    MoE term of the loss is 0.01 x load_balance."""
    jcfg, values, cfg, params = _carried("dbrx-132b", capacity_factor=0.1)
    toks = _tokens(cfg, 2, B=4, S=32)
    (jl, jm), _ = _value_and_grad(jcfg)(values, {"tokens": toks})
    with torch.no_grad():
        loss, m = lm.loss(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert float(m["dropped_frac"]) > 0
    _check_aux(m["load_balance"], m["dropped_frac"], jm["load_balance"],
               jm["dropped_frac"], toks.size * cfg.top_k)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4)
    with torch.no_grad():
        l0, _ = lm.loss(params, cfg, {"tokens": torch.from_numpy(toks)},
                        moe_loss_weight=0.0)
    np.testing.assert_allclose(float(loss) - float(l0),
                               0.01 * float(m["load_balance"]), rtol=1e-4)


def _reference_steps(arch, opt_name, overrides=()):
    """The reference's state after one step (its grads, its optimizer),
    and after a second one on another batch: (state1, state2, metrics2,
    batch2), host arrays."""
    jcfg, cfg = _cfgs(arch, **dict(overrides), optimizer=opt_name)
    values = _values(arch, overrides)
    jopt = joptim.make_optimizer(opt_name, joptim.Schedule(**SCHED))
    axes = jax.tree_util.tree_map(lambda p: (None,) * p.ndim, values)
    opt0, _ = jopt.init(values, axes)
    vg = _value_and_grad(jcfg)
    update = jax.jit(jopt.update)
    b1, b2 = ({"tokens": _tokens(cfg, s)} for s in (3, 4))
    _, g = vg(values, b1)
    p1, o1, _ = update(g, opt0, values, np.int32(0))
    (l2, m2), g = vg(p1, b2)
    p2, o2, om = update(g, o1, p1, np.int32(1))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state1 = host({"params": p1, "opt": o1, "step": np.int32(1)})
    state2 = host({"params": p2, "opt": o2, "step": np.int32(2)})
    return state1, state2, {**host(m2), **host(om), "loss": float(l2)}, b2


def _port_state(cfg, tree):
    state = step.init_state(0, cfg, optim.Schedule(**SCHED), device="cpu")
    step.load_state(state, convert.train_state_from_jax(tree, "cpu"))
    return state


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, opt_name):
    """One ``make_train_step`` step from the reference's state after one
    of its steps (moments not zero), against the reference's second step:
    metrics, parameters and optimizer state; every state tensor keeps its
    storage (the launcher's in-place check)."""
    _, cfg = _cfgs(arch, optimizer=opt_name)
    state1, state2, jm, batch = _reference_steps(arch, opt_name)
    state = _port_state(cfg, state1)
    before = launch_train.storage_pointers(state)
    state, m = step.make_train_step(cfg, optim.Schedule(**SCHED))(state,
                                                                  batch)
    assert launch_train.moved(before, state) == []
    assert int(state["step"]) == 2
    for k, rtol in (("loss", 1e-4), ("ce", 1e-4), ("grad_norm", 1e-4),
                    ("lr", 1e-6)):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol)
    want = convert.train_state_from_jax(state2, "cpu")
    start = convert.train_state_from_jax(state1, "cpu")["params"]
    for n, p in state["params"].named_parameters():
        got = p.detach() - start[n]
        upd = want["params"][n] - start[n]
        err = float(torch.linalg.vector_norm(got - upd))
        assert err <= 1e-3 * float(torch.linalg.vector_norm(upd)), n
    for k1, sub in want["opt"].items():
        for k2, w in sub.items():
            w = w.numpy()
            np.testing.assert_allclose(
                state["opt"][k1][k2].numpy(), w, rtol=1e-3,
                atol=2e-4 * np.abs(w).max(), err_msg=f"{k1}.{k2}")


def test_adafactor_factors_stacked_expert_leaves():
    """dbrx with d_model and expert width 128: the reference factors its
    stacked (L, E, D, F) expert leaf into (L, E, D) and (L, E, F); the
    port factors each layer's (E, D, F) leaf into (E, D) and (E, F), the
    same statistics split over the layers; a 1-D leaf keeps a full v."""
    _, cfg = _cfgs("dbrx-132b", optimizer="adafactor", **WIDE)
    values = _values("dbrx-132b", tuple(sorted(WIDE.items())))
    jopt = joptim.make_optimizer("adafactor")
    jstate, _ = jopt.init(values, jax.tree_util.tree_map(
        lambda p: (None,) * p.ndim, values))
    w_in = jstate["blocks"]["u0"]["ffn"]["w_in"]
    assert set(w_in) == {"vr", "vc"} and w_in["vr"].shape == (2, 4, 128)
    assert w_in["vc"].shape == (2, 4, 128)
    state = step.init_state(0, cfg, device="cpu")["opt"]
    for r in range(cfg.repeats):
        for leaf in ("w_in", "w_gate", "w_out"):
            s = state[f"blocks.{r}.u0.ffn.{leaf}"]
            assert set(s) == {"vr", "vc"}
            assert s["vr"].shape == (4, 128) and s["vc"].shape == (4, 128)
    assert set(state["blocks.0.u0.ffn.router.w"]) == {"v"}
    assert set(state["blocks.0.u0.norm_mix.scale"]) == {"v"}
    # the carried reference state fills the port's, leaf for leaf
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    carried = convert.train_state_from_jax(
        {"params": values, "opt": tree, "step": np.int32(0)}, "cpu")
    assert set(carried["opt"]) == set(state)
    for n, s in state.items():
        assert {k: v.shape for k, v in s.items()} == {
            k: v.shape for k, v in carried["opt"][n].items()}, n


@pytest.mark.parametrize("arch,opt_name,overrides", [
    ("dbrx-132b", "adafactor", WIDE), ("kimi-k2-1t-a32b", "adafactor", {}),
    ("mamba2-2.7b", "adamw", {}), ("jamba-1.5-large-398b", "adafactor",
                                   {})])
def test_checkpoints_round_trip_with_reference(arch, opt_name, overrides,
                                               tmp_path):
    """The port's ``checkpoint_tree`` of a carried state is the
    reference's state tree, bit for bit; the reference restores the
    port's snapshot, and the port restores the reference's."""
    ov = tuple(sorted(overrides.items()))
    jcfg, cfg = _cfgs(arch, optimizer=opt_name, **overrides)
    state1, _, _, _ = _reference_steps(arch, opt_name, ov)
    state = _port_state(cfg, state1)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    mine = flat(step.checkpoint_tree(state))
    want = flat(state1)
    assert set(mine) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    ckpt.save(step.checkpoint_tree(state), str(tmp_path / "port"), 1)
    got, at = jckpt.restore(jax.tree_util.tree_map(np.zeros_like, state1),
                            str(tmp_path / "port"))
    assert at == 1
    for k, v in flat(got).items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)
    jckpt.save(state1, str(tmp_path / "ref"), 1)
    fresh = step.init_state(0, cfg, device="cpu")
    assert step.restore_state(fresh, str(tmp_path / "ref")) == 1
    again = flat(step.checkpoint_tree(fresh))
    for k, v in want.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "dbrx-132b",
                                  "jamba-1.5-large-398b"])
def test_engine_serves_moe_and_mamba(arch):
    """``ServeEngine.generate`` (greedy, no-repeat 3-grams) gives the
    reference engine's tokens on both planes, and a sampled call on a data
    mesh of two shards gives the one-device tokens."""
    jcfg, values, cfg, params = _carried(arch)
    sampler = dict(temperature=0.0, no_repeat_ngram=3, seed=3)
    jeng = JServeEngine(jcfg, values, JSamplerConfig(**sampler))
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(3, 6)).astype(np.int32)
    want, jstats = jeng.generate(prompts, 8)
    for plane in ("fused", "legacy"):
        eng = ServeEngine(cfg, params, SamplerConfig(**sampler,
                                                     ngram_plane=plane))
        eng.nrn.rebind_params(convert.norepeat_params_from_jax(
            jeng.nrn.params, "cpu"))
        got, stats = eng.generate(prompts, 8)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=plane)
        assert stats["banned_candidates"] == jstats["banned_candidates"]
    scfg = SamplerConfig(temperature=0.8, top_k=5, no_repeat_ngram=3, seed=2)
    one, s1 = ServeEngine(cfg, params, scfg).generate(prompts, 6)
    two, s2 = ServeEngine(cfg, params, scfg, data_shards=2).generate(
        prompts, 6)
    np.testing.assert_array_equal(two, one)
    assert s1["banned_candidates"] == s2["banned_candidates"]
