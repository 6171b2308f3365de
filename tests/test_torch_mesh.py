"""The LM on a model mesh (``launch.mesh``, ``nn.collectives``, the
``*_sharded`` layers) against the port's one-device LM and the JAX
package's one-device step, at ``.smoke()`` sizes on meshes of virtual CPU
shards: the train step (AdamW and Adafactor, two microbatches) on (4, 2),
(2, 4) and (2, 2, 2); dbrx's MoE at capacity factors 8 and 1.25 (the
dropped assignments counted exactly); mamba2 and jamba; prefill, decode
and greedy serving with heads-sharded and sequence-sharded caches (MQA);
checkpoints across mesh shapes, one device and the reference; the
launcher and the loop.

Weights and states are the reference's, carried by ``convert``; inputs
come from seeded numpy generators. Tolerances are the reference test's
(``tests/test_distributed.py``): loss 1e-4, parameters rtol 2e-3 / atol
2e-4, the MoE loss 1e-3; grad norm rtol 1e-4; logits atol/rtol 1e-4;
checkpoints bit-exact.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.nn import lm as jlm
from repro.train import checkpoint as jckpt
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.kernels import shard
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import shardings
from repro_torch.launch import train as launch_train
from repro_torch.nn import collectives, lm, moe, sharding
from repro_torch.serve.engine import SamplerConfig, ServeEngine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop, optim, step

torch.set_num_threads(1)

SCHED = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
MESHES = {"4x2": (4, 2, 0), "2x4": (2, 4, 0), "2x2x2": (2, 2, 2)}


def _mesh(data, model, pod=0):
    return pmesh.make_debug_mesh(data, model, pod, device="cpu")


def _cfgs(arch, **overrides):
    return (dataclasses.replace(jget_config(arch).smoke(), **overrides),
            dataclasses.replace(registry.get_config(arch).smoke(),
                                **overrides))


def _tokens(cfg, seed, B=8, S=24):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_steps(arch, opt_name):
    """The reference's state after one step and after two (compiled), the
    second step's metrics and batch; host arrays."""
    jcfg, cfg = _cfgs(arch, optimizer=opt_name)
    values = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    jopt = joptim.make_optimizer(opt_name, joptim.Schedule(**SCHED))
    opt0, _ = jopt.init(values, jax.tree_util.tree_map(
        lambda p: (None,) * p.ndim, values))
    vg = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss(p, jcfg, b),
                                    has_aux=True))
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


def _one_device(cfg, tree):
    state = step.init_state(0, cfg, optim.Schedule(**SCHED), device="cpu")
    step.load_state(state, convert.train_state_from_jax(tree, "cpu"))
    return state


def _step_both(arch, opt_name, mesh, microbatches=2):
    """One step from the reference's state1 on the mesh and on one
    device. Returns (sharded state, its metrics, one-device state, its
    metrics, the reference's (state1, state2, metrics))."""
    _, cfg = _cfgs(arch, optimizer=opt_name)
    ref = _reference_steps(arch, opt_name)
    state1, _, _, batch = ref
    sched = optim.Schedule(**SCHED)
    fn = step.make_train_step(cfg, sched, num_microbatches=microbatches)
    sharded = convert.train_state_to_mesh(state1, cfg, mesh, sched)
    before = launch_train.storage_pointers(sharded)
    sharded, m = fn(sharded, batch)
    assert launch_train.moved(before, sharded) == []
    one, m1 = fn(_one_device(cfg, state1), batch)
    return sharded, m, one, m1, ref


def _check_step(sharded, m, one, m1, ref):
    _, state2, jm, _ = ref
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(m1[k]), rtol=1e-4)
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4)
    want = convert.train_state_from_jax(state2, "cpu")["params"]
    full = sharded["params"].full()
    for n, p in one["params"].named_parameters():
        torch.testing.assert_close(full[n], p.detach(), rtol=2e-3,
                                   atol=2e-4)
        torch.testing.assert_close(full[n], want[n], rtol=2e-3, atol=2e-4)
    assert int(sharded["step"]) == 2


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_sharded_step_matches_one_device_and_reference(opt_name, mesh_name):
    """paper-tiny: the step on the mesh (two microbatches, each split over
    the batch axes) against the port's one-device step and the
    reference's; every shard keeps its storage; the state's shards are
    the slices their specs say."""
    mesh = _mesh(*MESHES[mesh_name])
    sharded, m, one, m1, ref = _step_both("paper-tiny", opt_name, mesh)
    _check_step(sharded, m, one, m1, ref)
    for name, leaf in sharded["params"].leaves.items():
        full = leaf.full()
        for c, t in leaf.shards.items():
            box = leaf.box(c)
            assert torch.equal(t, full[tuple(slice(a, b) for a, b in box)])
            assert tuple(t.shape) == sharding.shard_shape(
                leaf.shape, leaf.spec, mesh)
            assert leaf.spec == sharding.spec_for(
                leaf.shape, sharding.axes_of(name), mesh)


@pytest.mark.parametrize("arch,opt_name", [("mamba2-2.7b", "adamw"),
                                           ("jamba-1.5-large-398b",
                                            "adafactor")])
def test_mamba_and_hybrid_steps_match(arch, opt_name):
    """Mamba's inner and heads split over ``model`` (the conv re-sliced,
    the gated norm's mean square all-reduced), jamba's MoE and Mamba
    layers, on (2, 2)."""
    sharded, m, one, m1, ref = _step_both(arch, opt_name, _mesh(2, 2), 1)
    _check_step(sharded, m, one, m1, ref)


def _dropped(metrics, n):
    return round(float(metrics["dropped_frac"]) * n)


@pytest.mark.parametrize("cf,B,S", [(8.0, 4, 32), (1.25, 4, 32),
                                    (1.25, 2, 6)])
def test_moe_loss_and_drops_match(cf, B, S):
    """dbrx: the global dispatch on (2, 4) and (2, 2), each data shard's
    ranks offset by the earlier shards' counts: the loss within 1e-3 of
    the reference's and the port's one-device loss, the dropped
    assignments' count equal (at (2, 6) the capacity is 8 slots and
    assignments are dropped)."""
    jcfg, cfg = _cfgs("dbrx-132b", capacity_factor=cf)
    values = jlm.init(jax.random.PRNGKey(0), jcfg)[0]
    toks = _tokens(cfg, 1, B, S)
    jl, jm = jax.jit(lambda p, t: jlm.loss(p, jcfg, {"tokens": t}))(values,
                                                                   toks)
    params = lm.init(0, cfg, "cpu")
    params.load_state_dict(convert.lm_params_from_jax(values, "cpu"))
    l1, m1 = lm.loss(params, cfg, {"tokens": toks})
    n = B * S * cfg.top_k
    if (B, S) == (2, 6):
        assert _dropped(m1, n) > 0
    for shape in ((2, 4), (2, 2)):
        sp = lm.shard(params, cfg, _mesh(*shape))
        l2, m2 = lm.loss(sp, cfg, {"tokens": toks})
        assert abs(float(l2) - float(jl)) < 1e-3
        assert abs(float(l2) - float(l1)) < 1e-3
        assert _dropped(m2, n) == _dropped(m1, n) == _dropped(jm, n)
        np.testing.assert_allclose(float(m2["load_balance"]),
                                   float(m1["load_balance"]), rtol=1e-5)


@pytest.mark.parametrize("dispatch", ["grouped", "gathered_decode"])
def test_moe_other_dispatches_match(dispatch):
    _, cfg = _cfgs("dbrx-132b", moe_dispatch=dispatch, capacity_factor=1.25)
    params = lm.init(0, cfg, "cpu")
    toks = _tokens(cfg, 2, 2, 6 if dispatch == "grouped" else 1)
    l1, m1 = lm.loss(params, cfg, {"tokens": toks}) if toks.shape[1] > 1 \
        else (None, None)
    if dispatch == "gathered_decode":       # T = 2 <= max(E // K, 4)
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (2, 1, cfg.d_model)).astype(np.float32))
        p = params.blocks[0].u0.ffn
        want, _ = moe.moe_forward(p, cfg, x)
        sp = lm.shard(params, cfg, _mesh(2, 2))
        P = collectives.Scope(sp.leaves).sub("blocks.0.u0.ffn.")
        mesh = sp.mesh
        hs = lm.split_rows(mesh, lm.batch_axes(mesh, 2, 1), x)
        got, _ = moe.moe_forward_sharded(P, cfg, mesh, ("data",),
                                                   hs)
        for pos, y in got.items():
            b = mesh.index(pos, "data")
            torch.testing.assert_close(y, want[b:b + 1], rtol=1e-4,
                                       atol=1e-5)
        return
    n = toks.size * cfg.top_k
    sp = lm.shard(params, cfg, _mesh(2, 2))
    l2, m2 = lm.loss(sp, cfg, {"tokens": toks})
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-4)
    assert _dropped(m2, n) == _dropped(m1, n)


SERVE = [("paligemma-3b", (1, 4), True), ("paligemma-3b", (2, 2), True),
         ("paper-tiny", (2, 2), False), ("paper-tiny", (1, 3), True)]


@pytest.mark.parametrize("arch,shape,seq", SERVE)
def test_sharded_prefill_and_decode_match(arch, shape, seq):
    """Prefill and six greedy decode steps at float32: the mesh's logits
    within 1e-4 of one device's, the same argmax. paligemma has one kv
    head (MQA): ``wk``/``wv`` put ``model`` on head_dim, the cache shards
    the sequence and decode combines the shards' partial softmax; on
    (1, 3) paper-tiny's two kv heads do not divide either."""
    _, cfg = _cfgs(arch)
    params = lm.init(0, cfg, "cpu")
    rng = np.random.default_rng(7)
    B, S, new, max_len = 4, 12, 6, 24
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    pre = (torch.from_numpy(rng.standard_normal(
        (B, cfg.prefix_len, cfg.d_model)).astype(np.float32))
        if cfg.prefix_len else None)
    sp = lm.shard(params, cfg, _mesh(*shape))
    runs = []
    for p in (params, sp):
        logits, caches = lm.prefill(p, cfg, toks, max_len, pre,
                                    cache_dtype=torch.float32)
        out = [logits]
        for _ in range(new):
            nxt = out[-1].argmax(-1)[:, None]
            logits, caches = lm.decode_step(p, cfg, nxt, caches)
            out.append(logits)
        runs.append((out, caches))
    for a, b in zip(runs[0][0], runs[1][0]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    cache = runs[1][1][0]["u0"]
    assert bool(cache.k.spec.axes(1)) == seq
    assert cache.length == S + (cfg.prefix_len if pre is not None else 0) \
        + new


@pytest.mark.parametrize("arch", ["paligemma-3b", "mamba2-2.7b"])
def test_engine_generates_the_same_tokens_on_a_mesh(arch):
    _, cfg = _cfgs(arch)
    params = lm.init(0, cfg, "cpu")
    prompts = _tokens(cfg, 9, 4, 8)
    scfg = SamplerConfig(temperature=0.0, no_repeat_ngram=3,
                         bloom_log2_m=10)
    got = []
    for p in (params, lm.shard(params, cfg, _mesh(2, 2))):
        toks, stats = ServeEngine(cfg, p, scfg).generate(prompts, 6)
        got.append(np.asarray(toks))
    np.testing.assert_array_equal(got[0], got[1])


def test_checkpoints_across_mesh_shapes(tmp_path):
    """A snapshot saved on (2, 2) restores on (4, 1) and on one device to
    the same tree, bit for bit; a reference snapshot restores on (2, 2);
    ``checkpoint.restore(shardings=)`` slices each leaf into its shards."""
    _, cfg = _cfgs("paper-tiny", optimizer="adafactor")
    state1 = _reference_steps("paper-tiny", "adafactor")[0]
    a = convert.train_state_to_mesh(state1, cfg, _mesh(2, 2))
    tree = step.checkpoint_tree(a)
    ckpt.save(tree, str(tmp_path / "p"), 1)
    b = step.init_state(3, cfg, mesh=_mesh(4, 1))
    one = step.init_state(3, cfg, device="cpu")
    for s in (b, one):
        assert step.restore_state(s, str(tmp_path / "p")) == 1
        got = step.checkpoint_tree(s)
        flat = dict(ckpt.flatten_with_path(got))
        for path, t in ckpt.flatten_with_path(tree):
            assert torch.equal(torch.as_tensor(flat[path]),
                               torch.as_tensor(t)), path
    jckpt.save(state1, str(tmp_path / "ref"), 1)
    c = step.init_state(4, cfg, mesh=_mesh(2, 2))
    step.restore_state(c, str(tmp_path / "ref"))
    want = convert.train_state_from_jax(state1, "cpu")
    for n, t in c["params"].full().items():
        assert torch.equal(t, want["params"][n]), n
    # restore(shardings=): a Placement leaf comes back as its shards
    mesh = _mesh(2, 2)
    t = tree["params"]["embed"]["table"]
    place = shardings.Placement(mesh, sharding.spec_for(
        tuple(t.shape), sharding.axes_of("embed.table"), mesh))
    tmpl = {"params": {"embed": {"table": torch.empty(t.shape,
                                                      dtype=t.dtype)}}}
    got, _ = ckpt.restore(tmpl, str(tmp_path / "p"),
                          shardings={"params": {"embed": {"table": place}}})
    leaf = got["params"]["embed"]["table"]
    assert isinstance(leaf, collectives.Sharded) and len(leaf.shards) == 4
    assert torch.equal(leaf.full(), t)


def test_launcher_trains_on_a_mesh(capsys, tmp_path):
    launch_train.main(["--device", "cpu", "--arch", "paper-tiny",
                       "--data-mesh", "2", "--model-mesh", "2", "--steps",
                       "2", "--seq", "16", "--batch", "4", "--ckpt-dir",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert "mesh: ModelMesh({'data': 2, 'model': 2}" in out
    assert "done. data plane" in out and "did NOT update" not in out


def test_loop_trains_on_a_mesh(tmp_path):
    _, cfg = _cfgs("paper-tiny")
    res = loop.train(cfg, PipelineConfig(seq_len=24, batch_size=4,
                                         vocab=cfg.vocab, device="cpu"),
                     loop.LoopConfig(n_steps=3, ckpt_every=2,
                                     ckpt_dir=str(tmp_path)),
                     optim.Schedule(**SCHED), log=lambda s: None,
                     mesh=_mesh(2, 2))
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert isinstance(res["state"]["params"], lm.ShardedLM)


def test_collectives_counted_by_kind():
    """None on a (1, 1) mesh; on (2, 2) the FSDP all-gathers, the
    row-parallel all-reduces and, in the backward, the gathers'
    reduce-scatters; bytes of the pieces that cross positions."""
    _, cfg = _cfgs("paper-tiny")
    params = lm.init(0, cfg, "cpu")
    toks = _tokens(cfg, 4, 4, 16)
    got = {}
    for shape in ((1, 1), (2, 2)):
        sp = lm.shard(params, cfg, _mesh(*shape))
        collectives.reset_collectives()
        loss, _ = lm.loss(sp, cfg, {"tokens": toks})
        torch.autograd.grad(loss, sp.parameters())
        got[shape] = collectives.collective_count()
    assert got[(1, 1)] == {}
    c = got[(2, 2)]
    assert set(c) == {"all_gather", "all_reduce", "reduce_scatter"}
    assert all(v["calls"] > 0 and v["bytes"] > 0 for v in c.values())
    # an all-reduce of two (2, 16, 64) float32 partials: each position
    # receives its peer's
    vals = {pos: torch.ones(2, 16, 64) for pos in _mesh(1, 2).positions()}
    collectives.reset_collectives()
    out = collectives.all_reduce(vals, _mesh(1, 2), "model")
    assert collectives.collective_count() == {
        "all_reduce": {"calls": 1, "bytes": 2 * 2 * 16 * 64 * 4}}
    assert all(torch.equal(t, torch.full((2, 16, 64), 2.0))
               for t in out.values())


def test_data_axis_bridges_to_the_data_mesh():
    mesh = _mesh(4, 2)
    dm = pmesh.data_mesh_of(mesh)
    assert isinstance(dm, shard.DataMesh) and dm.size == 4
    assert pmesh.make_production_mesh().shape == (16, 16)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_chunked_loss_over_vocab_shards_with_a_remainder(shape):
    """``ce_chunk_vocab`` 256 over a padded vocab of 768: one device takes
    three chunks; a vocab shard of 384 rows takes a chunk and a remainder
    of 128, and the shards' statistics combine to one device's loss."""
    _, cfg = _cfgs("paper-tiny", vocab=600, ce_chunk_vocab=256)
    params = lm.init(0, cfg, "cpu")
    toks = _tokens(cfg, 6, 4, 16)
    l1, m1 = lm.loss(params, cfg, {"tokens": toks})
    sp = lm.shard(params, cfg, _mesh(*shape))
    assert sp.leaves["embed.table"].spec.axes(0) == ("model",)
    l2, m2 = lm.loss(sp, cfg, {"tokens": toks})
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-4)
    np.testing.assert_allclose(float(m2["ce"]), float(m1["ce"]), rtol=1e-4)
