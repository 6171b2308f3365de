"""The port's training loop (``train/loop.py``), its checkpoints and its
launcher against the JAX package's, and the reference's system behaviours
(``tests/test_system.py``) on the port.

The reference's ``train()`` runs once at ``sys-tiny`` (the system test's
config) for 12 steps with a checkpoint every 4; the port starts from the
same initial state (carried by ``convert.train_state_from_jax``) and the
same batches (the port's ``DataPlane`` is a copy of the reference's).
Tolerance: each step's loss within rtol 1e-4 of the reference's (float32
sums in another order; AdamW's first steps are lr * sign(g), and a
gradient near 0 may take either sign, which moves the loss by far less).
The port's own failure recovery is bit-exact on the CPU, as the
reference's test asks of its own (rtol 1e-5 there).
"""
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.data.pipeline import DataPlane as JDataPlane
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.stats import NgramStats as JNgramStats
from repro.data.stats import StatsConfig as JStatsConfig
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.analysis import lint
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.data.pipeline import DataPlane, PipelineConfig
from repro_torch.data.stats import NgramStats, StatsConfig
from repro_torch.launch import train as launch_train
from repro_torch.serve.engine import SamplerConfig, ServeEngine
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import step
from repro_torch.train.fault import FailureInjector
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.optim import Schedule

torch.set_num_threads(1)

_TINY = dict(name="sys-tiny", n_layers=2, d_model=64, vocab=512, n_heads=2,
             n_kv_heads=2, head_dim=32, d_ff=128, q_chunk=64, kv_chunk=64,
             param_dtype="float32", activation_dtype="float32")
TINY = ModelConfig(unit=(LayerSpec("attn", "dense"),), **_TINY)
JTINY = JModelConfig(unit=(JLayerSpec("attn", "dense"),), **_TINY)
SCHED = dict(peak_lr=1e-3, warmup_steps=4, decay_steps=12)
PIPE = dict(seq_len=64, batch_size=2, vocab=512, dedup=False, seed=0)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's train() for 12 steps (a checkpoint every 4) and the
    initial state it drew."""
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    sched = joptim.Schedule(**SCHED)
    res = jloop.train(JTINY, JPipelineConfig(**PIPE), jloop.LoopConfig(
        n_steps=12, ckpt_every=4, log_every=1000, ckpt_dir=d), schedule=sched,
        log=lambda s: None)
    init, _ = jstep.init_state(jax.random.PRNGKey(0), JTINY, sched)
    return {"res": res, "dir": d,
            "init": jax.tree_util.tree_map(np.asarray, init)}


def _carried(tree):
    state = step.init_state(0, TINY, device="cpu")
    step.load_state(state, convert.train_state_from_jax(tree, "cpu"))
    return state


def _run(tmp, n_steps=24, inject=(), state=None):
    loop = LoopConfig(n_steps=n_steps, ckpt_every=8, log_every=1000,
                      ckpt_dir=str(tmp))
    inj = FailureInjector(fail_at_steps=inject) if inject else None
    return train(TINY, PipelineConfig(**PIPE, device="cpu"), loop,
                 schedule=Schedule(peak_lr=1e-3, warmup_steps=4,
                                   decay_steps=n_steps),
                 injector=inj, log=lambda s: None, state=state)


def test_batches_match_reference():
    jdp, dp = JDataPlane(JPipelineConfig(**PIPE)), DataPlane(
        PipelineConfig(**PIPE, device="cpu"))
    for s in (0, 5, 11):
        np.testing.assert_array_equal(dp.next_batch(s)["tokens"],
                                      jdp.next_batch(s)["tokens"])


def test_train_losses_match_reference(reference, tmp_path):
    res = train(TINY, PipelineConfig(**PIPE, device="cpu"), LoopConfig(
        n_steps=12, ckpt_every=4, log_every=1000, ckpt_dir=str(tmp_path)),
        schedule=Schedule(**SCHED), log=lambda s: None,
        state=_carried(reference["init"]))
    want = reference["res"]["losses"]
    assert len(res["losses"]) == len(want) == 12
    np.testing.assert_allclose(res["losses"], want, rtol=1e-4)
    assert res["restarts"] == 0
    assert (res["telemetry"]["tokens_seen"]
            == reference["res"]["telemetry"]["tokens_seen"])


def test_resume_from_reference_checkpoint(reference, tmp_path):
    """A checkpoint the reference wrote at step 8 (its on-disk tree) is
    restored into the port's loop, which resumes from it."""
    d = tmp_path / "ckpt"
    shutil.copytree(reference["dir"], d)
    shutil.rmtree(d / "step_00000012")
    res = train(TINY, PipelineConfig(**PIPE, device="cpu"), LoopConfig(
        n_steps=12, ckpt_every=4, log_every=1000, ckpt_dir=str(d)),
        schedule=Schedule(**SCHED), log=lambda s: None,
        state=_carried(reference["init"]))
    assert [s for s, _ in res["history"]] == [8, 9, 10, 11]
    assert int(res["state"]["step"]) == 12
    # a 0-d leaf comes back 0-d
    tree, _ = ckpt.restore({"step": torch.zeros((), dtype=torch.int32)},
                           str(d), 8)
    assert tree["step"].shape == () and int(tree["step"]) == 8
    np.testing.assert_allclose(res["losses"],
                               reference["res"]["losses"][8:], rtol=1e-4)


def test_reference_restores_port_checkpoint(reference, tmp_path):
    """The port's checkpoint of its state is the reference's tree: the
    reference's ``checkpoint.restore`` reads it into its own state."""
    res = _run(tmp_path, n_steps=8, state=_carried(reference["init"]))
    template, _ = jstep.init_state(jax.random.PRNGKey(1), JTINY)
    got, at = jckpt.restore(template, str(tmp_path))
    assert at == 8 and int(got["step"]) == 8
    mine = step.checkpoint_tree(res["state"])
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    want = {jax.tree_util.keystr(k): v for k, v in flat(got).items()}
    have = {jax.tree_util.keystr(k): v for k, v in flat(mine).items()}
    assert set(want) == set(have)
    for k, v in have.items():
        np.testing.assert_array_equal(np.asarray(want[k]), v, err_msg=k)


def test_training_reduces_loss(tmp_path):
    res = _run(tmp_path)
    assert res["losses"][-1] < res["losses"][0]
    assert res["restarts"] == 0


def test_failure_recovery_produces_same_final_state(tmp_path):
    """A crash and a restore replay to the identical final state, bit for
    bit on the CPU; the caller's initial state is not changed."""
    init = step.init_state(7, TINY, device="cpu")
    before = {k: t.clone() for k, t in step.state_tensors(init).items()}
    clean = _run(tmp_path / "clean", n_steps=20, state=init)
    faulty = _run(tmp_path / "faulty", n_steps=20, inject=(13,), state=init)
    assert faulty["restarts"] == 1 and clean["restarts"] == 0
    a, b = (step.state_tensors(r["state"]) for r in (clean, faulty))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for k, t in step.state_tensors(init).items():
        assert torch.equal(t, before[k]), k


def test_failure_before_first_checkpoint_restarts_from_the_seed(tmp_path):
    clean = _run(tmp_path / "clean", n_steps=6)
    faulty = _run(tmp_path / "faulty", n_steps=6, inject=(3,))
    assert faulty["restarts"] == 1
    assert [s for s, _ in faulty["history"]] == [0, 1, 2, 0, 1, 2, 3, 4, 5]
    for (n, p), (_, q) in zip(clean["state"]["params"].named_parameters(),
                              faulty["state"]["params"].named_parameters()):
        assert torch.equal(p, q), n


def test_telemetry_counts_tokens(tmp_path):
    res = _run(tmp_path, n_steps=10)
    tel = res["telemetry"]
    assert tel["tokens_seen"] >= 10 * 2 * 64
    assert tel["distinct_ngrams"] > 0


def test_train_then_serve_roundtrip(tmp_path):
    """Parameters trained by the loop drive the port's serving engine."""
    res = _run(tmp_path, n_steps=8)
    eng = ServeEngine(TINY, res["state"]["params"],
                      SamplerConfig(temperature=0.0, no_repeat_ngram=2))
    out, _ = eng.generate(torch.zeros((2, 4), dtype=torch.int32), 8)
    assert out.shape == (2, 8)
    assert int(out.max()) < TINY.vocab


def test_stats_lookup_clamps_tokens_past_its_vocab():
    """The data plane's statistics take tokens at the qwen vocab (past the
    stats table's 2^17 entries) and negative ones as the reference does:
    its gather of the token as uint32 clamps to the last entry."""
    j = JNgramStats(JStatsConfig(impl="ref"))
    t = NgramStats(StatsConfig(impl="ref", device="cpu"))
    t.rebind_params(convert.stats_params_from_jax(j.export_params(), "cpu"))
    toks = np.random.default_rng(0).integers(
        -5, 151936, size=(3, 300)).astype(np.int32)
    js, ts = j.update(j.init_state(), toks), t.update(t.init_state(), toks)
    np.testing.assert_array_equal(ts["hll"].numpy(), np.asarray(js["hll"]))
    np.testing.assert_array_equal(ts["cms"].numpy(), np.asarray(js["cms"]))


def test_launcher_runs_on_cpu(tmp_path, capsys):
    launch_train.main(["--device", "cpu", "--arch", "paper-tiny", "--steps",
                       "3", "--seq", "64", "--batch", "2", "--ckpt-dir",
                       str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "step     2 loss" in out and "done. data plane" in out
    assert "warning" not in out
    assert ckpt.latest_step(str(tmp_path)) == 2
    launch_train.main(["--device", "cpu", "--arch", "paper-tiny", "--steps",
                       "3", "--seq", "64", "--batch", "2", "--ckpt-dir",
                       str(tmp_path), "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    # each mesh flag lays the state out over a model mesh and trains
    for flag, sizes in (("--data-mesh", "{'data': 2, 'model': 1}"),
                        ("--model-mesh", "{'data': 1, 'model': 2}"),
                        ("--pod-mesh", "{'pod': 2, 'data': 1, 'model': 1}")):
        launch_train.main(["--device", "cpu", flag, "2", "--steps", "1",
                           "--seq", "16", "--batch", "4", "--ckpt-dir",
                           str(tmp_path / flag)])
        out = capsys.readouterr().out
        assert f"mesh: ModelMesh({sizes}" in out, out
        assert "done. data plane" in out and "warning" not in out


def test_launcher_storage_check_fires_on_a_replaced_tensor(tmp_path,
                                                           capsys,
                                                           monkeypatch):
    """The counterpart of the reference's donation check: a step that
    puts a state tensor in new storage is reported after the first step."""
    state = step.init_state(0, TINY, device="cpu")
    before = launch_train.storage_pointers(state)
    assert launch_train.moved(before, state) == []
    name = next(iter(state["opt"]["mu"]))
    state["opt"]["mu"][name] = state["opt"]["mu"][name].clone()
    assert launch_train.moved(before, state) == [f"opt.mu.{name}"]

    real = step.make_train_step

    def replacing(cfg, schedule=None, **kw):
        inner = real(cfg, schedule, **kw)

        def step_fn(state, batch):
            state, m = inner(state, batch)
            p = next(state["params"].parameters())
            p.data = p.data.clone()
            return state, m
        return step_fn

    monkeypatch.setattr(step, "make_train_step", replacing)
    launch_train.main(["--device", "cpu", "--arch", "paper-tiny", "--steps",
                       "1", "--seq", "64", "--batch", "2", "--ckpt-dir",
                       str(tmp_path)])
    assert "warning: the step did NOT update the state in place" in \
        capsys.readouterr().out


@pytest.mark.parametrize("layer", ["nn", "train", "launch"])
def test_lint_scope_covers_training_code(tmp_path, layer):
    """UNSEEDED-RNG reaches the LM's weights, the training code and the
    launchers: a draw without a generator there is a finding."""
    path = tmp_path / "src" / "repro_torch" / layer / "fix.py"
    path.parent.mkdir(parents=True)
    path.write_text("import torch\n\n"
                    "def draw(t, gen):\n"
                    "    a = torch.rand((4,))\n"
                    "    torch.nn.init.trunc_normal_(t)\n"
                    "    return a, torch.rand((4,), generator=gen)\n")
    found = lint.lint_tree(tmp_path)
    assert [(f.rule, f.line) for f in found] == [("UNSEEDED-RNG", 4),
                                                 ("UNSEEDED-RNG", 5)]
