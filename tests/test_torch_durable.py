"""The port's durable layer — ``train/fault.py``, ``train/checkpoint.py``,
``data/durable.py``, the stats and decontam stream snapshots and
``DataPlane.snapshot``/``restore`` — against the JAX package's. Exact
everywhere: file names, parsed ``meta.json`` and ``.npy`` bytes; every
restored leaf; every schedule.

* The same nested tree saved by both packages gives the same files, the
  same meta and byte-equal leaves, and each package loads the other's.
* A ``DataPlane`` snapshot written by the reference restores in the port
  and continues bit-identically, and the reverse.
* A flipped byte raises ``DataCorruption``; a stale ``.tmp`` is ignored;
  rotation keeps ``keep``; an injected ``SnapshotInterrupt`` leaves the
  previous snapshot the newest; an async save holds the values it was
  given.
* ``NgramStats`` and ``Decontaminator`` ``export_stream`` trees equal the
  reference's leaf for leaf; a stream restored into a fresh instance (of
  another seed) continues bit-identically.
* ``ChaosSchedule``, ``FailureInjector``, ``Watchdog`` (synthetic
  durations: no wall clock) and ``run_with_recovery`` behave as the
  reference's for the same inputs.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.data import decontam as jdecontam
from repro.data import durable as jdurable
from repro.data import pipeline as jpipeline
from repro.data import stats as jstats
from repro.train import checkpoint as jckpt
from repro.train import fault as jfault
from repro_torch import convert
from repro_torch.data import decontam, durable, pipeline, stats
from repro_torch.train import checkpoint, fault

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)

VOCAB = 4096


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"h1": rng.integers(0, 2**32, 64, dtype=np.uint32),
                       "a": rng.standard_normal(5).astype(np.float32)},
            "state": {"cms": rng.integers(0, 100, (3, 8)).astype(np.int64),
                      "tokens": np.uint32(seed),
                      # both name the file "state_a_b": the second gets a "_"
                      "a b": np.arange(3, dtype=np.int32),
                      "a_b": np.zeros((0,), np.uint8)},
            "flags": rng.integers(0, 2, 10).astype(np.uint8),
            "Z": {"x": np.int64(7)}}


def _assert_tree_equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}[{k!r}]")
    else:
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)


def _snapshot_dir(root, epoch):
    return os.path.join(root, f"step_{epoch:08d}")


# ---------------------------------------------------------------------------
# the on-disk format
# ---------------------------------------------------------------------------

def test_same_files_meta_and_bytes_as_reference(tmp_path):
    tree = _tree(3)
    jdurable.save(tree, str(tmp_path / "ref"), 5)
    durable.save(tree, str(tmp_path / "port"), 5)
    ref_d, port_d = (_snapshot_dir(str(tmp_path / w), 5)
                     for w in ("ref", "port"))
    assert sorted(os.listdir(ref_d)) == sorted(os.listdir(port_d))
    with open(os.path.join(ref_d, "meta.json")) as f:
        ref_meta = json.load(f)
    with open(os.path.join(port_d, "meta.json")) as f:
        port_meta = json.load(f)
    assert port_meta == ref_meta
    assert "state_a_b_.npy" in os.listdir(port_d)
    for name in os.listdir(ref_d):
        with open(os.path.join(ref_d, name), "rb") as a, \
             open(os.path.join(port_d, name), "rb") as b:
            assert a.read() == b.read(), name


def test_tensor_leaves_save_as_their_arrays(tmp_path):
    tree = {"u": torch.arange(4, dtype=torch.int32).view(torch.uint32),
            "i": torch.full((2, 3), -5, dtype=torch.int32)}
    durable.save(tree, str(tmp_path), 0)
    got, _ = jdurable.load(str(tmp_path))
    _assert_tree_equal(got, {"u": np.arange(4, dtype=np.uint32),
                             "i": np.full((2, 3), -5, np.int32)})


def test_each_package_loads_the_others_snapshot(tmp_path):
    want = _tree(4)
    jdurable.save(want, str(tmp_path / "ref"), 2)
    got, epoch = durable.load(str(tmp_path / "ref"))
    assert epoch == 2
    _assert_tree_equal(got, want)
    durable.save(want, str(tmp_path / "port"), 3)
    got, epoch = jdurable.load(str(tmp_path / "port"))
    assert epoch == 3
    _assert_tree_equal(got, want)


def test_checkpoint_restore_into_a_template(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "step": np.int64(9), "opt": [np.ones(2, np.float32), None]}
    checkpoint.save(state, str(tmp_path), 1)
    template = {"w": torch.zeros(2, 3), "step": np.int64(0),
                "opt": [np.zeros(2, np.float32), None]}
    got, step = checkpoint.restore(template, str(tmp_path))
    assert step == 1 and torch.equal(got["w"], state["w"])
    assert got["step"] == 9 and got["opt"][1] is None
    np.testing.assert_array_equal(got["opt"][0], np.ones(2, np.float32))
    # the reference restores the port's checkpoint of the same structure
    jgot, _ = jckpt.restore({"w": np.zeros((2, 3), np.float32),
                             "step": np.int64(0),
                             "opt": [np.zeros(2, np.float32), None]},
                            str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jgot["w"]), state["w"].numpy())
    # a placement tree: "w" on the CPU device, the rest where it was
    placed, _ = checkpoint.restore(
        template, str(tmp_path),
        shardings={"w": torch.device("cpu"), "step": None, "opt": None})
    assert torch.equal(placed["w"], got["w"])
    assert placed["step"] == 9 and placed["opt"][1] is None
    np.testing.assert_array_equal(placed["opt"][0], got["opt"][0])
    # a placed numpy leaf comes back a tensor of its dtype on that device
    placed, _ = checkpoint.restore(
        template, str(tmp_path),
        shardings={"w": None, "step": "cpu", "opt": [None, None]})
    assert isinstance(placed["step"], torch.Tensor)
    assert placed["step"].dtype == torch.int64 and int(placed["step"]) == 9


# ---------------------------------------------------------------------------
# failure handling of the file layer
# ---------------------------------------------------------------------------

def test_flipped_byte_raises_datacorruption(tmp_path):
    durable.save(_tree(5), str(tmp_path), 1)
    d = _snapshot_dir(str(tmp_path), 1)
    path = os.path.join(d, "params_h1.npy")
    raw = bytearray(open(path, "rb").read())
    raw[-3] ^= 0x10
    open(path, "wb").write(bytes(raw))
    with pytest.raises(fault.DataCorruption, match="crc32"):
        durable.load(str(tmp_path))
    got, _ = durable.load(str(tmp_path), on_corrupt="skip")
    assert "h1" not in got["params"] and "a" in got["params"]
    with pytest.raises(ValueError, match="on_corrupt"):
        durable.load(str(tmp_path), on_corrupt="ignore")


def test_stale_tmp_ignored_and_rotation_keeps_keep(tmp_path):
    root = str(tmp_path)
    for e in range(5):
        durable.save(_tree(e), root, e, keep=2)
    assert sorted(os.listdir(root)) == ["step_00000003", "step_00000004"]
    os.makedirs(os.path.join(root, "step_00000009.tmp"))
    # a torn meta is not offered either
    os.makedirs(os.path.join(root, "step_00000008"))
    open(os.path.join(root, "step_00000008", "meta.json"), "w").write("{")
    assert durable.latest_epoch(root) == 4
    _assert_tree_equal(durable.load(root)[0], _tree(4))
    durable.save(_tree(6), root, 6, keep=2)     # sweeps the stale tmp
    assert not any(d.endswith(".tmp") for d in os.listdir(root))
    with pytest.raises(ValueError, match="non-empty strings"):
        durable.save({"it's": np.zeros(1)}, root, 7)
    with pytest.raises(ValueError, match="not array-like"):
        durable.save({"x": object()}, root, 7)


def test_snapshot_interrupt_keeps_the_previous_snapshot(tmp_path):
    root = str(tmp_path)
    inj = fault.FailureInjector(fail_kinds={2: fault.SnapshotInterrupt})
    durable.save(_tree(1), root, 1, injector=inj)
    with pytest.raises(fault.SnapshotInterrupt):
        durable.save(_tree(2), root, 2, injector=inj)
    assert durable.latest_epoch(root) == 1
    assert os.path.isdir(os.path.join(root, "step_00000002.tmp"))
    durable.save(_tree(2), root, 2, injector=inj)   # fires once per step
    assert durable.latest_epoch(root) == 2
    _assert_tree_equal(durable.load(root)[0], _tree(2))


def test_async_save_holds_the_values_it_was_given(tmp_path):
    live = torch.zeros(1000, dtype=torch.int32)
    for e in range(3):
        live += 1
        durable.save({"regs": live}, str(tmp_path), e, async_=True)
    live += 100                       # after the calls, before the writes
    durable.flush()
    for e in range(3):
        got, _ = durable.load(str(tmp_path), e)
        np.testing.assert_array_equal(got["regs"], np.full(1000, e + 1))


# ---------------------------------------------------------------------------
# the data plane's snapshots
# ---------------------------------------------------------------------------

def _stats_pair(**kw):
    ref = jstats.NgramStats(jstats.StatsConfig(vocab=VOCAB, **kw))
    port = stats.NgramStats(stats.StatsConfig(vocab=VOCAB, device="cpu",
                                              seed=99, **kw))
    port.rebind_params(convert.stats_params_from_jax(ref.export_params(),
                                                     "cpu"))
    return ref, port


def _toks(shape, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(
        np.uint32)


@pytest.mark.parametrize("family", ["cyclic", "general"])
def test_stats_export_stream_matches_reference(tmp_path, family):
    ref, port = _stats_pair(family=family, hll_b=8, cms_log2_width=10)
    jss, tss = ref.init_stream(3), port.init_stream(3)
    lens = np.array([[16, 5, 0], [16, 16, 9]])
    for t in range(2):
        chunk = _toks((3, 16), t)
        jss = ref.update_stream(jss, chunk, lengths=lens[t])
        tss = port.update_stream(tss, chunk, lengths=lens[t])
    want = ref.export_stream(jss)
    _assert_tree_equal(port.export_stream(tss), want)
    # the reference's snapshot restores into a port instance of another
    # seed and continues as the reference does
    jdurable.save_stats_stream(ref, jss, str(tmp_path), 2)
    fresh = stats.NgramStats(stats.StatsConfig(vocab=VOCAB, family=family,
                                               hll_b=8, cms_log2_width=10,
                                               seed=404, device="cpu"))
    tss2, epoch = durable.restore_stats_stream(fresh, str(tmp_path))
    assert epoch == 2
    more = _toks((2, 3, 16), 7)
    jss = ref.update_stream_many(jss, more)
    tss2 = fresh.update_stream_many(tss2, more)
    _assert_tree_equal(fresh.export_stream(tss2), ref.export_stream(jss))


def test_decontam_export_stream_matches_reference(tmp_path):
    ref = jdecontam.Decontaminator(jdecontam.DecontamConfig(vocab=VOCAB,
                                                            log2_m=12))
    port = decontam.Decontaminator(decontam.DecontamConfig(
        vocab=VOCAB, log2_m=12, seed=55, device="cpu"))
    port.rebind_params(convert.decontam_params_from_jax(
        ref.export_stream(ref.init_stream(1))["params"], "cpu"))
    ev = _toks((2, 40), 11)
    ref.add_eval_set(ev)
    port.add_eval_set(ev)
    jss, tss = ref.init_stream(2), port.init_stream(2)
    chunk = np.concatenate([ev[:, :20], _toks((2, 20), 12)], axis=0)[:2]
    jss = ref.update_stream(jss, chunk, lengths=np.array([20, 7]))
    tss = port.update_stream(tss, chunk, lengths=np.array([20, 7]))
    _assert_tree_equal(port.export_stream(tss), ref.export_stream(jss))
    # the port's snapshot restores into the reference and continues
    durable.save_decontam_stream(port, tss, str(tmp_path), 1)
    other = jdecontam.Decontaminator(jdecontam.DecontamConfig(
        vocab=VOCAB, log2_m=12, seed=3))
    jss2, _ = jdurable.restore_decontam_stream(other, str(tmp_path))
    tail = _toks((2, 20), 13)
    jss = ref.update_stream(jss, tail)
    jss2 = other.update_stream(jss2, tail)
    np.testing.assert_array_equal(other.finalize_stream(jss2),
                                  ref.finalize_stream(jss))


def _dataplane_cfg(**kw):
    return dict(seq_len=128, batch_size=4, vocab=VOCAB, dedup=False, **kw)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_dataplane_snapshot_crosses_packages(tmp_path, writer):
    """Three steps in one package, a snapshot, three more in the other:
    the state equals an uninterrupted run of the reference."""
    ref = jpipeline.DataPlane(jpipeline.PipelineConfig(**_dataplane_cfg()))
    for step in range(6):
        ref.next_batch(step)
    jst = jstats.NgramStats(jstats.StatsConfig(seed=21))
    tst = stats.NgramStats(stats.StatsConfig(seed=31, device="cpu"))
    if writer == "reference":
        first = jpipeline.DataPlane(jpipeline.PipelineConfig(
            **_dataplane_cfg()))
        second = pipeline.DataPlane(pipeline.PipelineConfig(
            device="cpu", **_dataplane_cfg()), stats=tst)
    else:
        first = pipeline.DataPlane(pipeline.PipelineConfig(
            device="cpu", **_dataplane_cfg()),
            stats=stats.NgramStats(stats.StatsConfig(device="cpu")))
        first.stats.rebind_params(convert.stats_params_from_jax(
            ref.stats.export_params(), "cpu"))
        second = jpipeline.DataPlane(jpipeline.PipelineConfig(
            **_dataplane_cfg()), stats=jst)
    for step in range(3):
        first.next_batch(step)
    first.snapshot(str(tmp_path), 3)
    step = second.restore(str(tmp_path))
    assert step == 3
    for s in range(step, 6):
        second.next_batch(s)
    assert second.telemetry() == ref.telemetry()
    _assert_tree_equal(
        {k: v for k, v in second.stats_state.items()},
        {k: np.asarray(v) for k, v in ref.stats_state.items()})


# ---------------------------------------------------------------------------
# fault.py: the same behaviour as the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 42])
def test_chaos_schedule_same_as_reference(seed):
    kw = dict(replication=2, job_kill_rate=0.3, snapshot_interrupt_rate=0.2)
    ref = jfault.ChaosSchedule(seed, 40, 5, **kw)
    port = fault.ChaosSchedule(seed, 40, 5, **kw)
    assert len(port.events) == len(ref.events)
    for a, b in zip(port.events, ref.events):
        assert (a.batch, a.action, a.worker, a.delay_s) == (
            b.batch, b.action, b.worker, b.delay_s)
        assert (a.kind and a.kind.__name__) == (b.kind and b.kind.__name__)
    assert {t: k.__name__ for t, k in port.injector_kinds.items()} == {
        t: k.__name__ for t, k in ref.injector_kinds.items()}
    assert port.counts() == ref.counts()
    assert port._still_dead == ref._still_dead


def test_injector_watchdog_and_recovery_loop():
    inj = fault.FailureInjector(fail_at_steps=[3],
                                fail_kinds={5: fault.WorkerCrash})
    with pytest.raises(fault.InjectedFailure):
        inj.maybe_fail(3)
    inj.maybe_fail(3)                              # once per step
    with pytest.raises(fault.WorkerCrash):
        inj.maybe_fail(5)
    # synthetic durations, no wall clock: the same breaches as the reference
    durs = [1.0, 1.1, 0.9, 1.0, 1.05, 5.0, 1.0, 0.95, 9.0, 1.0] * 3
    wd, jwd = fault.Watchdog(window=12), jfault.Watchdog(window=12)
    got = [wd.observe(d, i) for i, d in enumerate(durs)]
    want = [jwd.observe(d, i) for i, d in enumerate(durs)]
    assert got == want and wd.stragglers == jwd.stragglers
    assert wd.times == jwd.times

    def run(mod):
        saved = {"step": 0}
        log = []

        def one(step):
            log.append(step)
            return {"x": step * step}
        res = mod.run_with_recovery(
            one, lambda s: saved.update(step=s), lambda: saved["step"],
            n_steps=9, ckpt_every=2,
            injector=mod.FailureInjector(fail_at_steps=[1, 4, 7]))
        return res, log
    (res, log), (jres, jlog) = run(fault), run(jfault)
    assert log == jlog
    assert res == jres and res["restarts"] == 3
