"""The port's replicated dedup service (``data/service.py``) against the
JAX package's, with the reference's draw carried across by
``repro_torch.convert``. Exact everywhere: flags, band shards, telemetry
counts that do not depend on timing.

* Under seeded ``ChaosSchedule`` storms (kills, revives, stragglers, flaky
  calls; each package's own schedule of the same seed, which are equal:
  tests/test_torch_durable.py) the port's service flags exactly what the
  reference's service and the in-process deduper flag, batch by batch,
  with zero recall loss at r >= 2, and every replica ends equal to the
  oracle's band.
* A reference service snapshot restores into the port's service (same
  topology and elastic) and continues bit-identically, and the reverse.
* ``run_dedup_job`` under a chaos schedule with job kills equals the
  ``add_batch`` loop; an elastic restore onto 3 workers at replication 1
  reproduces it.
* ``kill_worker`` keeps recall loss at 0.0 at r = 2; ``revive_worker``
  drains the repair queue. A slow-flagged worker hedges proactively (the
  flag set directly: no test here reads the wall clock).
"""
import numpy as np
import pytest
import torch

from repro.data import dedup as jdedup
from repro.data import service as jservice
from repro.train import fault as jfault
from repro_torch import convert
from repro_torch.data import dedup, service
from repro_torch.kernels import shard
from repro_torch.train import fault

# the suite runs test files side by side in worker processes: keep torch's
# CPU work to one thread so it does not crowd the others
torch.set_num_threads(1)


def _cfg(mod, **kw):
    base = dict(vocab=4096, n_signatures=32, lsh_bands=8, threshold=0.6)
    base.update(kw)
    if mod is dedup:
        base["device"] = "cpu"
    return mod.DedupConfig(**base)


def _docs(n=56, seed=3, dup_every=7):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, 4096, size=int(m)).astype(np.int32)
            for m in rng.integers(30, 300, size=n)]
    for i in range(dup_every, n, dup_every):
        docs[i] = docs[i - 2].copy()
    return docs


def _params(family="cyclic"):
    jd = jdedup.MinHashDeduper(_cfg(jdedup, family=family))
    return jd.export_state()["params"]


def _port_service(params, **svc_kw):
    svc = service.DedupService(
        _cfg(dedup, family=svc_kw.pop("family", "cyclic")),
        service.ServiceConfig(backoff_base_s=0.001, **svc_kw))
    svc.dd.import_params(convert.params_from_jax(params, "cpu"))
    return svc


STORMS = [(0, 4, 2, "cyclic"), (3, 5, 3, "general"), (9, 5, 2, "cyclic")]


@pytest.mark.parametrize("seed,n_workers,replication,family", STORMS)
def test_storm_flags_match_reference_service(seed, n_workers, replication,
                                             family):
    params = _params(family)
    docs = _docs(n=56, seed=100 + seed)
    jsched = jfault.ChaosSchedule(seed, n_batches=6, n_workers=n_workers,
                                  replication=replication)
    sched = fault.ChaosSchedule(seed, n_batches=6, n_workers=n_workers,
                                replication=replication)
    with jservice.DedupService(
            _cfg(jdedup, family=family),
            jservice.ServiceConfig(n_workers=n_workers,
                                   replication=replication,
                                   backoff_base_s=0.001)) as jsvc, \
         _port_service(params, n_workers=n_workers, replication=replication,
                       family=family) as svc, \
         dedup.MinHashDeduper(_cfg(dedup, family=family)) as oracle:
        oracle.import_params(convert.params_from_jax(params, "cpu"))
        jsvc.dd.import_params(params)
        for t in range(6):
            lo = t * 8
            jsched.apply(jsvc, t)
            sched.apply(svc, t)
            want = jsvc.add_batch(docs[lo:lo + 8])
            got = svc.add_batch(docs[lo:lo + 8])
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"storm {seed} batch {t}")
            np.testing.assert_array_equal(oracle.add_batch(docs[lo:lo + 8]),
                                          want)
            if svc.r >= 2:
                assert svc.telemetry()["recall_loss"] == 0.0, (seed, t)
        sched.finish(svc)
        tele = svc.telemetry()
        assert tele["recall_loss"] == 0.0 and tele["dead_replicas"] == 0
        assert tele["repair_queue_pairs"] == 0
        index = oracle.export_state()["index"]
        for b in range(svc.n_bands):
            want_band = dedup.unpack_band(index[f"band_{b:04d}"])
            for w in svc.replica_workers(b):
                assert w.shards[b] == want_band, (seed, b, w.worker_id)
        np.testing.assert_array_equal(svc.add_batch(docs[48:]),
                                      jsvc.add_batch(docs[48:]))


@pytest.mark.parametrize("topology", [(4, 2), (3, 1)])
def test_service_snapshot_crosses_packages(tmp_path, topology):
    params = _params()
    docs = _docs(n=48, seed=11)
    with jservice.DedupService(_cfg(jdedup), jservice.ServiceConfig(
            n_workers=4, replication=2)) as ref:
        ref.dd.import_params(params)
        want = [ref.add_batch(docs[i:i + 8]) for i in range(0, 48, 8)]
    # reference writes after three batches, the port finishes
    with jservice.DedupService(_cfg(jdedup), jservice.ServiceConfig(
            n_workers=4, replication=2)) as first:
        first.dd.import_params(params)
        for i in range(0, 24, 8):
            first.add_batch(docs[i:i + 8])
        first.snapshot(str(tmp_path / "ref"), 3, extra={"cursor": 24})
    n_workers, replication = topology
    with service.DedupService(_cfg(dedup, seed=5), service.ServiceConfig(
            n_workers=n_workers, replication=replication)) as second:
        epoch, extra = second.restore(str(tmp_path / "ref"))
        assert epoch == 3 and int(extra["cursor"]) == 24
        got = [second.add_batch(docs[i:i + 8]) for i in range(24, 48, 8)]
        assert second.telemetry()["resumes"] == 1
        second.snapshot(str(tmp_path / "port"), 6)
    for g, w in zip(got, want[3:]):
        np.testing.assert_array_equal(g, w)
    # and the port's snapshot restores into the reference
    with jservice.DedupService(_cfg(jdedup, seed=9), jservice.ServiceConfig(
            n_workers=4, replication=2)) as third:
        third.restore(str(tmp_path / "port"))
        assert len(third) == len(second)
        np.testing.assert_array_equal(third.add_batch(docs[:8]),
                                      np.ones(8, bool))


def test_dedup_job_under_chaos_and_elastic_restore(tmp_path):
    params = _params()
    docs = _docs(n=64, seed=21)
    with dedup.MinHashDeduper(_cfg(dedup)) as oracle:
        oracle.import_params(convert.params_from_jax(params, "cpu"))
        want = np.concatenate([oracle.add_batch(docs[i:i + 8])
                               for i in range(0, 64, 8)])
    chaos = fault.ChaosSchedule(2, n_batches=8, n_workers=4, replication=2,
                                job_kill_rate=0.5)
    assert chaos.counts()["job_kills"] > 0
    with _port_service(params, n_workers=4, replication=2) as svc:
        res = service.run_dedup_job(svc, docs, directory=str(tmp_path),
                                    batch_docs=8, snapshot_every=2,
                                    chaos=chaos)
        assert res["restarts"] > 0 and res["batches"] == 8
        np.testing.assert_array_equal(res["flags"], want)
        with pytest.raises(ValueError, match="not both"):
            service.run_dedup_job(svc, docs, directory=str(tmp_path),
                                  chaos=chaos,
                                  injector=fault.FailureInjector())
    # a fresh service of another shape against the same directory: every
    # batch is already snapshotted, so the flags come back from the job
    with service.DedupService(_cfg(dedup), service.ServiceConfig(
            n_workers=3, replication=1)) as other:
        res = service.run_dedup_job(other, docs, directory=str(tmp_path),
                                    batch_docs=8, snapshot_every=2)
        np.testing.assert_array_equal(res["flags"], want)
        assert len(other) == len(svc)


def test_kill_revive_and_proactive_hedge():
    params = _params()
    docs = _docs(n=40, seed=31)
    with _port_service(params, n_workers=4, replication=2) as svc, \
         dedup.MinHashDeduper(_cfg(dedup)) as oracle:
        oracle.import_params(convert.params_from_jax(params, "cpu"))
        np.testing.assert_array_equal(svc.add_batch(docs[:16]),
                                      oracle.add_batch(docs[:16]))
        svc.kill_worker(1)
        np.testing.assert_array_equal(svc.add_batch(docs[16:28]),
                                      oracle.add_batch(docs[16:28]))
        tele = svc.telemetry()
        assert tele["recall_loss"] == 0.0 and tele["dead_replicas"] > 0
        assert tele["repair_queue_pairs"] > 0
        svc.revive_worker(1)
        tele = svc.telemetry()
        assert tele["repair_queue_pairs"] == 0 and tele["dead_replicas"] == 0
        assert tele["repairs"] > 0
        # a worker the watchdog flagged slow hedges at once to its replica
        svc._slow[:] = True
        before = svc.telemetry()["proactive_hedges"]
        np.testing.assert_array_equal(svc.add_batch(docs[28:]),
                                      oracle.add_batch(docs[28:]))
        assert svc.telemetry()["proactive_hedges"] > before


def test_worker_semantics():
    w = service.ShardWorker(0, [0, 4],
                            injector=fault.FailureInjector(
                                fail_kinds={3: fault.ProbeTimeout}))
    w.call("insert", 0, [b"k1", b"k2"], [5, 6])
    w.call("insert", 0, [b"k1", b"k2"], [5, 6])   # the retried RPC
    assert w.shards[0] == {b"k1": [5], b"k2": [6]}
    with pytest.raises(fault.ProbeTimeout):
        w.call("digest", 0)
    assert w.call("digest", 0) == {b"k1": 1, b"k2": 1}
    with pytest.raises(fault.DataCorruption):
        w.call("probe", 1, np.zeros(2, np.uint32))
    w.fail_next.append(fault.WorkerCrash)
    with pytest.raises(fault.WorkerCrash):
        w.call("digest", 4)
    w.dead = True
    with pytest.raises(fault.WorkerCrash, match="down"):
        w.call("digest", 4)
    # the service hands its mesh to its deduper, whose signing runs on it
    mesh = shard.data_mesh(2, device="cpu")
    svc = service.DedupService(_cfg(dedup), mesh=mesh)
    assert svc.dd.mesh is mesh
    svc.close()
