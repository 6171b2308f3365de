"""DedupService: the band-sharded LSH index as a replicated, self-healing
fault-tolerant service.

`BandShardedLSHIndex` keeps every band shard in one process; this module
deploys the same state across ``n_workers`` shard workers **R-way
replicated** — replica ``j`` of band ``b`` lives on worker
``(b + j * stride) % n_workers`` with ``stride = max(1, n_workers // R)``,
a pure function of the ids (the same stateless-placement idiom as
``pipeline.py``'s sampling), so replicas of a band are never colocated and
elastic restore onto a different worker count is just re-evaluating the
rule — and wraps every probe/insert in the failure envelope a real
deployment needs:

* **scatter/gather probes** — a batch probe fans one group-by per band
  across the owning workers and combines the shard results into per-doc
  candidate sets *before* the sequential verify loop, so (exactly as in
  the in-process index) the schedule cannot affect verdicts.
* **failover, not degradation** — each band call targets its first live
  replica; transport-class failures (:class:`WorkerCrash`,
  :class:`ProbeTimeout`, ``ConnectionError``) retry with seeded
  full-jitter backoff (``uniform(0, delay)``, delay doubling to
  ``backoff_cap_s`` — lockstep wakeups against the same dead worker would
  thunder-herd it) **against the next live replica**, never the same
  worker twice in a row. While any band keeps ≥1 live replica, verdicts
  stay **bit-identical to the in-process index with zero recall loss**.
* **hedged probes to a replica** — with ``hedge_after_s > 0`` a duplicate
  probe goes to the *next live replica* (a straggling worker cannot slow
  its own hedge) when the first has not returned in time; first result
  wins, wins attributed per replica slot. A per-worker
  :class:`~repro_torch.train.fault.Watchdog` over RPC latencies feeds a
  slow-replica signal that triggers the hedge *proactively* — tail
  mitigation before the timeout, not just after it.
* **replicated inserts + write-behind catch-up** — inserts fan out to all
  live replicas of a band (idempotent: a retried RPC cannot double-add);
  a dead replica's share is queued, and on revival the replica is
  **read-repaired** — queued writes replayed, then an anti-entropy digest
  diff of band keys against a live peer — before it rejoins the probe
  rotation, so a revived replica can never serve stale candidates.
* **graceful degradation as the last resort** — only a band whose
  replicas are *all* dead degrades: probes skip it and the service keeps
  answering under the widened false-negative bound ``1-(1-s^r)^live``
  (``r`` rows/band, ``live`` bands with ≥1 clean replica) instead of
  ``1-(1-s^r)^b``. Telemetry (:meth:`DedupService.telemetry`) surfaces
  the recall loss — now usually zero — plus per-replica hedge wins,
  failovers, repair traffic and in-flight gauges.
* **bounded transport** — a per-worker in-flight semaphore caps concurrent
  attempts, so calls stuck past their deadline (a cancel cannot stop an
  already-running RPC) can exhaust neither the shared pool nor the other
  workers' throughput; saturation is a fast, counted, non-striking
  failure that fails over immediately.
* **durable state** — :meth:`snapshot` / :meth:`DedupService.restore`
  checkpoint params, signatures, every replica's band shard, the dead
  mask and the repair queue through ``data/durable.py``'s crc-verified
  atomic format; restore re-binds params first, re-replicates onto the
  *current* topology, and read-repairs any crc-corrupt replica leaf from
  an intact snapshot peer instead of failing the job.

`run_dedup_job` closes the loop: a corpus-scale dedup job that snapshots
every ``snapshot_every`` batches and replays from its latest atomic
snapshot on an injected kill — driven by the same
``train/fault.run_with_recovery`` loop the trainer uses. The whole
envelope is certified not by hand-picked single-failure scripts but by
seeded ``train/fault.ChaosSchedule`` storms (tests/test_chaos.py):
randomized kill/revive/slow/flaky sequences under which verdicts must
stay bit-identical to the fault-free oracle whenever every band retains a
live replica.

Workers here are in-process objects behind an executor, but the call
surface is an RPC's: every access goes through ``ShardWorker.call`` with a
deadline, and the fault injector can script a crash/timeout/corruption at
any op ordinal — the recovery paths, which are the point, are real.

This is the port of the JAX package's ``data/service.py``: the same
placement, envelope, counters and snapshot layout, so a service snapshot
of either package restores in the other. Signing runs on the calling
thread through the port's ``MinHashDeduper.signature_many`` (the plan
kernel on CUDA); the band shards and every worker thread touch only numpy. A ``mesh``
(or ``DedupConfig.data_shards``) goes to the deduper, whose signing then
runs over that data mesh; the band shards stay numpy.
"""
from __future__ import annotations

import dataclasses
import re
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FuturesTimeout
from concurrent.futures import wait as _wait
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data import durable
from repro_torch.data.dedup import (BandShardedLSHIndex, DedupConfig,
                                    MinHashDeduper, _fold_candidates,
                                    pack_band, unpack_band)
from repro_torch.train import fault as _fault
from repro_torch.train.fault import (DataCorruption, FailureInjector,
                                     ProbeTimeout, Watchdog, WorkerCrash)

_RETRYABLE = (WorkerCrash, ProbeTimeout, ConnectionError, _FuturesTimeout)
# corruption is not retryable against the same replica (same bytes fail
# again) but IS recoverable by failing over to a peer replica
_FAILOVER = _RETRYABLE + (DataCorruption,)

_COUNTERS = ("probes", "probe_calls", "retries", "retry_successes",
             "failovers", "hedges", "hedge_wins", "proactive_hedges",
             "failed_probes", "skipped_probes",
             "dropped_inserts", "queued_inserts",
             "replica_deaths", "repairs", "failed_repairs", "repair_bytes",
             "saturated_rejects", "snapshots", "resumes")

_BAND_KEY_RE = re.compile(r"band_(\d+)(?:_r(\d+))?$")
_PACK_KEYS = ("key_bytes", "key_offsets", "ids", "id_offsets")


class _Saturated(ProbeTimeout):
    """The per-worker in-flight cap refused a submit: the worker may be
    fine — WE are overloaded — so failover must not strike the replica."""


class ShardWorker:
    """One worker process's shard set: ``{band_id: {key: [doc_id, ...]}}``.

    The call surface is deliberately RPC-shaped: a single :meth:`call`
    entry point per op so deadline enforcement, fault injection and (in a
    real deployment) serialization wrap one seam. ``injector`` scripts
    failures by the worker's own op ordinal; ``fail_next`` queues
    exception classes raised one per call (the :class:`ChaosSchedule`
    flaky seam); ``dead`` simulates a crashed process (every call
    refused); ``delay_s`` a straggler (each call sleeps first — the
    hedging/timeout test knob).
    """

    def __init__(self, worker_id: int, band_ids: Sequence[int],
                 injector: Optional[FailureInjector] = None):
        self.worker_id = worker_id
        self.shards: Dict[int, Dict[bytes, List[int]]] = {
            int(b): {} for b in band_ids}
        self.injector = injector
        self.dead = False
        self.delay_s = 0.0
        self.fail_next: List[type] = []
        self.ops = 0

    def call(self, op: str, band: int, *args):
        self.ops += 1
        if self.injector is not None:
            self.injector.maybe_fail(self.ops)
        if self.fail_next:
            kind = self.fail_next.pop(0)
            raise kind(f"chaos {kind.__name__} on worker {self.worker_id}")
        if self.dead:
            raise WorkerCrash(f"worker {self.worker_id} is down")
        if self.delay_s:
            time.sleep(self.delay_s)
        if band not in self.shards:
            raise DataCorruption(f"band {band} not owned by worker "
                                 f"{self.worker_id}")
        if op == "probe":
            return self._probe(band, *args)
        if op == "insert":
            return self._insert(band, *args)
        if op == "digest":
            return self._digest(band)
        if op == "fetch":
            return self._fetch(band, *args)
        if op == "merge":
            return self._merge(band, *args)
        raise ValueError(f"unknown op {op!r}")

    # one band's vectorized group-by, the in-process index's probe unit:
    # (D,) void keys -> [(members, hits)] with members ascending
    _probe = BandShardedLSHIndex._probe_shard

    def _insert(self, band: int, keys: Sequence[bytes],
                doc_ids: Sequence[int]) -> int:
        """Idempotent batched insert (a retried RPC must not double-add)."""
        shard_b = self.shards[band]
        for kb, doc_id in zip(keys, doc_ids):
            lst = shard_b.setdefault(kb, [])
            if not lst or lst[-1] != doc_id:   # ids arrive in order
                lst.append(doc_id)
        return len(keys)

    def _digest(self, band: int) -> Dict[bytes, int]:
        """Anti-entropy summary: per-key member counts. Cheap relative to
        the full band (ids elided), and count comparison catches both
        missing keys and under-filled ones on a lagging replica."""
        return {k: len(v) for k, v in self.shards[band].items()}

    def _fetch(self, band: int, keys: Sequence[bytes]) -> List[List[int]]:
        """Read-repair source side: full member lists for the given keys."""
        shard_b = self.shards[band]
        return [list(shard_b.get(k, ())) for k in keys]

    def _merge(self, band: int, keys: Sequence[bytes],
               id_lists: Sequence[Sequence[int]]) -> int:
        """Read-repair sink side: sorted-union merge. Doc ids are assigned
        ascending and appended in order, so sorted-union reproduces the
        exact list a never-failed replica would hold — and the op is
        idempotent, so a retried repair RPC is safe."""
        shard_b = self.shards[band]
        for kb, ids in zip(keys, id_lists):
            lst = shard_b.setdefault(kb, [])
            lst[:] = sorted(set(lst) | set(int(i) for i in ids))
        return len(keys)


@dataclasses.dataclass
class ServiceConfig:
    """Fault-tolerance envelope of a :class:`DedupService`."""

    n_workers: int = 4
    # R-way shard replication: replica j of band b on worker
    # (b + j*stride) % n_workers, stride = max(1, n_workers // R) — never
    # colocated. Clamped to n_workers (1 worker cannot hold 2 replicas).
    replication: int = 2
    probe_timeout_s: float = 5.0
    max_retries: int = 2
    backoff_base_s: float = 0.005
    backoff_cap_s: float = 0.1
    # > 0: issue a duplicate probe to the NEXT LIVE REPLICA when the first
    # attempt has not returned within this many seconds; first result wins
    hedge_after_s: float = 0.0
    # seeds the full-jitter backoff RNG (tests stay reproducible)
    seed: int = 0
    # consecutive transport failures before a replica is marked dead and
    # leaves the probe rotation (a single transient blip must not kill it)
    dead_after_strikes: int = 2
    # per-worker concurrent-attempt cap (None: sized from the topology);
    # stuck calls a cancel cannot stop then saturate one worker's budget,
    # never the shared RPC pool
    max_in_flight_per_worker: Optional[int] = None
    # per-worker latency Watchdog (median + factor*MAD over `window` calls
    # after `warmup`): a breach flags the worker slow -> proactive hedging
    watchdog_factor: float = 3.0
    watchdog_warmup: int = 8
    watchdog_window: int = 128

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if self.replication < 1:
            raise ValueError(f"replication must be >= 1, "
                             f"got {self.replication}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")


class DedupService:
    """Corpus dedup as a durable, replicated, self-healing service.

    Signing rides the deduper's streaming executor unchanged, on the
    calling thread; only the index plane is re-homed onto workers. ``add_batch`` verdicts are bit-identical to
    :class:`~repro_torch.data.dedup.MinHashDeduper` while every band keeps at
    least one live replica — through any ``< replication`` worker deaths,
    asserted under seeded chaos storms — and degrade to documented
    false-negative widening (never crashes, never false positives beyond
    the estimator's own) only when a band loses *all* its replicas.
    """

    def __init__(self, cfg: DedupConfig, svc: Optional[ServiceConfig] = None,
                 mesh=None):
        self.svc = svc or ServiceConfig()
        self.dd = MinHashDeduper(cfg, mesh=mesh)
        self.n_bands = cfg.lsh_bands
        self.r = min(self.svc.replication, self.svc.n_workers)
        self._stride = max(1, self.svc.n_workers // self.r)
        self._sigs: List[np.ndarray] = []
        # (band, replica) liveness + failure-streak bookkeeping
        self.dead = np.zeros((self.n_bands, self.r), bool)
        self._strikes = np.zeros((self.n_bands, self.r), np.int64)
        # write-behind catch-up: (band, j) -> {key: [doc_id, ...]} pending
        # merge into a dead/failed replica at read-repair time
        self._repair_q: Dict[Tuple[int, int], Dict[bytes, List[int]]] = {}
        self.t = {k: 0 for k in _COUNTERS}
        self.hedge_wins_by_replica = np.zeros(self.r, np.int64)
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(self.svc.seed)
        self.workers: List[ShardWorker] = []
        self._build_workers()
        n = self.svc.n_workers
        self._max_inflight = (self.svc.max_in_flight_per_worker
                              or max(8, 2 * -(-self.n_bands * self.r // n)))
        self._sems = [threading.BoundedSemaphore(self._max_inflight)
                      for _ in range(n)]
        self._inflight = np.zeros(n, np.int64)
        self._inflight_peak = 0
        self._wd = [Watchdog(factor=self.svc.watchdog_factor,
                             warmup=self.svc.watchdog_warmup,
                             window=self.svc.watchdog_window)
                    for _ in range(n)]
        self._slow = np.zeros(n, bool)
        # transport pool: every (band x replica) call in flight plus hedges
        self._rpc = ThreadPoolExecutor(
            max_workers=max(2 * self.n_bands * self.r, 4))

    def _build_workers(self) -> None:
        n = self.svc.n_workers
        owned = [[b for b in range(self.n_bands)
                  if w in self._replica_ids(b)] for w in range(n)]
        self.workers = [ShardWorker(w, bands) for w, bands in enumerate(owned)]

    # -- placement ----------------------------------------------------------

    def _replica_ids(self, band: int) -> List[int]:
        n = self.svc.n_workers
        return [(band + j * self._stride) % n for j in range(self.r)]

    def replica_workers(self, band: int) -> List[ShardWorker]:
        """Stateless placement: replica j of band b on worker
        (b + j*stride) % n_workers — R distinct workers (stride =
        n_workers // R keeps every offset below n_workers)."""
        return [self.workers[w] for w in self._replica_ids(band)]

    def owner(self, band: int) -> ShardWorker:
        """Primary replica's worker (replica 0)."""
        return self.workers[band % self.svc.n_workers]

    def live_replicas(self, band: int) -> List[Tuple[int, ShardWorker]]:
        """Replicas eligible to serve probes: not dead AND fully caught up
        (a replica with queued write-behind must be read-repaired before
        rejoining the rotation — stale candidates would break verdict
        bit-parity)."""
        return [(j, w) for j, w in enumerate(self.replica_workers(band))
                if not self.dead[band, j]
                and (band, j) not in self._repair_q]

    def close(self) -> None:
        self._rpc.shutdown(wait=False)
        self.dd.close()

    def __enter__(self) -> "DedupService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- failure envelope ---------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.t[key] += n

    def _jitter(self, delay: float) -> float:
        """Seeded FULL jitter: uniform(0, delay). A deterministic
        min(delay*2, cap) wakes every band retrying the same dead worker
        in lockstep — the classic thundering herd."""
        with self._lock:
            return float(self._rng.uniform(0.0, delay))

    def _strike(self, band: int, j: int, fatal: bool = False) -> None:
        """One transport failure against replica (band, j); at
        ``dead_after_strikes`` consecutive strikes (immediately when
        ``fatal`` — corruption cannot heal by retrying) the replica is
        marked dead and leaves the probe rotation until read-repaired."""
        with self._lock:
            self._strikes[band, j] += (self.svc.dead_after_strikes
                                       if fatal else 1)
            if (self._strikes[band, j] >= self.svc.dead_after_strikes
                    and not self.dead[band, j]):
                self.dead[band, j] = True
                self.t["replica_deaths"] += 1

    def _clear_strikes(self, band: int, j: int) -> None:
        with self._lock:
            self._strikes[band, j] = 0

    def _submit(self, worker: ShardWorker, op: str, band: int, *args):
        """Bounded submit: acquires the worker's in-flight permit (held
        until the call actually finishes — cancel cannot stop a running
        call, so permits, not optimism, bound the leak) and feeds the
        per-worker latency Watchdog from the completion callback."""
        wid = worker.worker_id
        sem = self._sems[wid]
        if not sem.acquire(blocking=False):
            self._bump("saturated_rejects")
            raise _Saturated(f"worker {wid} transport saturated "
                             f"({self._max_inflight} attempts in flight)")
        with self._lock:
            self._inflight[wid] += 1
            self._inflight_peak = max(self._inflight_peak,
                                      int(self._inflight.sum()))
        t0 = time.monotonic()
        try:
            fut = self._rpc.submit(worker.call, op, band, *args)
        except BaseException:
            with self._lock:
                self._inflight[wid] -= 1
            sem.release()
            raise

        def _done(f, wid=wid, t0=t0):
            with self._lock:
                self._inflight[wid] -= 1
                if not f.cancelled() and f.exception() is None:
                    wd = self._wd[wid]
                    self._slow[wid] = wd.observe(
                        time.monotonic() - t0, len(wd.times))
            sem.release()

        fut.add_done_callback(_done)
        return fut

    def _race(self, futmap: Dict, budget_s: float, band: int, op: str,
              hedge=None):
        """First successful future wins; hedge wins attributed to the
        winning replica slot. Keeps the first error for the caller."""
        deadline = time.monotonic() + budget_s
        pending = set(futmap)
        first_err = None
        while pending:
            done, pending = _wait(
                pending, timeout=max(0.0, deadline - time.monotonic()),
                return_when=FIRST_COMPLETED)
            if not done:           # overall deadline elapsed
                break
            for f in done:
                if f.exception() is None:
                    if hedge is not None and f is hedge:
                        self._bump("hedge_wins")
                        with self._lock:
                            self.hedge_wins_by_replica[futmap[f]] += 1
                    return f.result()
                first_err = first_err or f.exception()
        for f in pending:
            f.cancel()
        if first_err is not None:
            raise first_err
        raise ProbeTimeout(f"{op} band {band}: deadline {budget_s}s "
                           f"elapsed (hedged)")

    def _attempt(self, band: int, rot: List[Tuple[int, ShardWorker]],
                 op: str, *args):
        """One bounded call against ``rot[0]``, hedged to ``rot[1]``.

        The hedge target is the next live REPLICA — a straggling worker
        cannot slow its own hedge (at replication 1 the old same-worker
        duplicate is the only option left). A Watchdog-flagged slow
        primary hedges proactively: both submits race immediately instead
        of waiting out ``hedge_after_s``.
        """
        j0, w0 = rot[0]
        j1, w1 = rot[1] if len(rot) > 1 else rot[0]
        budget = self.svc.probe_timeout_s
        self._bump("probe_calls")
        if self._slow[w0.worker_id] and len(rot) > 1:
            f1 = self._submit(w0, op, band, *args)
            self._bump("hedges")
            self._bump("proactive_hedges")
            self._bump("probe_calls")
            try:
                f2 = self._submit(w1, op, band, *args)
            except _Saturated:
                return self._race({f1: j0}, budget, band, op)
            return self._race({f1: j0, f2: j1}, budget, band, op, hedge=f2)
        f1 = self._submit(w0, op, band, *args)
        if self.svc.hedge_after_s <= 0:
            try:
                return f1.result(timeout=budget)
            except _FuturesTimeout:
                f1.cancel()
                raise ProbeTimeout(f"{op} band {band}: deadline "
                                   f"{budget}s elapsed") from None
        done, _ = _wait([f1], timeout=min(self.svc.hedge_after_s, budget))
        if f1 in done:
            return f1.result()
        self._bump("hedges")
        self._bump("probe_calls")
        try:
            f2 = self._submit(w1, op, band, *args)
        except _Saturated:
            f2 = None
        futmap = {f1: j0}
        if f2 is not None:
            futmap[f2] = j1
        return self._race(futmap, budget - self.svc.hedge_after_s,
                          band, op, hedge=f2)

    def _with_retry(self, band: int, op: str, *args):
        """Jittered backoff + replica failover around :meth:`_attempt`:
        attempt k targets the k-th rotation of the band's live replicas,
        so a retry lands on the NEXT live replica, not the worker that
        just failed."""
        delay = self.svc.backoff_base_s
        err = None
        for attempt in range(self.svc.max_retries + 1):
            reps = self.live_replicas(band)
            if not reps:
                if err is not None:
                    raise err
                raise WorkerCrash(f"band {band}: no live replica")
            k = attempt % len(reps)
            rot = reps[k:] + reps[:k]
            if attempt and len(reps) > 1:
                self._bump("failovers")
            try:
                out = self._attempt(band, rot, op, *args)
                if attempt:
                    self._bump("retry_successes")
                self._clear_strikes(band, rot[0][0])
                return out
            except _FAILOVER as e:
                err = e
                if not isinstance(e, _Saturated):
                    self._strike(band, rot[0][0],
                                 fatal=isinstance(e, DataCorruption))
                if attempt < self.svc.max_retries:
                    self._bump("retries")
                    time.sleep(self._jitter(delay))
                    delay = min(delay * 2, self.svc.backoff_cap_s)
        raise err

    def _call_replica(self, band: int, j: int, worker: ShardWorker,
                      op: str, *args):
        """Bounded retry pinned to ONE replica (inserts and repair traffic
        must reach *that* copy; there is no failover target)."""
        delay = self.svc.backoff_base_s
        err = None
        for attempt in range(self.svc.max_retries + 1):
            try:
                out = self._attempt(band, [(j, worker)], op, *args)
                if attempt:
                    self._bump("retry_successes")
                self._clear_strikes(band, j)
                return out
            except DataCorruption as e:
                self._strike(band, j, fatal=True)
                raise e
            except _RETRYABLE as e:
                err = e
                if not isinstance(e, _Saturated):
                    self._strike(band, j)
                if attempt < self.svc.max_retries:
                    self._bump("retries")
                    time.sleep(self._jitter(delay))
                    delay = min(delay * 2, self.svc.backoff_cap_s)
        raise err

    # -- replica lifecycle: kill / revive / read-repair ---------------------

    def kill_worker(self, worker_id: int) -> None:
        """Deterministic failure-detector path (chaos kills use it): the
        worker refuses every call and all its replicas leave the rotation
        at once, instead of each discovering the death by striking out."""
        wk = self.workers[worker_id]
        wk.dead = True
        with self._lock:
            for b in range(self.n_bands):
                for j, w in enumerate(self._replica_ids(b)):
                    if w == worker_id and not self.dead[b, j]:
                        self.dead[b, j] = True
                        self.t["replica_deaths"] += 1

    def revive_worker(self, worker_id: int) -> None:
        """Worker returns: read-repair every replica it hosts (queued
        write-behind replayed + anti-entropy diff against a live peer)
        before those replicas rejoin the probe rotation."""
        wk = self.workers[worker_id]
        wk.dead = False
        wk.delay_s = 0.0
        for b in range(self.n_bands):
            for j, w in enumerate(self._replica_ids(b)):
                if w == worker_id and (self.dead[b, j]
                                       or (b, j) in self._repair_q):
                    self._read_repair(b, j)

    def revive(self, band: Optional[int] = None) -> None:
        """Clear dead marks (operator action after workers return),
        read-repairing each revived replica from its live peers first."""
        bands = range(self.n_bands) if band is None else (band,)
        for b in bands:
            for j in range(self.r):
                if self.dead[b, j] or (b, j) in self._repair_q:
                    self._read_repair(b, j)

    def _read_repair(self, band: int, j: int) -> int:
        """Catch a replica up and return it to the rotation: replay its
        write-behind queue, then anti-entropy — digest (per-key member
        counts) from a live peer vs the replica's own, fetch + merge only
        the keys where the replica lags. Returns bytes transferred; on
        transport failure the replica stays out of the rotation."""
        target = self.replica_workers(band)[j]
        with self._lock:
            q = self._repair_q.pop((band, j), None)
        moved = 0
        try:
            if q:
                keys = list(q.keys())
                lists = [q[k] for k in keys]
                self._call_replica(band, j, target, "merge", keys, lists)
                moved += (sum(len(k) for k in keys)
                          + 8 * sum(len(v) for v in lists))
            peers = self.live_replicas(band)
            peers = [(j2, w2) for j2, w2 in peers if j2 != j]
            if peers:
                j2, w2 = peers[0]
                peer_digest = self._call_replica(band, j2, w2, "digest")
                own_digest = self._call_replica(band, j, target, "digest")
                need = [k for k, c in peer_digest.items()
                        if own_digest.get(k, 0) < c]
                if need:
                    lists = self._call_replica(band, j2, w2, "fetch", need)
                    self._call_replica(band, j, target, "merge", need, lists)
                    moved += (sum(len(k) for k in need)
                              + 8 * sum(len(v) for v in lists))
        except _FAILOVER:
            self._bump("failed_repairs")
            if q:                     # repair failed: keep the queue
                with self._lock:
                    merged = self._repair_q.setdefault((band, j), {})
                    for k, v in q.items():
                        got = merged.setdefault(k, [])
                        got[:] = sorted(set(got) | set(v))
            return moved
        with self._lock:
            self.dead[band, j] = False
            self._strikes[band, j] = 0
        self._bump("repairs")
        self._bump("repair_bytes", moved)
        return moved

    def _queue_repair(self, band: int, j: int,
                      pairs: Sequence[Tuple[bytes, int]]) -> None:
        """Write-behind: bank a dead replica's share of an insert for the
        catch-up replay at read-repair time (idempotent, like the RPC)."""
        with self._lock:
            q = self._repair_q.setdefault((band, j), {})
            for kb, doc_id in pairs:
                lst = q.setdefault(kb, [])
                if not lst or lst[-1] != doc_id:
                    lst.append(doc_id)

    # -- the probe/insert plane ---------------------------------------------

    def _probe_batch(self, kb: np.ndarray):
        """Scatter one group-by per band to its first live replica, gather
        candidate sets. A band whose replicas all strike out is lost *for
        subsequent batches*; this batch proceeds without its candidates."""
        D = kb.shape[0]
        self.t["probes"] += 1
        live = [b for b in range(self.n_bands) if self.live_replicas(b)]
        self.t["skipped_probes"] += self.n_bands - len(live)

        def one(b):
            col = np.ascontiguousarray(kb[:, b])
            try:
                return self._with_retry(b, "probe", col)
            except _FAILOVER:
                self._bump("failed_probes")
                return []

        # gather fan-out: the per-band retry pipelines run concurrently
        # (each issues its own transport calls on the rpc pool)
        if len(live) > 1:
            with ThreadPoolExecutor(max_workers=len(live)) as pool:
                per_band = list(pool.map(one, live))
        else:
            per_band = [one(b) for b in live]
        return _fold_candidates(per_band, D)

    def _insert_bands(self, inserts: Dict[int, List]) -> None:
        """Flush one batch's inserts, fanned out to every replica of each
        band; a dead or failing replica's share is queued write-behind
        (replayed at read-repair). Only a fully-lost band drops inserts
        from the *serving* path — and even those sit in the queue awaiting
        a revive."""
        for b, pairs in inserts.items():
            keys = [k for k, _ in pairs]
            ids = [i for _, i in pairs]
            applied = 0
            for j, w in enumerate(self.replica_workers(b)):
                if self.dead[b, j] or (b, j) in self._repair_q:
                    self._queue_repair(b, j, pairs)
                    self._bump("queued_inserts", len(pairs))
                    continue
                try:
                    self._call_replica(b, j, w, "insert", keys, ids)
                    applied += 1
                except _FAILOVER:
                    self._queue_repair(b, j, pairs)
                    self._bump("queued_inserts", len(pairs))
            if applied == 0:
                self._bump("dropped_inserts", len(pairs))

    def add_batch(self, docs: Sequence[np.ndarray]) -> np.ndarray:
        """Dedup a document batch; (D,) bool duplicate flags — the
        service-plane twin of ``MinHashDeduper.add_batch`` (bit-identical
        while every band keeps a live replica; verify loop and first-wins
        order shared)."""
        D = len(docs)
        flags = np.zeros(D, bool)
        if D == 0:
            return flags
        sigs = self.dd.signature_many(docs)
        kb = self.dd._band_keys(sigs)
        index_cand, batch_cand = self._probe_batch(kb)
        inserts: Dict[int, List] = {}
        gid: List[Optional[int]] = [None] * D
        for i in range(D):
            cands = set(index_cand[i])
            cands.update(gid[j] for j in batch_cand[i] if gid[j] is not None)
            best_j, best_id = self._best_match(sigs[i], sorted(cands))
            if best_id is not None and best_j >= self.dd.cfg.threshold:
                flags[i] = True
            else:
                doc_id = len(self._sigs)
                self._sigs.append(sigs[i])
                gid[i] = doc_id
                for b in range(self.n_bands):
                    inserts.setdefault(b, []).append(
                        (kb[i, b].tobytes(), doc_id))
        self._insert_bands(inserts)
        return flags

    # the in-process deduper's verify, over this service's kept signatures
    _best_match = MinHashDeduper._best_match

    def __len__(self):
        return len(self._sigs)

    # -- telemetry ----------------------------------------------------------

    def recall_bound(self, jaccard: Optional[float] = None) -> Dict[str, float]:
        """LSH detection probability for a true duplicate at ``jaccard``
        (default: the configured threshold): ``1-(1-s^r)^bands``, full vs
        live. With replication a band counts as live while ANY of its
        replicas can serve probes — it is lost (and the false-negative
        bound widens) only when all of them are dead."""
        s = self.dd.cfg.threshold if jaccard is None else jaccard
        r = self.dd.rows
        p = min(max(s, 0.0), 1.0) ** r
        live = sum(1 for b in range(self.n_bands) if self.live_replicas(b))
        return {"full": 1.0 - (1.0 - p) ** self.n_bands,
                "live": 1.0 - (1.0 - p) ** live}

    def telemetry(self) -> Dict[str, float]:
        """One-shot counter snapshot (the `serve/telemetry.py` idiom: all
        accounting accumulates inline, the read side derives rates once)."""
        rb = self.recall_bound()
        lost = int(sum(1 for b in range(self.n_bands)
                       if not self.live_replicas(b)))
        with self._lock:
            out = dict(self.t)
            in_flight = int(self._inflight.sum())
            peak = self._inflight_peak
            wins = self.hedge_wins_by_replica.copy()
            queued = sum(sum(len(v) for v in q.values())
                         for q in self._repair_q.values())
        out.update({
            "n_workers": self.svc.n_workers,
            "replication": self.r,
            "dead_replicas": int(self.dead.sum()),
            "lost_bands": lost,
            # pre-replication name for the same headline quantity: bands
            # with no live replica (== dead bands at replication 1)
            "dead_bands": lost,
            "live_bands": self.n_bands - lost,
            "docs_indexed": len(self._sigs),
            "in_flight": in_flight,
            "in_flight_peak": peak,
            "repair_queue_pairs": int(queued),
            "slow_workers": int(self._slow.sum()),
            "recall_at_threshold_full": rb["full"],
            "recall_at_threshold_live": rb["live"],
            # the headline degradation number: how much detection
            # probability the lost bands are costing right now (zero
            # through any < replication worker deaths)
            "recall_loss": rb["full"] - rb["live"],
        })
        for j in range(self.r):
            out[f"hedge_wins_replica_{j}"] = int(wins[j])
        return out

    # -- durability ---------------------------------------------------------

    def export_state(self) -> Dict:
        """Params + signature store + every replica's band shard + dead
        mask + write-behind repair queue + counters, as one durable-state
        pytree. Shards are keyed ``band_<b>_r<j>`` (band + replica slot,
        not worker), so restore re-replicates onto any topology — and a
        crc-corrupt replica leaf can be read-repaired from an intact
        sibling copy at restore time."""
        shards = {}
        for b in range(self.n_bands):
            for j, w in enumerate(self.replica_workers(b)):
                shards[f"band_{b:04d}_r{j}"] = pack_band(w.shards[b])
        with self._lock:
            repair = {f"band_{b:04d}_r{j}": pack_band(q)
                      for (b, j), q in sorted(self._repair_q.items())}
        sigs = (np.stack([np.asarray(s, np.uint32) for s in self._sigs])
                if self._sigs
                else np.zeros((0, self.dd.cfg.n_signatures), np.uint32))
        tree = {"params": self.dd.export_state()["params"],
                "sigs": sigs,
                "shards": shards,
                "dead": self.dead.astype(np.uint8),
                "hedge_wins_by_replica":
                    self.hedge_wins_by_replica.astype(np.int64),
                "topology": {"n_workers": np.int64(self.svc.n_workers),
                             "replication": np.int64(self.r)},
                "counters": {k: np.int64(v) for k, v in self.t.items()}}
        if repair:
            tree["repair_q"] = repair
        return tree

    @staticmethod
    def _merge_copies(copies: List[Dict[bytes, List[int]]]
                      ) -> Dict[bytes, List[int]]:
        """Union-merge replica copies (first copy's key order wins; doc
        ids sorted-union — ascending assignment makes that the exact list
        a never-failed replica holds)."""
        out: Dict[bytes, List[int]] = {}
        for c in copies:
            for k, ids in c.items():
                got = out.setdefault(k, [])
                got[:] = sorted(set(got) | set(ids))
        return out

    def import_state(self, tree: Dict) -> None:
        """Adopt a snapshot: hash params re-bound FIRST (future signatures
        must come from the checkpointed draw), then signatures, then the
        band replicas redistributed by the placement rule for the
        *current* topology. Same topology restores replica-for-replica
        (read-repairing any corrupt/missing replica leaf from an intact
        sibling) plus the dead mask and repair queue; a different worker
        count or replication merges every surviving copy — queued
        write-behind included — and re-replicates the result, so an
        elastic restore loses nothing a snapshot-time replica held."""
        if not isinstance(tree, dict) or "params" not in tree \
                or "sigs" not in tree or "dead" not in tree:
            raise DataCorruption(
                "snapshot core state (params/sigs/dead) missing or corrupt")
        self.dd.import_params(tree["params"])
        sigs = np.asarray(tree["sigs"], np.uint32)
        self._sigs = [sigs[i] for i in range(sigs.shape[0])]
        dead_snap = np.asarray(tree["dead"], np.uint8).astype(bool)
        if dead_snap.ndim == 1:          # pre-replication snapshot layout
            dead_snap = dead_snap[:, None]
        nb_snap, r_snap = dead_snap.shape
        if nb_snap != self.n_bands:
            raise ValueError(f"snapshot has {nb_snap} bands, "
                             f"config expects {self.n_bands}")
        topo = tree.get("topology", {})
        same_topo = (int(topo.get("n_workers", -1)) == self.svc.n_workers
                     and int(topo.get("replication", -1)) == self.r)

        def intact(leaf) -> bool:
            return (isinstance(leaf, dict)
                    and all(k in leaf for k in _PACK_KEYS))

        by_band: Dict[int, Dict[int, Dict]] = {}
        for key, leaf in tree.get("shards", {}).items():
            m = _BAND_KEY_RE.match(key)
            if m is None:
                raise ValueError(f"snapshot shard key {key!r} unrecognized")
            b, j = int(m.group(1)), int(m.group(2) or 0)
            if intact(leaf):
                by_band.setdefault(b, {})[j] = leaf
        repair_snap: Dict[Tuple[int, int], Dict[bytes, List[int]]] = {}
        for key, leaf in tree.get("repair_q", {}).items():
            m = _BAND_KEY_RE.match(key)
            if m is not None and intact(leaf):
                repair_snap[(int(m.group(1)), int(m.group(2) or 0))] = \
                    unpack_band(leaf)

        self._build_workers()
        repaired, repaired_bytes = 0, 0
        for b in range(self.n_bands):
            copies = {j: unpack_band(leaf)
                      for j, leaf in sorted(by_band.get(b, {}).items())}
            if not copies:
                raise DataCorruption(
                    f"band {b}: no intact replica copy in snapshot")
            if same_topo:
                for j, w in enumerate(self.replica_workers(b)):
                    if j in copies:
                        w.shards[b] = copies[j]
                    else:
                        # read-repair the corrupt replica leaf from an
                        # intact snapshot sibling instead of failing
                        src = copies[min(copies)]
                        w.shards[b] = {k: list(v) for k, v in src.items()}
                        repaired += 1
                        repaired_bytes += (
                            sum(len(k) for k in src)
                            + 8 * sum(len(v) for v in src.values()))
            else:
                merged = self._merge_copies(
                    list(copies.values())
                    + [q for (bq, _), q in sorted(repair_snap.items())
                       if bq == b])
                for w in self.replica_workers(b):
                    w.shards[b] = {k: list(v) for k, v in merged.items()}

        with self._lock:
            if same_topo:
                self.dead = dead_snap.copy()
                self._repair_q = dict(repair_snap)
            else:
                self.dead = np.zeros((self.n_bands, self.r), bool)
                self._repair_q = {}
            self._strikes = np.zeros((self.n_bands, self.r), np.int64)
            wins = np.zeros(self.r, np.int64)
            if same_topo and "hedge_wins_by_replica" in tree:
                wins = np.asarray(tree["hedge_wins_by_replica"],
                                  np.int64).copy()
            self.hedge_wins_by_replica = wins
        # counters come back from the snapshot EXCEPT resumes: that one
        # counts restores performed by THIS process (a snapshot-resident
        # resume count would roll back with every restore it reports)
        counters = tree.get("counters", {})
        resumes = self.t.get("resumes", 0) + 1
        self.t = {k: int(counters[k]) if k in counters else 0
                  for k in _COUNTERS}
        self.t["resumes"] = resumes
        if repaired:
            self._bump("repairs", repaired)
            self._bump("repair_bytes", repaired_bytes)

    def snapshot(self, directory: str, epoch: int, *, keep: int = 3,
                 async_: bool = False, extra: Optional[Dict] = None,
                 injector=None):
        """Write one epoch-tagged atomic snapshot (``extra`` rides along
        under its own key — job cursors, accumulated flags)."""
        self.t["snapshots"] += 1
        tree = {"service": self.export_state()}
        if extra:
            tree["job"] = extra
        return durable.save(tree, directory, epoch, keep=keep,
                            async_=async_, injector=injector)

    def restore(self, directory: str, epoch: Optional[int] = None):
        """Restore from the newest (or given) snapshot; returns
        ``(epoch, extra)`` where ``extra`` is the job payload passed to
        :meth:`snapshot` (or {}). Corrupt leaves (crc mismatch) are
        tolerated when an intact replica sibling exists — the damaged
        replica is rebuilt from it and the job continues."""
        tree, epoch = durable.load(directory, epoch, on_corrupt="skip")
        if "service" not in tree:
            raise DataCorruption(
                f"snapshot under {directory} has no intact service state")
        self.import_state(tree["service"])
        return epoch, tree.get("job", {})


def run_dedup_job(service: DedupService, docs: Sequence[np.ndarray], *,
                  directory: str, batch_docs: int = 64,
                  snapshot_every: int = 1,
                  injector: Optional[FailureInjector] = None,
                  chaos: Optional[_fault.ChaosSchedule] = None,
                  max_restarts: int = 10, keep: int = 3) -> Dict:
    """Corpus dedup that survives preemption: process ``docs`` in batches,
    snapshot the full service state every ``snapshot_every`` batches, and
    on an injected kill restore the latest atomic snapshot and replay —
    ``train/fault.run_with_recovery`` driving the data plane. The final
    flags (and the service's sketch state) are bit-identical to an
    uninterrupted run: replayed batches recompute deterministically from
    the restored boundary state.

    ``chaos`` overlays a seeded :class:`~repro_torch.train.fault.ChaosSchedule`:
    its worker-level events (kill/revive/slow/flaky) fire before each
    batch and its job-level faults (loop kills, snapshot interrupts) ride
    the injector seam — pass either, not both.

    Returns ``{"flags", "restarts", "batches"}``.
    """
    if chaos is not None:
        if injector is not None:
            raise ValueError("pass chaos= or injector=, not both")
        injector = chaos.as_injector()
    D = len(docs)
    n_steps = max(1, -(-D // batch_docs))
    flags = np.zeros(D, bool)

    def one(step):
        if chaos is not None:
            chaos.apply(service, step)
        lo = step * batch_docs
        sel = docs[lo:lo + batch_docs]
        flags[lo:lo + len(sel)] = service.add_batch(sel)
        return {"dups": int(flags[lo:lo + len(sel)].sum())}

    def save_ckpt(step):
        service.snapshot(directory, step, keep=keep,
                         extra={"flags": flags.astype(np.uint8)},
                         injector=injector)

    def restore_ckpt():
        epoch = durable.latest_epoch(directory)
        if epoch is None:
            return 0
        epoch, job = service.restore(directory)
        if "flags" in job:
            flags[:] = np.asarray(job["flags"], np.uint8).astype(bool)
        return epoch

    # epoch-0 snapshot: a kill before the first periodic checkpoint must
    # restore the *initial* state (same params!), not re-seed
    if durable.latest_epoch(directory) is None:
        service.snapshot(directory, 0, keep=keep,
                         extra={"flags": flags.astype(np.uint8)})
    res = _fault.run_with_recovery(
        one, save_ckpt, restore_ckpt, n_steps=n_steps,
        ckpt_every=max(1, snapshot_every), injector=injector,
        max_restarts=max_restarts)
    if chaos is not None:
        chaos.finish(service)
    durable.flush()
    return {"flags": flags, "restarts": res["restarts"], "batches": n_steps}
