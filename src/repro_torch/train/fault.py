"""Fault tolerance: failure injection, a straggler watchdog, chaos
schedules and the recovery loop — numpy only.

The port's own copy of the JAX package's ``train/fault.py`` (that module
imports no JAX, but the port imports nothing of the JAX package): the
same classes, the same seeded schedules.

* **node crash mid-step** -> checkpoint/restart: :func:`run_with_recovery`
  restores the latest atomic snapshot and replays from there; the data
  pipeline is stateless-resumable (``batch_for_step(step)``).
* **straggler steps** -> :class:`Watchdog` tracks a robust (median +
  k*MAD) step-time envelope; breaching steps are logged and counted, and
  the replicated dedup service hedges on the signal.
* **silent data corruption** -> per-leaf crc32 in every snapshot
  (``train/checkpoint.py``) raises the typed :class:`DataCorruption`.

:class:`FailureInjector` raises scripted exceptions at chosen steps, and
the typed subclasses below let a test script *which* failure class fires —
a worker crash, an RPC deadline, a process killed mid-snapshot, corrupted
bytes — and assert the matching recovery path ran. :class:`ChaosSchedule`
draws whole seeded fault storms (``np.random.default_rng(seed)``: the same
seed gives the same schedule as the JAX package's).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np


class InjectedFailure(RuntimeError):
    """Base class of every scripted fault (recovery loops catch this)."""


class WorkerCrash(InjectedFailure):
    """A shard worker died / refused the connection: the call never ran."""


class ProbeTimeout(InjectedFailure):
    """An RPC deadline elapsed: the call may or may not have run (probes
    are read-only and inserts idempotent, so retry is always safe)."""


class SnapshotInterrupt(InjectedFailure):
    """The process was killed mid-checkpoint-write: the tmp dir is stale,
    the previous atomic snapshot must win."""


class DataCorruption(InjectedFailure):
    """A payload failed validation (torn read, bit flip): not retryable
    against the same bytes — the caller must re-derive or restore."""


@dataclasses.dataclass
class FailureInjector:
    """Raise scripted exceptions once per step.

    ``fail_at_steps`` raises the generic :class:`InjectedFailure`;
    ``fail_kinds`` maps a step to the exception *class* to raise there, so
    tests can distinguish crash vs timeout vs corruption recovery. A step
    named by both uses its ``fail_kinds`` entry. The fail-once-per-step
    semantics are shared: after a step has fired it never fires again, so
    the replayed step makes progress.
    """

    fail_at_steps: Iterable[int] = ()
    fail_kinds: Mapping[int, type] = dataclasses.field(default_factory=dict)
    seen: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.seen:
            return
        kind = self.fail_kinds.get(step)
        if kind is None and step in self.fail_at_steps:
            kind = InjectedFailure
        if kind is not None:
            self.seen.add(step)   # fail once per step, then allow progress
            raise kind(f"injected {kind.__name__} at step {step}")


class Watchdog:
    """Robust straggler detector over step wall-times.

    ``start``/``stop`` bracket a step the trainer way; :meth:`observe`
    feeds a pre-measured duration directly — the data plane's per-worker
    RPC latencies arrive from pool threads that cannot bracket. ``window``
    bounds the history (a service-lifetime feed must not grow without
    bound); ``None`` keeps the trainer's full-history behaviour.
    """

    def __init__(self, factor: float = 3.0, warmup: int = 5,
                 window: Optional[int] = None):
        self.factor = factor
        self.warmup = warmup
        self.window = window
        self.times: List[float] = []
        self.stragglers: List[int] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def observe(self, dt: float, step: int) -> bool:
        """Record one duration; True iff it breached the envelope (the
        slow-replica signal a service uses to hedge *proactively*)."""
        breach = False
        if len(self.times) >= self.warmup:
            med = sorted(self.times)[len(self.times) // 2]
            mad = sorted(abs(t - med) for t in self.times)[len(self.times) // 2]
            if dt > med + self.factor * max(mad, 0.05 * med):
                self.stragglers.append(step)
                breach = True
        self.times.append(dt)
        if self.window is not None:
            if len(self.times) > self.window:
                del self.times[:len(self.times) - self.window]
            if len(self.stragglers) > self.window:
                del self.stragglers[:len(self.stragglers) - self.window]
        return breach

    def stop(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        self.observe(dt, step)
        return dt


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scripted fault-storm action at a batch ordinal.

    ``action`` is one of ``kill`` (worker process dies: every call refused
    until revived), ``revive`` (worker returns; the service read-repairs its
    replicas before they rejoin the probe rotation), ``slow`` / ``fast``
    (straggler on / off — the Watchdog-fed proactive-hedge signal), or
    ``flaky`` (the worker's next call raises ``kind`` once — a transient
    transport fault the retry/failover plane must absorb).
    """

    batch: int
    action: str
    worker: int
    kind: Optional[type] = None
    delay_s: float = 0.0


class ChaosSchedule:
    """Seeded randomized fault storm over batch ordinals.

    Replaces hand-picked single-failure scripts with a *certifiable fault
    envelope*: a deterministic RNG (``np.random.default_rng(seed)``) draws
    kill/revive/slow/flaky sequences over ``n_batches`` batches, and the
    kill draws are guarded so at most ``max_concurrent_dead`` workers are
    down at once — defaulting to ``replication - 1``, the envelope inside
    which an r-way replicated shard plane guarantees **bit-identical
    verdicts with zero recall loss** (replicas of a band live on distinct
    workers, so killing < r workers always leaves a live replica). Tests
    sweep seeds × replication × worker counts and assert parity against a
    fault-free oracle under every schedule.

    ``as_injector`` exports the schedule's job-level faults (loop kills,
    :class:`SnapshotInterrupt` inside ``durable.save``) as a
    :class:`FailureInjector` for ``run_with_recovery``-driven jobs.
    """

    def __init__(self, seed: int, n_batches: int, n_workers: int, *,
                 replication: int = 2,
                 kill_rate: float = 0.25, revive_rate: float = 0.5,
                 slow_rate: float = 0.15, flaky_rate: float = 0.35,
                 snapshot_interrupt_rate: float = 0.0,
                 job_kill_rate: float = 0.0,
                 slow_delay_s: float = 0.02,
                 max_concurrent_dead: Optional[int] = None,
                 flaky_kinds: Tuple[type, ...] = None):
        if flaky_kinds is None:
            flaky_kinds = (WorkerCrash, ProbeTimeout)
        if max_concurrent_dead is None:
            max_concurrent_dead = max(0, min(replication, n_workers) - 1)
        self.seed = seed
        self.n_batches = n_batches
        self.n_workers = n_workers
        self.max_concurrent_dead = max_concurrent_dead
        rng = np.random.default_rng(seed)
        events: List[ChaosEvent] = []
        self.injector_kinds: Dict[int, type] = {}
        dead: set = set()
        slow: set = set()
        for t in range(n_batches):
            if dead and rng.random() < revive_rate:
                w = int(rng.choice(sorted(dead)))
                dead.discard(w)
                events.append(ChaosEvent(t, "revive", w))
            if len(dead) < max_concurrent_dead and rng.random() < kill_rate:
                w = int(rng.choice([x for x in range(n_workers)
                                    if x not in dead]))
                dead.add(w)
                events.append(ChaosEvent(t, "kill", w))
            if rng.random() < slow_rate:
                w = int(rng.integers(n_workers))
                if w in slow:
                    slow.discard(w)
                    events.append(ChaosEvent(t, "fast", w))
                else:
                    slow.add(w)
                    events.append(ChaosEvent(t, "slow", w,
                                             delay_s=slow_delay_s))
            if rng.random() < flaky_rate:
                w = int(rng.integers(n_workers))
                kind = flaky_kinds[int(rng.integers(len(flaky_kinds)))]
                events.append(ChaosEvent(t, "flaky", w, kind=kind))
            # job-level faults ride the injector, not the worker seam
            if job_kill_rate and rng.random() < job_kill_rate:
                self.injector_kinds.setdefault(t, InjectedFailure)
            if (snapshot_interrupt_rate
                    and rng.random() < snapshot_interrupt_rate):
                self.injector_kinds[t] = SnapshotInterrupt
        self.events = events
        self._still_dead = sorted(dead)
        self._still_slow = sorted(slow)

    def events_at(self, batch: int) -> List[ChaosEvent]:
        return [e for e in self.events if e.batch == batch]

    def counts(self) -> Dict[str, int]:
        """Event census (benchmarks record it next to chaos wall-time)."""
        out = {a: 0 for a in ("kill", "revive", "slow", "fast", "flaky")}
        for e in self.events:
            out[e.action] += 1
        out["snapshot_interrupts"] = sum(
            1 for k in self.injector_kinds.values()
            if k is SnapshotInterrupt)
        out["job_kills"] = sum(1 for k in self.injector_kinds.values()
                               if k is not SnapshotInterrupt)
        out["total"] = len(self.events) + len(self.injector_kinds)
        return out

    def as_injector(self) -> FailureInjector:
        return FailureInjector(fail_kinds=dict(self.injector_kinds))

    def apply(self, service, batch: int) -> List[ChaosEvent]:
        """Fire this batch's events at a ``DedupService``-shaped target
        (``kill_worker`` / ``revive_worker`` / ``workers[w]`` seam);
        returns the events applied."""
        applied = self.events_at(batch)
        for ev in applied:
            w = service.workers[ev.worker]
            if ev.action == "kill":
                service.kill_worker(ev.worker)
            elif ev.action == "revive":
                service.revive_worker(ev.worker)
            elif ev.action == "slow":
                w.delay_s = ev.delay_s
            elif ev.action == "fast":
                w.delay_s = 0.0
            elif ev.action == "flaky":
                w.fail_next.append(ev.kind)
        return applied

    def finish(self, service) -> None:
        """End-of-storm cleanup: revive every still-dead worker (triggering
        read-repair) and clear straggler/flaky residue, so post-storm state
        can be certified against the fault-free oracle."""
        for w in service.workers:
            w.delay_s = 0.0
            w.fail_next.clear()
        for wid in self._still_dead:
            service.revive_worker(wid)


def run_with_recovery(train_one_step: Callable[[int], Dict],
                      save_ckpt: Callable[[int], None],
                      restore_ckpt: Callable[[], int],
                      *, n_steps: int, ckpt_every: int,
                      injector: Optional[FailureInjector] = None,
                      max_restarts: int = 10) -> Dict:
    """Generic recovery loop: on failure, restore and replay.

    `train_one_step(step)` must be side-effect-free w.r.t. host state except
    through the returned metrics (device state lives in the closure and is
    re-initialized by `restore_ckpt`).
    """
    restarts = 0
    step = restore_ckpt()
    history = []
    while step < n_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            metrics = train_one_step(step)
            history.append((step, metrics))
            step += 1
            if step % ckpt_every == 0:
                save_ckpt(step)
        except InjectedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            step = restore_ckpt()
    return {"history": history, "restarts": restarts, "final_step": step}
