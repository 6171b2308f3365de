"""Spans of the port's host work, on torch.profiler's own timeline.

``with trace.span("dedup.sign"):`` marks a stretch of host work as the
event ``repro_torch.dedup.sign`` while a torch profiler records, so the
span shares the clock of the profiler's device trace and a reader of the
trace can put each idle gap of the card down to the host work around it.
A span's parent is the span that encloses it on the same thread. Spans sit
at layer boundaries (a call, a block), never inside a per-row loop.

While no profiler records, :func:`span` returns one shared null context and
calls nothing of the profiler: the check costs a fraction of a microsecond,
so the spans need no switch of their own.

A span is recorded as an operator event (``_RecordFunctionFast``), not as a
user annotation (``torch.profiler.record_function``): the profiler repeats
an annotation on the device's timeline around the work launched inside it,
where a reader of device operations would take it for device work.

A :class:`Counter` is a count of host events (dispatches, staged bytes,
captures, candidates, merges) local to its ``contextvars`` context:
concurrent streams in copied contexts each see only their own.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``repro_torch.<name>`` while a profiler
    records, else the shared null context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


class Counter:
    """A monotonic count local to the current ``contextvars`` context, as
    the JAX package keeps its dispatch count. :meth:`add` counts,
    optionally under a key; :meth:`get` reads the total and
    :meth:`by_key` the count under each key."""

    def __init__(self, name: str):
        self._var = contextvars.ContextVar(name, default=())

    def add(self, n: int = 1, key: str = "") -> None:
        counts = self.by_key()
        counts[key] = counts.get(key, 0) + n
        self._var.set(tuple(counts.items()))

    def get(self) -> int:
        return sum(n for _, n in self._var.get())

    def by_key(self) -> Dict[str, int]:
        return dict(self._var.get())
