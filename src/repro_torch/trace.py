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
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``repro_torch.<name>`` while a profiler
    records, else the shared null context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)
