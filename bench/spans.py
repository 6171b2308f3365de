"""Spans in a traced window, by containment: each span's count, inclusive
and self seconds, and the device's idle seconds by the innermost span the
host was in.

A span is a host event of the profiler whose name starts with
``bench.`` (the benchmark's own, around its calls into the program) or
``repro_torch.`` (the program's, ``repro_torch.trace``; the parent program
has none). Its label is its name without the prefix: ``sign``, ``block``,
``dedup.tile``. Spans of one thread nest, so at each instant of the window
one span is the innermost: :func:`segments` cuts the window into stretches,
each labelled by that span (``window`` where no other is). A span's self
seconds are its stretches; the idle seconds under a label are its
stretches less the device's busy time in them. Where only the benchmark's
spans are in the trace, the labels are ``bench/tracing.py``'s.

The interval arithmetic is pure (integer nanoseconds in, seconds out);
:func:`reduce` reads it from a profiler's events.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from bench.tracing import PREFIX as BENCH, _dur_ns, _start_ns, _union

PROGRAM = "repro_torch."
PREFIXES = (BENCH, PROGRAM)

Span = Tuple[int, int, str]


def label(name: str) -> str:
    """A span's event name without its prefix."""
    for p in PREFIXES:
        if name.startswith(p):
            return name[len(p):]
    return name


def segments(spans: Sequence[Span], w0: int, w1: int
             ) -> Tuple[np.ndarray, List[str]]:
    """The window [w0, w1) as disjoint (m, 2) stretches in time order, each
    with the label of the innermost span around it. Spans are clipped to
    the window, and a span that outlasts the one it starts in is cut at
    that one's end, so that they nest."""
    edges: List[Tuple[int, int]] = []
    labels: List[str] = []
    cur = w0

    def emit(end: int, lab: str) -> None:
        nonlocal cur
        if end > cur:
            edges.append((cur, end))
            labels.append(lab)
            cur = end

    stack = [(w1, "window")]
    for t0, t1, lab in sorted(((max(a, w0), min(b, w1), lab)
                               for a, b, lab in spans),
                              key=lambda s: (s[0], -s[1])):
        if t1 <= t0:
            continue
        while len(stack) > 1 and stack[-1][0] <= t0:
            emit(*stack.pop())
        emit(t0, stack[-1][1])
        stack.append((min(t1, stack[-1][0]), lab))
    while stack:
        emit(*stack.pop())
    return np.asarray(edges, np.int64).reshape(-1, 2), labels


def self_seconds(spans: Sequence[Span], w0: int, w1: int
                 ) -> Dict[str, Dict[str, float]]:
    """label -> count, inclusive seconds and self seconds (its duration
    less the part covered by the spans nested in it), inside the window."""
    edges, labels = segments(spans, w0, w1)
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "inclusive_s": 0.0, "self_s": 0.0})
    for t0, t1, lab in spans:
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 > t0:
            out[lab]["count"] += 1
            out[lab]["inclusive_s"] += (t1 - t0) / 1e9
    for (a, b), lab in zip(edges, labels):
        out[lab]["self_s"] += float(b - a) / 1e9
    return dict(out)


def busy_before(busy: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Busy nanoseconds before each instant ``t``, for the sorted disjoint
    (n, 2) busy intervals ``busy``."""
    t = np.asarray(t, np.int64)
    if busy.shape[0] == 0:
        return np.zeros(t.shape, np.int64)
    lengths = busy[:, 1] - busy[:, 0]
    done = np.r_[0, np.cumsum(lengths)]
    i = np.searchsorted(busy[:, 1], t, side="right")   # ended by t
    j = np.minimum(i, busy.shape[0] - 1)
    part = np.where(i < busy.shape[0],
                    np.clip(t - busy[j, 0], 0, lengths[j]), 0)
    return done[i] + part


def idle_by_span(spans: Sequence[Span], busy: np.ndarray, w0: int,
                 w1: int) -> List[List]:
    """[[label, idle seconds], ...] in falling order: the time of the
    window in which the device was idle, by the innermost span at each
    instant."""
    edges, labels = segments(spans, w0, w1)
    busy = np.clip(np.asarray(busy, np.int64).reshape(-1, 2), w0, w1)
    busy = _union(busy)
    busy = busy[busy[:, 1] > busy[:, 0]]
    used = busy_before(busy, edges[:, 1]) - busy_before(busy, edges[:, 0])
    idle: Dict[str, float] = defaultdict(float)
    for (a, b), u, lab in zip(edges, used, labels):
        idle[lab] += float(b - a - u) / 1e9
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])]


def reduce(events, device: int = 0) -> Dict:
    """From a profiler's events: ``spans`` (:func:`self_seconds`) and
    ``idle_gaps`` (:func:`idle_by_span` over the first card's operations,
    or over none on the CPU), inside the ``bench.window`` span; empty
    without that span."""
    from torch.autograd import DeviceType
    spans: List[Span] = []
    ops = []
    for e in events:
        name = e.name()
        t0 = _start_ns(e)
        t1 = t0 + _dur_ns(e)
        if name.startswith(PREFIXES):
            # a user annotation is repeated on the device's timeline: only
            # the host's copy is the span
            if e.device_type() != DeviceType.CUDA:
                spans.append((t0, t1, label(name)))
        elif (e.device_type() == DeviceType.CUDA
              and e.device_index() == device):
            ops.append((t0, t1))
    window = [(a, b) for a, b, lab in spans if lab == "window"]
    if not window:
        return {}
    w0, w1 = window[0]
    return {"spans": self_seconds(spans, w0, w1),
            "idle_gaps": idle_by_span(spans, np.asarray(ops, np.int64),
                                      w0, w1)}
