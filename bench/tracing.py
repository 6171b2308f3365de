"""The traced run's reduction: torch.profiler over the measured window, the
benchmark's own spans as profiler annotations, and from the raw events the
device's busy time, the sum of its operations' times, the operations that
took most time and the idle time by what the host was doing.

Spans are the benchmark's, around its calls into the program
(``bench.<name>``); the program is not instrumented.
"""
from __future__ import annotations

import contextlib
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

PREFIX = "bench."


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1e3)


def _dur_ns(e) -> int:
    return (e.duration_ns() if hasattr(e, "duration_ns")
            else int(e.duration_us() * 1e3))


def short_name(name: str) -> str:
    """A device operation's name without its template and argument lists
    (copies and fills keep theirs)."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name[5:] if name.startswith("void ") else name
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    short = name[: min(cut)] if cut else name
    # a kernel named by a lambda keeps the start of its template list
    return short if not short.endswith("::") else name[:80]


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted (n, 2) intervals -> their union as disjoint (m, 2) intervals."""
    if iv.shape[0] == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.r_[True, iv[1:, 0] > reach[:-1]]
    starts = iv[new, 0]
    last = np.r_[np.flatnonzero(new)[1:] - 1, iv.shape[0] - 1]
    return np.stack([starts, reach[last]], axis=1)


class Tracer:
    """Spans always; with ``enabled`` a torch.profiler trace of the window
    and the spans as its annotations."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(PREFIX + name)

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self) -> None:
        if self.prof is not None:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                self.prof.__exit__(None, None, None)

    def reduce(self, devices: List[int]) -> Optional[Dict]:
        """Busy seconds a device (union of its operations' intervals, the
        mean over ``devices``), the sum of the operations' seconds, the ten
        operations that took most time, and idle seconds by the innermost
        span the host was in (``window`` outside any other), over the
        ``bench.window`` span."""
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        ops: Dict[int, list] = defaultdict(list)
        by_name: Dict[str, float] = defaultdict(float)
        spans: Dict[str, list] = defaultdict(list)
        for e in self.prof.profiler.kineto_results.events():
            t0, d = _start_ns(e), _dur_ns(e)
            if e.name().startswith(PREFIX):
                # the profiler repeats an annotation on the device's
                # timeline, around the work it launched: a span, not an
                # operation
                if e.device_type() != DeviceType.CUDA:
                    spans[e.name()[len(PREFIX):]].append((t0, t0 + d))
            elif e.device_type() == DeviceType.CUDA:
                ops[e.device_index()].append((t0, t0 + d))
                by_name[short_name(e.name())] += d / 1e9
        if not spans.get("window"):
            return None
        w0, w1 = spans["window"][0]
        busy, total = [], 0.0
        for dev in devices:
            iv = np.asarray(ops.get(dev, []), np.int64).reshape(-1, 2)
            iv = np.clip(iv, w0, w1)
            total += float((iv[:, 1] - iv[:, 0]).sum()) / 1e9
            busy.append(_union(iv))
        # idle time of the first device, by the innermost span around it
        u = busy[0]
        edges = np.concatenate([[w0], u.reshape(-1), [w1]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        mids = (gaps[:, 0] + gaps[:, 1]) // 2
        label = np.full(mids.shape[0], "window", dtype=object)
        kinds = sorted((k for k in spans if k != "window"),
                       key=lambda k: -np.mean([b - a for a, b in spans[k]]))
        for kind in kinds:               # longest first: inner spans win
            sv = np.asarray(spans[kind], np.int64)
            sv = sv[np.argsort(sv[:, 0])]
            at = np.searchsorted(sv[:, 0], mids, side="right") - 1
            inside = (at >= 0) & (mids < sv[np.maximum(at, 0), 1])
            label[inside] = kind
        idle: Dict[str, float] = defaultdict(float)
        for lab, (a, b) in zip(label, gaps):
            idle[lab] += (b - a) / 1e9
        busy_s = float(np.mean([float((u[:, 1] - u[:, 0]).sum()) / 1e9
                                for u in busy]))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e9,
                "device_s": total, "per_device_busy_s": [
                    float((u[:, 1] - u[:, 0]).sum()) / 1e9 for u in busy],
                "device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in sorted(
                    idle.items(), key=lambda kv: -kv[1])[:10]]}
