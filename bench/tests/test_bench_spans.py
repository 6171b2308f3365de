"""The span arithmetic of ``bench/spans.py`` on made-up intervals (self
seconds; idle seconds by the innermost span, found by containment; the
labels of the benchmark's own spans), and ``bench/trace_program.py``'s
traced runs of both cells at a small size on the CPU: every metric of the
program's spans and counters is read, the staged bytes equal a hand
count, and a program without spans or counters still runs."""
from __future__ import annotations

import contextlib

import numpy as np
import pytest

from bench_sizes import ROOT, SEED, SMALL, UNITS

from bench import spans, trace_program

MS = 1_000_000          # a millisecond in nanoseconds

# a window of 100 ms: a call (10-90) around a signing (20-80) that tiles
# (20-30, 50-55) and stages (30-32) before the executor (32-48)
TREE = [(0, 100 * MS, "window"), (10 * MS, 90 * MS, "add_batch"),
        (20 * MS, 80 * MS, "dedup.sign"), (20 * MS, 30 * MS, "dedup.tile"),
        (30 * MS, 32 * MS, "stream.stage"),
        (32 * MS, 48 * MS, "stream.update_many"),
        (50 * MS, 55 * MS, "dedup.tile")]


def test_self_seconds_take_out_the_nested_spans():
    got = spans.self_seconds(TREE, 0, 100 * MS)
    assert got["dedup.tile"] == {"count": 2, "inclusive_s": 0.015,
                                 "self_s": 0.015}
    assert got["dedup.sign"]["inclusive_s"] == pytest.approx(0.060)
    assert got["dedup.sign"]["self_s"] == pytest.approx(0.060 - 0.033)
    assert got["add_batch"]["self_s"] == pytest.approx(0.020)
    assert got["window"]["self_s"] == pytest.approx(0.020)
    # the stretches cover the window once
    assert sum(v["self_s"] for v in got.values()) == pytest.approx(0.100)


def test_idle_seconds_by_the_innermost_span():
    # the card busy 25-35 ms and 40-60 ms: idle 20-25 in the tiling, 35-40
    # in the executor, the rest where the host was
    busy = np.asarray([[25 * MS, 35 * MS], [40 * MS, 60 * MS]])
    got = dict(spans.idle_by_span(TREE, busy, 0, 100 * MS))
    assert got["dedup.tile"] == pytest.approx(0.005)
    assert got["stream.stage"] == 0.0
    assert got["stream.update_many"] == pytest.approx(0.016 - 0.003 - 0.008)
    assert got["dedup.sign"] == pytest.approx(0.020)
    assert got["add_batch"] == pytest.approx(0.020)
    assert got["window"] == pytest.approx(0.020)
    assert sum(got.values()) == pytest.approx(0.100 - 0.030)


def test_a_gap_across_spans_is_split_at_their_edges():
    # one idle gap over the whole window: each part goes to the span the
    # host was in, not the whole gap to the span around its middle
    got = dict(spans.idle_by_span(TREE, np.zeros((0, 2)), 0, 100 * MS))
    assert got["dedup.tile"] == pytest.approx(0.015)
    assert got["stream.update_many"] == pytest.approx(0.016)


def test_the_benchmarks_own_spans_keep_their_labels():
    # the parent program's trace: the benchmark's spans alone
    own = [(0, 100 * MS, "window"), (10 * MS, 40 * MS, "add_batch"),
           (12 * MS, 38 * MS, "sign"), (40 * MS, 90 * MS, "add_batch"),
           (41 * MS, 80 * MS, "sign")]
    got = dict(spans.idle_by_span(own, np.asarray([[50 * MS, 60 * MS]]),
                                  0, 100 * MS))
    assert set(got) == {"window", "add_batch", "sign"}
    assert got["sign"] == pytest.approx(0.026 + 0.039 - 0.010)
    assert spans.label("bench.sign") == "sign"
    assert spans.label("repro_torch.dedup.tile") == "dedup.tile"


def test_busy_before_against_a_count_by_instant():
    rng = np.random.default_rng(5)
    edges = np.sort(rng.choice(1000, size=20, replace=False)).reshape(-1, 2)
    t = np.arange(-5, 1005)
    mask = np.zeros(1010, bool)
    for a, b in edges:
        mask[a + 5 : b + 5] = True
    want = np.r_[0, np.cumsum(mask)[:-1]]
    np.testing.assert_array_equal(spans.busy_before(edges, t), want)


def test_spans_that_overlap_are_made_to_nest():
    # a span that outlasts the one it starts in is cut at that one's end
    edges, labels = spans.segments([(0, 10, "a"), (5, 20, "b")], 0, 30)
    assert edges.tolist() == [[0, 5], [5, 10], [10, 30]]
    assert labels == ["a", "b", "window"]


def _small(cell, **kw):
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return trace_program.trace_cell(
            ROOT, cell, SEED, 600.0, device="cpu", impl="ref",
            overrides=SMALL[cell], max_units=UNITS, **kw)
    finally:
        torch.set_num_threads(threads)


# the program's metrics each cell reads, and the device metrics it reads
# nowhere on the CPU
READ = {"dedup.long": set(trace_program.PROGRAM_METRICS),
        "scan.web": {"stage_ms_per_mtok", "executor_us_per_block",
                     "h2d_bytes_per_tok"}}
DEVICE = ("idle_share", "window_roofline", "plan_roofline.scan",
          "plan_roofline.minhash", "plan_launches_per_mtok")


@pytest.mark.parametrize("cell", sorted(READ))
def test_traced_run_reads_the_programs_spans_and_counters(cell):
    out = _small(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-2:] == ["program", "checks"]
    prog = out["program"]
    assert set(prog["metrics"]) == READ[cell]
    assert not any(k in out["metrics"] or k in prog["metrics"]
                   for k in DEVICE)
    assert prog["counters"]["graph_captures"] == 0
    labels = {k for k, _ in prog["idle_gaps"]}
    # no card: the whole window is idle, each stretch under its span
    assert sum(v for _, v in prog["idle_gaps"]) == pytest.approx(
        out["device"].get("window_s") or prog["spans"]["window"][
            "inclusive_s"], rel=1e-6)
    if cell == "scan.web":
        # int32 tokens once for each of the two lookups, and no lengths
        assert prog["metrics"]["h2d_bytes_per_tok"] == 8.0
        assert {"decontam.update", "stream.update_many"} <= labels
    else:
        # a chunk of 64 rows of 512 int32 tokens and its 64 lengths
        staged = prog["counters"]["staged_bytes"]
        assert staged % (4 * 64 * 512 + 4 * 64) == 0
        assert prog["metrics"]["h2d_bytes_per_tok"] >= 4.0
        s = prog["spans"]
        leaves = ("dedup.tile", "stream.stage", "stream.update_many",
                  "dedup.drain")
        assert (sum(s[k]["self_s"] for k in leaves)
                + s["dedup.sign"]["self_s"]) == pytest.approx(
            s["dedup.sign"]["inclusive_s"])
        assert s["dedup.add_batch"]["count"] == UNITS
        assert {"dedup.sign", "stream.update_many"} <= labels


@pytest.mark.parametrize("cell", sorted(READ))
def test_a_program_without_spans_or_counters(cell, monkeypatch):
    """The parent program: the benchmark's spans alone, no counters, no
    metric of the program's."""
    from repro_torch import trace
    from repro_torch.data import dedup
    from repro_torch.kernels import stream
    monkeypatch.setattr(trace, "span",
                        lambda name: contextlib.nullcontext())
    for mod, fn in ((stream, "staged_bytes"), (stream, "graph_captures"),
                    (dedup, "candidate_count")):
        monkeypatch.delattr(mod, fn)
    out = _small(cell)
    assert out["correct"]
    assert out["program"]["counters"] == {}
    assert out["program"]["metrics"] == {}
    assert {k for k, _ in out["program"]["idle_gaps"]} <= {
        "window", "add_batch", "sign", "block", "finalize"}
