"""A traced run of a cell that reads the program's own spans and counters.

    python3 bench/trace_program.py --workload <cell> --seed <n> --seconds <s>

It runs the cell as ``bench/run.py --trace 1`` does, and besides reads what
the program records about itself in the window: its spans
(``repro_torch.*``, beside the benchmark's ``bench.*``; ``bench/spans.py``)
and its counters, read when the window opens and when it closes
(``stream.staged_bytes``, ``stream.graph_captures``,
``dedup.candidate_count``). The last line of standard output is the result
line's object with one more key, ``program``: ``spans`` (each label's
count, inclusive and self seconds), ``idle_gaps`` (the card's idle seconds
by the innermost span, program spans included), ``counters`` (the
window's deltas) and ``metrics``, each of ``PROGRAM_METRICS`` read by its
reader ``bench/metrics/<name>.py``. A parent program without the spans or
the counters gives the benchmark's spans and no counters.

The benchmark's own runs read none of this: ``bench/tracing.py`` and the
jobs would have to take the spans and the counters in (PERF.md, section 7).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    sys.path[0] = str(ROOT)

# the per-layer metrics read from the program's spans and counters
PROGRAM_METRICS = ("tile_ms_per_mtok", "stage_ms_per_mtok",
                   "executor_us_per_block", "lsh_probe_us_per_doc",
                   "lsh_verify_us_per_doc", "lsh_candidates_per_doc",
                   "h2d_bytes_per_tok")

# the program's counters: (module, function) by the name of the delta
COUNTERS = {"staged_bytes": ("repro_torch.kernels.stream", "staged_bytes"),
            "graph_captures": ("repro_torch.kernels.stream",
                               "graph_captures"),
            "candidates": ("repro_torch.data.dedup", "candidate_count")}


def read_counters() -> dict:
    """Each counter the program has, by name."""
    import importlib
    out = {}
    for key, (mod, fn) in COUNTERS.items():
        f = getattr(importlib.import_module(mod), fn, None)
        if f is not None:
            out[key] = int(f())
    return out


def program_tracer(base):
    """``bench/tracing.py``'s tracer that also reads the program's counters
    at the window's ends and its spans from the trace."""

    class ProgramTracer(base):
        def start(self) -> None:
            super().start()
            self.counters = read_counters()

        def stop(self) -> None:
            end = read_counters()
            self.counters = {k: v - self.counters[k] for k, v in end.items()
                             if k in self.counters}
            super().stop()

        def reduce(self, devices):
            from bench import spans
            out = super().reduce(devices)
            if out is None:
                return None
            return {**out, "counters": self.counters,
                    "program": spans.reduce(
                        self.prof.profiler.kineto_results.events(),
                        devices[0])}

    return ProgramTracer


@contextlib.contextmanager
def reading_the_program(found: dict):
    """While open, a run's tracer reads the program's spans and counters,
    and ``found`` receives the run's measurements."""
    from bench import run, tracing
    base, read_metrics = tracing.Tracer, run.read_metrics

    def keep(root, cell, per_layer, measured):
        found.update(measured)
        return read_metrics(root, cell, per_layer, measured)

    tracing.Tracer, run.read_metrics = program_tracer(base), keep
    try:
        yield
    finally:
        tracing.Tracer, run.read_metrics = base, read_metrics


def program_metrics(root: Path, measured: dict) -> dict:
    """Each of ``PROGRAM_METRICS`` that its reader finds: the reader sees
    the counters' deltas as keys of the measurements and the spans as the
    trace's ``spans``."""
    from bench import run
    t = measured.get("trace") or {}
    m = {**measured, **t.get("counters", {}),
         "trace": {**t, "spans": t.get("program", {}).get("spans", {})}}
    out = {}
    for name in PROGRAM_METRICS:
        reader = run.module(root / "bench" / "metrics" / f"{name}.py",
                            f"bench_metric_{name}")
        value = reader.read(m)
        if value is not None:
            out[name] = float(value)
    return out


def trace_cell(root: Path, name: str, seed: int, seconds: float,
               **kwargs) -> dict:
    """One traced run of the cell (``run.run_cell``'s keywords), its
    result line's object with ``program`` added."""
    from bench import run
    found: dict = {}
    with reading_the_program(found):
        out = run.run_cell(root, name, seed, seconds, True, **kwargs)
    t = found.get("trace") or {}
    checks = out.pop("checks")
    out["program"] = {**t.get("program", {}),
                      "counters": t.get("counters", {}),
                      "metrics": program_metrics(root, found)}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    # the builds and kernel caches where bench/run.py keeps them
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    out = trace_cell(ROOT, args.workload, args.seed, args.seconds)
    counters = out["program"]["counters"]
    print(f"note: graph captures in the window "
          f"{counters.get('graph_captures', 'not counted')}",
          file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
