"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name. The cell ``bench/workloads/<cell>.json``
names a configuration ``bench/configs/<config>.json`` and a traffic mix
``bench/traffic/<mix>.json``; the configuration names its job,
``bench/jobs/<job>.py``, which sets the program up, drives the measured
window and judges what the window produced against the plain reference
under ``bench/reference/``. ``BENCHMARK.json`` at the root of the checkout
lists the metrics: each is read by ``bench/metrics/<metric>.py`` from the
run's measurements, the end-to-end ones in a run with ``--trace 0`` and
the per-layer ones, from the profiler's trace and the benchmark's spans
and counters, in a run with ``--trace 1``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit,
which are also the last lines of standard error. The run exits with 2
without a card (or with fewer cards than the cell asks for), and with 3 if
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, the interpreter put bench/ first on the path, where its
# module names could shadow others: the checkout's root goes there instead
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    sys.path[0] = str(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(path: Path, name: str):
    """Import the file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, name: str, overrides: Optional[dict] = None) -> dict:
    """The cell ``name`` with its configuration and traffic, each read from
    its own file (``overrides`` replaces top-level keys of the
    configuration's and the traffic's, for tests at a small size)."""
    cell = load_json(root / "bench" / "workloads" / f"{name}.json")
    config = load_json(root / "bench" / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return {"cell": cell, "config": config, "traffic": traffic}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its companions' or the
    JAX package's, compared as whole names."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Window:
    """The measured window: ``done(count)`` once at least one unit ran and
    ``seconds`` have passed, or ``max_units`` units ran."""

    def __init__(self, seconds: float, max_units: Optional[int]):
        self.seconds, self.max_units = seconds, max_units
        self.start = time.perf_counter()
        self.end = None

    def done(self, count: int) -> bool:
        if not count:
            return False
        if self.max_units is not None and count >= self.max_units:
            return True
        return time.perf_counter() - self.start >= self.seconds


class Ctx:
    """What a job is given: the cell, the seed, the device, the window and
    the tracer; what it gives back is recorded here too."""

    def __init__(self, root: Path, loaded: dict, seed: int, seconds: float,
                 trace: bool, device, impl: str, chips: int,
                 max_units: Optional[int], stand_in: Optional[Callable]):
        import torch
        from bench.tracing import Tracer
        self.torch = torch
        self.root, self.seed, self.seconds = root, int(seed), seconds
        self.cell, self.config = loaded["cell"], loaded["config"]
        self.traffic = loaded["traffic"]
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.impl, self.chips, self.max_units = impl, chips, max_units
        self.stand_in = stand_in
        self.tracer = Tracer(trace, self.cuda)
        self.setup_s = self.window_s = None
        self.memory_peak_bytes = 0
        if self.cuda:
            torch.cuda.init()
        self.mark("imports and the card")

    def devices(self) -> list:
        return list(range(self.chips)) if self.cuda else [0]

    def make_program(self, factory: Callable, params):
        """The program, or the stand-in that a control puts in its place."""
        return self.stand_in(self, params) if self.stand_in else factory()

    def synchronize(self) -> None:
        if self.cuda:
            for d in self.devices():
                self.torch.cuda.synchronize(d)

    def launches(self) -> int:
        """Plan-kernel launches the program has counted so far."""
        from repro_torch.kernels import sketch_fused
        return sketch_fused.launch_counts()["plan"]

    @contextlib.contextmanager
    def window(self):
        """Set-up ends here; the window runs until the job's loop ends and
        the device has finished."""
        self.synchronize()
        self.setup_s = time.perf_counter() - T_START
        self.note(f"set-up {self.setup_s:.3f} s")
        self.tracer.start()
        span = self.tracer.span("window")
        span.__enter__()
        w = Window(self.seconds, self.max_units)
        try:
            yield w
            self.synchronize()
        finally:
            w.end = time.perf_counter()
            span.__exit__(None, None, None)
            self.tracer.stop()
            self.window_s = w.end - w.start
            self.note(f"window {self.window_s:.3f} s")

    def read_memory_peak(self) -> None:
        if self.cuda:
            self.memory_peak_bytes = max(
                self.torch.cuda.max_memory_allocated(d) for d in self.devices())

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def mark(self, what: str) -> None:
        """Note how far into the process a step of set-up ended."""
        self.note(f"{what} ready at {time.perf_counter() - T_START:.3f} s")

    def note(self, text: str) -> None:
        print(f"note: {text}", file=sys.stderr, flush=True)


def metric_names(root: Path, cell: str, per_layer: bool) -> list:
    """The metrics ``BENCHMARK.json`` gives the cell, end-to-end or
    per-layer: each that names no ``workloads`` or names this cell."""
    bench = load_json(root / "BENCHMARK.json")
    key = "per_layer" if per_layer else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def read_metrics(root: Path, cell: str, per_layer: bool,
                 measured: dict) -> Dict[str, dict]:
    """Each metric from its reader ``bench/metrics/<name>.py``; a reader
    that finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in metric_names(root, cell, per_layer):
        reader = module(root / "bench" / "metrics" / f"{m['name']}.py",
                        f"bench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(measured)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             *, device="cuda", impl: str = "auto",
             overrides: Optional[dict] = None, max_units: Optional[int] = None,
             control: Optional[str] = None) -> dict:
    """One run of the cell: set-up, the window, the judgement and the
    metrics, as the result line's object (``checks`` last). ``control``
    names a stand-in of the job's ``CONTROLS`` that runs in the program's
    place."""
    for path in (str(root / "src"), str(root)):
        if path not in sys.path:
            sys.path.insert(0, path)
    loaded = load_cell(root, name, overrides)
    chips = int(loaded["cell"]["chips"])
    job = module(root / "bench" / "jobs" / f"{loaded['config']['job']}.py",
                 f"bench_job_{loaded['config']['job']}")
    stand_in = job.CONTROLS[control] if control else None
    ctx = Ctx(root, loaded, seed, seconds, trace, device, impl, chips,
              max_units, stand_in)
    res = job.run(ctx)
    t = time.perf_counter()
    traced = ctx.tracer.reduce(ctx.devices()) if trace else None
    if trace:
        ctx.note(f"trace read in {time.perf_counter() - t:.3f} s")
    measured = {**res, "setup_s": ctx.setup_s, "window_s": ctx.window_s,
                "chips": chips, "trace": traced}
    metrics = read_metrics(root, name, trace, measured)
    checks = res["checks"]
    correct = (res["failed"] == 0
               and all(v <= lim for v, lim in checks.values()))
    dev = {"platform": "gpu" if ctx.cuda else "cpu",
           "kind": (ctx.torch.cuda.get_device_name(0) if ctx.cuda
                    else "cpu"),
           "count": chips if ctx.cuda else 1,
           "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    if trace and traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        out["breakdown"] = {"device_ops": traced["device_ops"],
                            "idle_gaps": traced["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")
    cell_file = ROOT / "bench" / "workloads" / f"{args.workload}.json"
    if not cell_file.is_file():
        print(f"no cell {args.workload!r} ({cell_file})", file=sys.stderr)
        return 2
    # every build and kernel cache inside the checkout, at fixed paths
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ["USE_FLAX"] = "0"
    import torch
    chips = int(load_json(cell_file)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"note: run {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
