"""The benchmark's files: ``BENCHMARK.json`` against the contract's limits,
every cell, configuration, traffic mix, job and metric found by its file
name, and no module of JAX or of the JAX package imported anywhere under
``bench/``."""
from __future__ import annotations

import ast
import json
import re

import pytest

from bench_sizes import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted((ROOT / "bench").rglob("*.py"))


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def _entries():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[key]:
            yield key, e


@pytest.mark.parametrize("key,entry", list(_entries()),
                         ids=lambda v: v if isinstance(v, str) else v["name"])
def test_names_units_and_keys(key, entry):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}[key]
    assert set(entry) <= allowed
    assert NAME.match(entry["name"])
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in ("why", "layer", "source"):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]
            assert "\t" not in entry[k]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if key == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if key == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    if key == "configs":
        assert all(NAME.match(r) for r in entry["reduced"])


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for k in ("end_to_end", "per_layer")
               for m in BENCH[k]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    own = json.loads((ROOT / "bench" / "workloads" / f"{cell}.json")
                     .read_text())
    assert own == entry
    config = json.loads((ROOT / "bench" / "configs"
                         / f"{entry['config']}.json").read_text())
    assert (ROOT / "bench" / "traffic" / f"{entry['traffic']}.json").is_file()
    assert (ROOT / "bench" / "jobs" / f"{config['job']}.py").is_file()
    assert entry["chips"] in (1, 4)
    # every cell reports setup_s, another end-to-end metric and a per-layer
    for key, least in (("end_to_end", 2), ("per_layer", 1)):
        got = [m for m in BENCH[key]
               if "workloads" not in m or cell in m["workloads"]]
        assert len(got) >= least


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(config):
    path = ROOT / config["file"]
    assert path == ROOT / "bench" / "configs" / f"{config['name']}.json"
    own = json.loads(path.read_text())
    assert own["name"] == config["name"]
    assert own["source"] == config["source"]
    assert own["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end",
                                                        "per_layer")
                                    for m in BENCH[k]])
def test_metric_reader_found_by_name(metric):
    from bench import run
    reader = run.module(ROOT / "bench" / "metrics" / f"{metric}.py",
                        f"test_metric_{metric.replace('.', '_')}")
    assert callable(reader.read)


def test_cells_per_metric_exist():
    cells = {w["name"] for w in BENCH["workloads"]}
    for k in ("end_to_end", "per_layer"):
        for m in BENCH[k]:
            assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25
               for m in BENCH["end_to_end"])
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_no_jax_and_reads_no_old_benchmarks(path):
    """Top-level module names compared whole: ``repro_torch`` is not
    ``repro``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            assert name.split(".")[0] != "benchmarks", (path, name)
    assert "benchmarks" + "/" not in path.read_text()
