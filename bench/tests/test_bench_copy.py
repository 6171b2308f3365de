"""The harness as a later change meets it: a new traffic mix, cell and
per-layer metric added to a copy of the benchmark as files alone; and the
command line's refusals, each in a process of its own: no card, no program
beside the benchmark, and no JAX loaded by a run."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_sizes import ROOT, SMALL, run_small

NEW_METRIC = '''"""docs_per_call: documents a call of the window."""


def read(m):
    calls = m.get("calls_s")
    return m["docs"] / len(calls) if calls else None
'''


def _copy(dst: Path) -> Path:
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def test_a_cell_mix_and_metric_added_as_files(tmp_path):
    root = _copy(tmp_path)
    mix = json.loads((root / "bench" / "traffic" / "web.json").read_text())
    mix["dup_share"] = 0.6
    (root / "bench" / "traffic" / "web_dups.json").write_text(json.dumps(mix))
    cell = {"name": "dedup.web_dups", "config": "minhash-fineweb",
            "traffic": "web_dups", "chips": 1,
            "why": "web documents, 60% near-duplicates"}
    (root / "bench" / "workloads" / "dedup.web_dups.json").write_text(
        json.dumps(cell))
    (root / "bench" / "metrics" / "docs_per_call.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "docs_per_call", "unit": "docs", "better": "higher",
        "source": "host_clock", "layer": "LSH index and verify",
        "moves": "tokens_s", "workloads": ["dedup.web_dups"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = run_small("dedup.web_dups", root=root, trace=True,
                    overrides=SMALL["dedup.web"])
    assert out["correct"], out["checks"]
    # the new metric names only the new cell; the old cells' names not it
    assert out["metrics"]["docs_per_call"]["value"] == 24
    assert "lsh_us_per_doc" not in out["metrics"]


def test_a_cell_on_four_cards_shards_the_scan(tmp_path):
    """A cell that asks for four cards row-shards the scan over them (on
    the CPU: four virtual shards) and is judged as one card is."""
    root = _copy(tmp_path)
    cell = {"name": "scan.web.4card", "config": "ngram-scan",
            "traffic": "streams", "chips": 4,
            "why": "as scan.web, sharded over four cards"}
    (root / "bench" / "workloads" / "scan.web.4card.json").write_text(
        json.dumps(cell))
    out = run_small("scan.web.4card", root=root,
                    overrides=SMALL["scan.web"])
    assert out["correct"], out["checks"]


STATS = {"family": "cyclic", "ngram_n": 8, "L": 32, "hll_b": 12,
         "cms_depth": 4, "cms_log2_width": 16, "vocab": 131072}


@pytest.mark.parametrize("control", [None, "no_carry", "no_discard"])
def test_a_configuration_with_the_stats_half_added_as_files(tmp_path,
                                                            control):
    """A configuration that gives the scan's stats half beside its decontam
    half is a file, and its cell another: the sketches are judged against
    the reference's, and each control of the half comes out not correct."""
    root = _copy(tmp_path)
    config = json.loads((root / "bench" / "configs" / "ngram-scan.json")
                        .read_text())
    config.update(name="ngram-stats", stats=STATS,
                  source="a configuration of the CPU tests")
    (root / "bench" / "configs" / "ngram-stats.json").write_text(
        json.dumps(config))
    cell = {"name": "stats.web", "config": "ngram-stats",
            "traffic": "streams", "chips": 1, "why": "the stats half too"}
    (root / "bench" / "workloads" / "stats.web.json").write_text(
        json.dumps(cell))
    out = run_small("stats.web", root=root, overrides=SMALL["scan.web"],
                    control=control, units=4)
    assert {"hll_registers_off", "cms_cells_off", "rows_off",
            "tokens_off"} <= set(out["checks"])
    assert out["correct"] == (control is None), out["checks"]
    if control == "no_discard":
        # the filter's 25 address bits are the kept bits: only the
        # sketches, which read past them, see the discard broken
        assert out["checks"]["rows_off"]["value"] == 0
        assert (out["checks"]["hll_registers_off"]["value"]
                + out["checks"]["cms_cells_off"]["value"]) > 0


def _python(code: str, cwd: Path, pythonpath: str = "") -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": pythonpath, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_no_jax():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT / 'bench' / 'tests')!r})\n"
            "from bench_sizes import run_small\n"
            "from bench import run\n"
            "for cell in ('dedup.web', 'scan.web'):\n"
            "    assert run_small(cell, units=1)['correct']\n"
            "print(run.forbidden_modules())\n")
    proc = _python(code, ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "scan.web", "--seed",
         "3000000000", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    if proc.returncode == 0:        # a card is there: nothing to refuse
        return
    assert proc.returncode == 2
    assert proc.stdout == ""


def test_the_benchmark_alone_does_not_run(tmp_path):
    """A directory with only BENCHMARK.json and bench/: no program to run."""
    root = _copy(tmp_path)
    code = ("import sys\n"
            f"sys.path.insert(0, {str(root)!r})\n"
            "from pathlib import Path\n"
            "from bench import run\n"
            f"run.run_cell(Path({str(root)!r}), 'scan.web', 1, 1.0, False, "
            f"device='cpu', impl='ref', overrides={SMALL['scan.web']!r}, "
            "max_units=1)\n"
            "print('ran')\n")
    proc = _python(code, root)
    assert proc.returncode != 0
    assert "ran" not in proc.stdout
    assert "repro_torch" in proc.stderr
