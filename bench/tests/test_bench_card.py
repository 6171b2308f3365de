"""The cells on a card at the small sizes: the program's kernels against the
reference, the traced run's device metrics, and the controls not correct.
Each test skips without a card; on the card's machine:

    python3 -m pytest -q bench/tests/test_bench_card.py
"""
from __future__ import annotations

import pytest
import torch

from bench import run
from bench_sizes import CELLS, CONTROL_UNITS, CONTROLS, ROOT, run_small


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card's machine)")
    return "cuda"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, cuda):
    out = run_small(cell, device=cuda, impl="auto", trace=True)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    # every per-layer metric BENCHMARK.json gives the cell is read
    want = {m["name"] for m in run.metric_names(ROOT, cell, True)}
    assert want <= set(out["metrics"]), want - set(out["metrics"])
    for name, m in out["metrics"].items():
        if name.endswith("roofline") or "_roofline." in name:
            assert 0 < m["value"] <= 100, name


@pytest.mark.parametrize("cell,control", [(c, k) for c in CELLS
                                          for k in CONTROLS[c]])
def test_control_on_the_card(cell, control, cuda):
    units = CONTROL_UNITS.get((cell, control), 4)
    assert not run_small(cell, device=cuda, control=control,
                         units=units)["correct"]
