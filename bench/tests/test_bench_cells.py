"""Each cell at a small size on the CPU, the program's plain paths
(``impl="ref"``) against the benchmark's reference; the result line's keys;
the controls, which put the reference in the program's place with a
guarantee broken, come out not correct; and the two forms of the dedup
reference agree."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_sizes import CELLS, CONTROL_UNITS, CONTROLS, SEED, run_small

from bench import generate, run
from bench.reference import dedup as ref_dedup
from bench_sizes import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_agrees_with_the_reference(cell, trace):
    out = run_small(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert list(out) == (KEYS[:-1] + ["breakdown", "checks"] if trace
                         else KEYS)
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in out["checks"].values())
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    metrics = out["metrics"]
    if trace:
        # no device on the CPU: no device metric is read
        assert not any(k in metrics for k in
                       ("idle_share", "window_roofline", "plan_roofline.scan",
                        "plan_roofline.minhash", "plan_launches_per_mtok"))
    else:
        # every end-to-end metric BENCHMARK.json gives the cell, and no other
        want = {m["name"] for m in run.metric_names(ROOT, cell, False)}
        assert set(metrics) == want
        assert metrics["tokens_s"]["value"] > 0
        assert metrics["setup_s"]["unit"] == "s"


@pytest.mark.parametrize("cell", CELLS)
def test_reference_in_the_programs_place_is_correct(cell):
    assert run_small(cell, control="reference")["correct"]


@pytest.mark.parametrize("cell,control", [(c, k) for c in CELLS
                                          for k in CONTROLS[c]])
def test_control_is_not_correct(cell, control):
    out = run_small(cell, control=control,
                    units=CONTROL_UNITS.get((cell, control), 4))
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("seed", [SEED, 7])
def test_dedup_reference_forms_agree(seed):
    """The vectorised verdicts over a stream equal the one-document-at-a-
    time index's, on a stream with many copies at both mutation levels."""
    mix = {"vocab": 1 << 10, "zipf_alpha": 1.1, "dup_share": 0.5,
           "length": {"median": 60, "sigma": 0.5, "min": 10, "max": 200},
           "mutations": [[0.5, 0.02], [0.5, 0.1]], "batch_docs": 40}
    stream = generate.DocumentStream(mix, seed)
    batches = [stream.next_batch() for _ in range(4)]
    gen = torch.Generator().manual_seed(seed)
    params = {"h1": torch.randint(0, 1 << 32, (1 << 10,), generator=gen),
              "a": torch.randint(0, 1 << 32, (16,), generator=gen) | 1,
              "b": torch.randint(0, 1 << 32, (16,), generator=gen)}
    for verify in (True, False):
        one = ref_dedup.ReferenceDeduper(params, 5, 32, 8, 0.75,
                                         verify=verify)
        flags = np.concatenate([one.add_batch(b) for b in batches])
        sigs = ref_dedup.signatures([d for b in batches for d in b],
                                    params, 5, 32)
        assert np.array_equal(ref_dedup.verdicts(sigs, 8, 0.75, verify),
                              flags)
        assert flags.any() and not flags.all()
