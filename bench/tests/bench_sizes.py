"""Small sizes of the cells for the CPU tests, and a helper that runs one."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import run  # noqa: E402

# the cells' own configurations and mixes, with the sizes cut for a CPU
# test: shorter documents and batches, smaller blocks, fewer eval passages
SMALL = {
    "dedup.web": {"traffic": {"batch_docs": 24, "length": {
        "median": 120, "sigma": 0.6, "min": 16, "max": 700}}},
    "dedup.long": {"traffic": {"batch_docs": 16, "length": {
        "median": 300, "sigma": 0.5, "min": 100, "max": 1000}}},
    "scan.web": {"traffic": {"block": [2, 16, 64], "pool_blocks": 3,
                             "planted_row_share": 0.125},
                 "config": {"eval": {"passages": 1, "passage_tokens": 600,
                                     "vocab": 10000, "zipf_alpha": 1.1}}},
}
CELLS = tuple(SMALL)
# the controls of each cell: the reference in the program's place with one
# guarantee broken (the jobs' CONTROLS)
CONTROLS = {"dedup.web": ("no_discard", "no_verify"),
            "dedup.long": ("no_discard", "no_verify"),
            "scan.web": ("no_carry",)}
UNITS = 3           # batches or blocks in a test's window
# batches a control's window needs at the small size to hold what it
# breaks: the long mix's 5% copies, of which half are near the threshold
CONTROL_UNITS = {("dedup.long", "no_verify"): 24}
SEED = 2**33 + 12345


def run_small(cell: str, *, seed: int = SEED, trace: bool = False,
              control=None, root: Path = ROOT, device: str = "cpu",
              impl: str = "ref", overrides=None, units: int = UNITS) -> dict:
    """One run of ``cell`` at its small size, ``units`` batches or blocks,
    on one host thread: the tensors are small, and the test runner's
    workers share the cores."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return run.run_cell(root, cell, seed, 600.0, trace, device=device,
                            impl=impl, overrides=overrides or SMALL[cell],
                            max_units=units, control=control)
    finally:
        torch.set_num_threads(threads)
