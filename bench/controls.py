"""The controls of ``correct`` at a cell's own size, on the card.

    python3 bench/controls.py --workload <cell> --seeds <n,n,...> --units <u>
        [--controls <name,...>]

Each control puts the plain reference in the program's place with one
guarantee of the configuration broken (the job's ``CONTROLS``) and drives
the cell's window for ``--units`` batches or blocks at the cell's own
traffic; one line a run gives the numbers compared and their limits. The
benchmark's own runs never run a control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, required=True)
    ap.add_argument("--controls", default="")
    args = ap.parse_args(argv)
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch
    from bench import run
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    loaded = run.load_cell(ROOT, args.workload)
    job = run.module(ROOT / "bench" / "jobs" / f"{loaded['config']['job']}.py",
                     "bench_controls_job")
    names = ([c for c in args.controls.split(",") if c] or
             [c for c in job.CONTROLS if c != "reference"])
    for name in names:
        for seed in (int(s) for s in args.seeds.split(",")):
            out = run.run_cell(ROOT, args.workload, seed, 3600.0, False,
                               max_units=args.units, control=name)
            print(json.dumps({"workload": args.workload, "control": name,
                              "seed": seed, "correct": out["correct"],
                              "attempted": out["attempted"],
                              "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
