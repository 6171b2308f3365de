"""CLI driver: ``python -m repro_torch.analysis`` — the port's analysis
pass.

Default runs every layer (lint, discard static+trace, the contract
matrix) and exits nonzero if anything fires; ``--lint`` / ``--discard`` /
``--contracts`` select a subset. The contracts run on ``cuda`` (the
kernels) unless ``--device cpu`` asks for the plain path; without a card
they exit nonzero rather than fall back. ``--devices`` sets the shard
counts of the contract matrix (virtual shards past the card count).
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="launch/dispatch contracts, Theorem-discard checks, "
                    "and the port's AST lint")
    ap.add_argument("--lint", action="store_true",
                    help="run only the AST lint")
    ap.add_argument("--discard", action="store_true",
                    help="run only the Theorem-1/2 discard checks")
    ap.add_argument("--contracts", action="store_true",
                    help="run only the contract matrix")
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 4],
                    metavar="D",
                    help="contract-matrix shard counts (default: 1 4)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the contracts run (default: cuda, the "
                         "kernels; cpu takes the plain path)")
    args = ap.parse_args(argv)

    run_all = not (args.lint or args.discard or args.contracts)
    if run_all or args.contracts:
        import torch
        if args.device == "cuda" and not torch.cuda.is_available():
            print("analysis: the contracts run on a CUDA card and none is "
                  "available; pass --device cpu for the plain path",
                  file=sys.stderr)
            return 2
    failures = 0
    t0 = time.perf_counter()

    if run_all or args.lint:
        from repro_torch.analysis import lint
        findings = lint.lint_tree()
        for f in findings:
            print(f)
        failures += len(findings)
        print(f"lint: {len(findings)} finding(s) in "
              f"{len(lint.scan_files())} file(s)")

    if run_all or args.discard:
        from repro_torch.analysis import discard
        static = discard.static_findings()
        for f in static:
            print(f)
        trace = discard.verify_decode_discard()
        for f in trace:
            print(f)
        failures += len(static) + len(trace)
        print(f"discard: {len(static)} static + {len(trace)} trace "
              f"finding(s); {len(discard.scope_files())} file(s) read")

    if run_all or args.contracts:
        from repro_torch.analysis import contracts
        violations = contracts.verify_contracts(
            device=args.device, device_counts=tuple(args.devices))
        for v in violations:
            print(v)
        failures += len(violations)
        print(f"contracts: {len(contracts.registry())} entries on "
              f"{args.device} over shard counts {tuple(args.devices)}, "
              f"{len(violations)} violation(s)")

    dt = time.perf_counter() - t0
    status = "FAIL" if failures else "OK"
    print(f"analysis: {status} — {failures} total finding(s) in {dt:.1f}s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
