"""Roofline report of the dry run: reads ``artifacts/dryrun_torch/*.json``
(:mod:`repro_torch.launch.dryrun`'s records), renders the dry-run and
roofline tables and CSV rows, as the JAX package's
``repro/launch/roofline.py`` does for its records.

Terms, computed from the H100's data-sheet peaks (``configs.base.H100``,
the SXM part at 700 W), never measured:
  compute_s    = census matrix-product FLOPs / (chips * 989e12)
  memory_s     = census computed bytes / (chips * 3.35e12)
  collective_s = collective operand bytes / (chips * 450e9)
All three use totals = per-device x chips, so the ratios are per card.
Roofline fraction = model_flops-at-peak / max(term): how close the cell's
*useful* work comes to the bound its dominant term sets.

Usage:
  python -m repro_torch.launch.roofline                 # print the tables
  python -m repro_torch.launch.roofline --write FILE    # splice them into
                                                        # FILE's markers
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List, Optional

from repro_torch.configs.base import H100

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "../../../artifacts/dryrun_torch")


def load(art_dir: str = ARTIFACT_DIR,
         include_variants: bool = False) -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("variant") and not include_variants:
            continue
        recs.append(r)
    return recs


def roofline_fraction(rec: Dict) -> Optional[float]:
    """useful-work-at-peak vs the dominant bound:
    (model_flops / peak) / max(compute_s, memory_s, collective_s)."""
    if not rec.get("ok"):
        return None
    t_bound = max(rec["roofline"].values())
    if t_bound <= 0:
        return None
    t_useful = rec["model_flops"] / (rec["chips"] * H100.peak_flops)
    return t_useful / t_bound


def fmt_table(recs: List[Dict], mesh: str = "16x16") -> str:
    rows = [r for r in recs if r.get("mesh") == mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = ["| arch | shape | compute_s | memory_s | collective_s | dominant | "
           "useful/dot | roofline frac | HBM GB/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | FAILED: "
                       f"{r.get('error', '')[:60]} | | | | | | |")
            continue
        t = r["roofline"]
        frac = roofline_fraction(r)
        out.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3e} | "
            f"{t['memory_s']:.3e} | {t['collective_s']:.3e} | "
            f"{r['dominant'].replace('_s', '')} | "
            f"{(r['useful_flops_ratio'] or 0):.3f} | "
            f"{(frac or 0):.3f} | {r['hbm_per_device_gb']:.2f} |")
    return "\n".join(out)


def fmt_dryrun_table(recs: List[Dict]) -> str:
    rows = sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    out = ["| arch | shape | mesh | ok | census_s | FLOPs/dev | bytes/dev | "
           "coll bytes/dev | AG/AR/RS/A2A/CP counts |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | NO | "
                       f"{r.get('error', '')[:70]} | | | | |")
            continue
        c = r["collective_counts"]
        cc = "/".join(str(int(c.get(k, 0))) for k in
                      ("all-gather", "all-reduce", "reduce-scatter",
                       "all-to-all", "collective-permute"))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{r['census_s']:.1f} | {r['flops_per_device']:.3e} | "
            f"{r['bytes_per_device']:.3e} | "
            f"{r['collective_bytes_per_device']:.3e} | {cc} |")
    return "\n".join(out)


def pick_hillclimb_targets(recs: List[Dict]) -> Dict[str, Dict]:
    """The cells a later optimisation would start from: the worst roofline
    fraction and the most collective-bound, on the single-pod mesh."""
    ok = [r for r in recs if r.get("ok") and r["mesh"] == "16x16"]
    if not ok:
        return {}
    worst = min(ok, key=lambda r: roofline_fraction(r) or 9e9)
    coll = max(ok, key=lambda r: (r["roofline"]["collective_s"] /
                                  max(sum(r["roofline"].values()), 1e-30)))
    return {"worst_fraction": worst, "most_collective_bound": coll}


def bench_rows(art_dir: str = ARTIFACT_DIR) -> List[str]:
    out = []
    for r in load(art_dir):
        if not r.get("ok"):
            out.append(f"roofline_{r['arch']}_{r['shape']}_{r['mesh']},0.0,"
                       f"FAILED")
            continue
        frac = roofline_fraction(r)
        t = max(r["roofline"].values())
        out.append(
            f"roofline_{r['arch']}_{r['shape']}_{r['mesh']},"
            f"{t * 1e6:.1f},"
            f"dominant={r['dominant'].replace('_s', '')};frac={frac:.3f}")
    return out


def _splice(text: str, start: str, end: str, payload: str) -> str:
    i = text.index(start) + len(start)
    j = text.index(end)
    return text[:i] + "\n" + payload + "\n" + text[j:]


def write_experiments(path: str, art_dir: str = ARTIFACT_DIR) -> None:
    """Replace the tables between ``<!-- DRYRUN_TABLE_START/END -->`` and
    ``<!-- ROOFLINE_TABLE_START/END -->`` in the file at ``path``."""
    recs = load(art_dir)
    with open(path) as f:
        text = f.read()
    roof = ("**single pod (16×16, 256 positions)**\n\n"
            + fmt_table(recs, "16x16")
            + "\n\n**multi-pod (2×16×16, 512 positions)**\n\n"
            + fmt_table(recs, "2x16x16"))
    text = _splice(text, "<!-- DRYRUN_TABLE_START -->",
                   "<!-- DRYRUN_TABLE_END -->", fmt_dryrun_table(recs))
    text = _splice(text, "<!-- ROOFLINE_TABLE_START -->",
                   "<!-- ROOFLINE_TABLE_END -->", roof)
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path} ({len(recs)} records)")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--write"]:
        if len(argv) != 2:
            raise SystemExit("--write FILE")
        write_experiments(argv[1])
        return 0
    recs = load()
    print(f"{len(recs)} records (computed from H100 SXM data-sheet peaks, "
          f"700 W)")
    print(fmt_dryrun_table(recs))
    print()
    print(fmt_table(recs, "16x16"))
    print()
    print(fmt_table(recs, "2x16x16"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
