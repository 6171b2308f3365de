"""Time this checkout's plan and CYCLIC kernels against another checkout's,
in turns, in one process on one card.

  python3 tools/kernel_ab.py --base DIR

DIR is the root of another checkout of the repository (for instance the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Both versions of ``csrc/sketch_plan.cu`` and
``csrc/rolling.cu`` are built with nvcc into ``build/ab/``, called through
this checkout's wrappers (so the two C interfaces must agree: the wrappers
load a kernel through ``_build``, whose table of loaded libraries this tool
points at one build or the other), checked equal to the plain version, and
timed with ``chip_smoke.py``'s own rule (:func:`chip_smoke.in_turns`: base,
this, this, base, by torch.profiler device events) at the stats launch's
shape (1024 rows of 512 windows, the stats instance's plans, warm
registers) and at the Fig. 1 pair's (1024, 8192). A donated launch runs
only on this checkout, timed in turns against the copied one. Each line
names the card and its power limit.
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402  (one timing rule for both scripts)
from repro_torch.kernels import _build  # noqa: E402

SOURCES = ("sketch_plan", "rolling")


def build(root: Path, tag: str) -> dict:
    """nvcc the sources of one checkout, all at once -> {name: CDLL}."""
    out = _build.BUILD_DIR.parent / "ab" / tag
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in SOURCES:
        src = root / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
        jobs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(src)],
            stderr=subprocess.PIPE, text=True)
    for name, job in jobs.items():
        err = job.communicate()[1]
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name}.cu:\n{err}")
    return {name: ctypes.CDLL(str(out / f"lib{name}.so")) for name in SOURCES}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, type=Path)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.data import stats
    from repro_torch.kernels import hll, ref, sketch_fused
    from repro_torch.kernels.plan import BloomSpec, MinHashSpec, SketchPlan

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = {"base": build(args.base.resolve(), "base"),
            "this": build(ROOT, "this")}

    def on(tag, name, call):
        """``call`` run against one checkout's build of csrc/<name>.cu."""
        def run(*a, **kw):
            _build._libs[name] = libs[tag][name]
            return call(*a, **kw)
        return run

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    u32 = lambda *shape: torch.randint(0, 1 << 32, shape, generator=gen,
                                       device=dev, dtype=torch.int64).to(
                                           torch.uint32)
    ng = stats.NgramStats(stats.StatsConfig(device="cuda"))
    hs = ng.plan.hash
    hll_spec, cms_spec = ng.plan.sketches[0][1], ng.plan.sketches[1][1]
    regs = hll.hll_update(u32(30_000_000), b=hll_spec.b,
                          rank_bits=hll_spec.resolve_rank_bits(hs))
    table = torch.randint(0, 1000, (cms_spec.depth, cms_spec.width),
                          generator=gen, device=dev, dtype=torch.int32)
    B, C = 1024, 512
    toks = np.random.default_rng(0).integers(0, 8192, (B, C + hs.n - 1))
    x, xb = ng._lookup(toks.astype(np.int32)), u32(B, C + hs.n - 1)
    nw = torch.full((B,), C, dtype=torch.int32, device=dev)
    ws = torch.zeros((B,), dtype=torch.int32, device=dev)
    cms = {"a": ng._cms_params["a"], "b": ng._cms_params["b"]}
    bits = (u32(1 << 17).view(torch.int32)
            | u32(1 << 17).view(torch.int32)).view(torch.uint32)
    one = lambda name, spec: SketchPlan(hs, ((name, spec),))
    plans = {
        "minhash k=64": (one("sig", MinHashSpec(k=64)), None, {
            "sig": {"a": u32(64), "b": u32(64), "init": u32(B, 64)}}),
        "bloom k=4 log2_m=22": (one("bloom", BloomSpec(k=4, log2_m=22)), xb,
                                {"bloom": {"bits": bits,
                                           "init": torch.zeros_like(nw)}}),
        "hll warm": (one("hll", hll_spec), None, {"hll": {"init": regs}}),
        "countmin": (one("cms", cms_spec), None,
                     {"cms": {**cms, "init": table}}),
        "stats warm": (ng.plan, None, {"hll": {"init": regs},
                                       "cms": {**cms, "init": table}}),
    }
    ms = lambda kern, plain: chip_smoke.in_turns(torch, kern, plain, 200,
                                                 200)[:2]
    for what, (plan, xb_, ops0) in plans.items():
        # each side gets carries of its own (a donated one is folded into)
        make = lambda: {n: {k: v.clone() if k == "init" else v
                            for k, v in o.items()} for n, o in ops0.items()}
        want = ref.sketch_plan_ref(plan, x, xb_, nw, make(), w_start=ws)
        sides = {}
        for tag, donate in (("base", False), ("this", False), ("this", True)):
            ops = make()
            kern = on(tag, "sketch_plan", lambda ops=ops, donate=donate:
                      sketch_fused.sketch_plan_fused(
                          x, xb_, nw, ops, plan=plan, w_start=ws,
                          donate=donate))
            got = kern(make() if donate else ops)
            if any(not torch.equal(got[k], want[k]) for k in got):
                raise AssertionError(f"{tag} {what}: kernel != plain")
            sides[(tag, donate)] = kern
        this_ms, base_ms = ms(sides[("this", False)], sides[("base", False)])
        don_ms, copied_ms = ms(sides[("this", True)], sides[("this", False)])
        print(f"ab[{what}] (1024, {C + hs.n - 1}): base {base_ms:.5f} ms, "
              f"this {this_ms:.5f} ms; this donated {don_ms:.5f} ms against "
              f"copied {copied_ms:.5f} ms in the same turns [{card}]")

    xr = u32(1024, 8192)
    btoks = torch.randint(0, 256, (1024, 8192), generator=gen, device=dev,
                          dtype=torch.int32)
    tab = u32(256)
    from repro_torch.kernels import cyclic
    rolls = {
        "cyclic_rolling (1024, 8192) n=8": (
            lambda: cyclic.cyclic_rolling(xr, n=8),
            lambda: ref.cyclic_ref(xr, 8)),
        "cyclic_rolling_fused (1024, 8192) n=8": (
            lambda: sketch_fused.cyclic_rolling_fused(btoks, tab, n=8),
            lambda: ref.cyclic_fused_ref(btoks, tab, 8)),
    }
    for what, (call, plain) in rolls.items():
        base, this = (on(tag, "rolling", call) for tag in ("base", "this"))
        for tag, kern in (("base", base), ("this", this)):
            if not torch.equal(kern().to(torch.int64), plain()):
                raise AssertionError(f"{tag} {what}: kernel != plain")
        this_ms, base_ms = ms(this, base)
        print(f"ab[{what}]: base {base_ms:.5f} ms, this {this_ms:.5f} ms "
              f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
