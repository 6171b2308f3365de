"""Time this checkout's kernels against another checkout's, in turns, in one
process on one card.

  python3 tools/kernel_ab.py --base DIR [--only rolling hll ...]

DIR is the root of another checkout of the repository (for instance the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Both versions of ``csrc/sketch_plan.cu``,
``csrc/rolling.cu``, ``csrc/decode.cu``, ``csrc/bloom.cu`` and
``csrc/hll.cu`` are built with nvcc into ``build/ab/``, called through
this checkout's wrappers (the wrappers load a kernel through ``_build``,
whose table of loaded libraries this tool points at one build or the
other; so the two C interfaces must agree, except the decode kernel's and
``general_rolling``'s, which the other checkout's own wrappers call),
checked equal to the plain version, and timed with
``chip_smoke.py``'s own rule (:func:`chip_smoke.in_turns`: base, this,
this, base, by torch.profiler device events, a call's every device event
counted) at:

- the stats launch's shape (1024 rows of 512 windows, the stats instance's
  plans, warm registers); a donated launch runs only on this checkout,
  timed in turns against the copied one;
- the Fig. 1 pair's (1024, 8192), GENERAL at n in {1, 8, 25}, and the byte
  path's lookup kernel there;
- the serve path's decode launch, (16, 152064) and (256, 152064): a pool
  of 16 sessions (2^14-bit filters, k = 2, n = 4) primed with 128 random
  prompt tokens and stepped 64 times, the 2^20-bit canary filter (k = 4)
  of 1,000 random 4-grams, the rows repeated for 256;
- the byte path's ``bloom_probe`` at (1, 4,299,993), k = 4, 2^22 bits, a
  filter of 500,000 random pairs (fill about 0.38, as the path's);
- the byte path's ``hll_update`` at N = 4,299,996 random 28-bit hashes,
  b = 12, rank_bits = 16, with the minimum, median and maximum of each
  side's kernel events over 200 calls.

Each line names the card and its power limit.
"""
import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402  (one timing rule for both scripts)
from repro_torch.kernels import _build  # noqa: E402

SOURCES = ("sketch_plan", "rolling", "decode", "bloom", "hll")


def build(root: Path, tag: str, names) -> dict:
    """nvcc the named sources of one checkout, all at once -> {name:
    CDLL}."""
    out = _build.BUILD_DIR.parent / "ab" / tag
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        src = root / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
        jobs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(src)],
            stderr=subprocess.PIPE, text=True)
    for name, job in jobs.items():
        err = job.communicate()[1]
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name}.cu:\n{err}")
    return {name: ctypes.CDLL(str(out / f"lib{name}.so")) for name in names}


def base_wrapper(root: Path, name: str):
    """The other checkout's wrapper module ``kernels/<name>.py``, loaded
    beside this checkout's under another name (its own imports resolve to
    this checkout's package)."""
    path = root / "src" / "repro_torch" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"base_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--only", nargs="+", choices=SOURCES, default=SOURCES,
                    help="time these kernels' launches alone")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.data import stats
    from repro_torch.kernels import bloom, decode, hll, ref, sketch_fused
    from repro_torch.kernels.plan import BloomSpec, MinHashSpec, SketchPlan

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = {"base": build(args.base.resolve(), "base", args.only),
            "this": build(ROOT, "this", args.only)}

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
    ms = lambda kern, plain: chip_smoke.in_turns(torch, kern, plain, 200,
                                                 200)[:2]
    if "sketch_plan" in args.only:
        ng = stats.NgramStats(stats.StatsConfig(device="cuda"))
        hs = ng.plan.hash
        hll_spec, cms_spec = (spec for _, spec in ng.plan.sketches)
        regs = hll.hll_update(u32(30_000_000), b=hll_spec.b,
                              rank_bits=hll_spec.resolve_rank_bits(hs))
        table = torch.randint(0, 1000, (cms_spec.depth, cms_spec.width),
                              generator=gen, device=dev, dtype=torch.int32)
        B, C = 1024, 512
        toks = np.random.default_rng(0).integers(0, 8192,
                                                 (B, C + hs.n - 1))
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
            "bloom k=4 log2_m=22": (
                one("bloom", BloomSpec(k=4, log2_m=22)), xb,
                {"bloom": {"bits": bits, "init": torch.zeros_like(nw)}}),
            "hll warm": (one("hll", hll_spec), None,
                         {"hll": {"init": regs}}),
            "countmin": (one("cms", cms_spec), None,
                         {"cms": {**cms, "init": table}}),
            "stats warm": (ng.plan, None, {"hll": {"init": regs},
                                           "cms": {**cms, "init": table}}),
        }
        for what, (plan, xb_, ops0) in plans.items():
            # each side gets carries of its own (a donated one is folded
            # into)
            make = lambda: {n: {k: v.clone() if k == "init" else v
                                for k, v in o.items()}
                            for n, o in ops0.items()}
            want = ref.sketch_plan_ref(plan, x, xb_, nw, make(), w_start=ws)
            sides = {}
            for tag, donate in (("base", False), ("this", False),
                                ("this", True)):
                ops = make()
                kern = on(tag, "sketch_plan", lambda ops=ops, donate=donate:
                          sketch_fused.sketch_plan_fused(
                              x, xb_, nw, ops, plan=plan, w_start=ws,
                              donate=donate))
                got = kern(make() if donate else ops)
                if any(not torch.equal(got[k], want[k]) for k in got):
                    raise AssertionError(f"{tag} {what}: kernel != plain")
                sides[(tag, donate)] = kern
            this_ms, base_ms = ms(sides[("this", False)],
                                  sides[("base", False)])
            don_ms, copied_ms = ms(sides[("this", True)],
                                   sides[("this", False)])
            print(f"ab[{what}] (1024, {C + hs.n - 1}): base {base_ms:.5f} "
                  f"ms, this {this_ms:.5f} ms; this donated {don_ms:.5f} ms "
                  f"against copied {copied_ms:.5f} ms in the same turns "
                  f"[{card}]")

    if "rolling" in args.only:
        xr = u32(1024, 8192)
        btoks = torch.randint(0, 256, (1024, 8192), generator=gen,
                              device=dev, dtype=torch.int32)
        tab = u32(256)
        from repro_torch.core import gf2
        from repro_torch.kernels import cyclic, general
        p32 = gf2.find_irreducible_host(32)
        base_general = base_wrapper(args.base.resolve(), "general")
        rolls = {
            "cyclic_rolling (1024, 8192) n=8": (
                lambda mod: cyclic.cyclic_rolling(xr, n=8),
                lambda: ref.cyclic_ref(xr, 8)),
            "cyclic_rolling_fused (1024, 8192) n=8": (
                lambda mod: sketch_fused.cyclic_rolling_fused(btoks, tab,
                                                              n=8),
                lambda: ref.cyclic_fused_ref(btoks, tab, 8)),
        }
        for n in (1, 8, 25):
            rolls[f"general_rolling (1024, 8192) n={n}, route "
                  f"{general.route(n, p32, 32)}"] = (
                lambda mod, n=n: mod.general_rolling(xr, n=n, p=p32),
                lambda n=n: ref.general_ref(xr, n, p32, 32))
        for what, (call, plain) in rolls.items():
            base, this = (on(tag, "rolling",
                             lambda mod=mod, call=call: call(mod))
                          for tag, mod in (("base", base_general),
                                           ("this", general)))
            for tag, kern in (("base", base), ("this", this)):
                if not torch.equal(kern().to(torch.int64), plain()):
                    raise AssertionError(f"{tag} {what}: kernel != plain")
            this_ms, base_ms = ms(this, base)
            print(f"ab[{what}]: base {base_ms:.5f} ms, this {this_ms:.5f} ms "
                  f"[{card}]")

    if "decode" in args.only:
        # the serve path's decode launch, with a primed and stepped pool
        from repro_torch.core import sketches
        from repro_torch.core import u32 as u32m
        from repro_torch.kernels.plan import DecodeSpec
        from repro_torch.serve import sessions
        spec = DecodeSpec(n=4, L=32, log2_m=14, k=2, canary_log2_m=20,
                          canary_k=4)
        V, vocab = 152064, 151936
        h1 = u32(V)
        rng = np.random.default_rng(11)
        grams = torch.from_numpy(rng.integers(0, vocab,
                                              (1000, spec.n))).to(dev)
        cbits = chip_smoke.canary_filter(torch, u32m, ref, sketches, spec, h1,
                                         grams)
        pool = sessions.SessionPool(spec, 16, h1, canary_bits=cbits,
                                    device=dev)
        pool.admit(16)
        pool.prime(rng.integers(0, vocab, (16, 128)))
        for _ in range(64):
            pool.step(torch.randn((16, V), generator=gen, device=dev),
                      temperature=0.0)
        st = pool.state
        ready = (st["count"] >= spec.n - 1) & (st["active"] != 0)
        rows16 = (torch.randn((16, V), generator=gen, device=dev),
                  st["prefix"], ready, st["bloom"])
        base_decode = base_wrapper(args.base.resolve(), "decode")
        for B in (16, 256):
            def rep(t):     # B // 16 copies of the 16 rows (uint32 as int32)
                u = t.dtype == torch.uint32
                v = (t.view(torch.int32) if u else t).repeat(
                    (B // 16,) + (1,) * (t.dim() - 1))
                return (v.view(torch.uint32) if u else v).contiguous()
            a = tuple(rep(t) for t in rows16) + (pool.h1,)
            plain = ref.decode_masks_ref(
                *a, n=spec.n, L=spec.L, hash_mask=spec.hash_mask,
                log2_m=spec.log2_m, k=spec.k, canary_bits=cbits,
                canary_log2_m=spec.canary_log2_m, canary_k=spec.canary_k)
            sides = {}
            for tag, mod in (("base", base_decode), ("this", decode)):
                kern = on(tag, "decode",
                          lambda mod=mod: mod.decode_masks_fused(
                              *a, spec=spec, canary_bits=cbits))
                got = kern()
                for key in plain:
                    g, w = got[key], plain[key]
                    if g.dtype == torch.float32:
                        g, w = g.view(torch.int32), w.view(torch.int32)
                    if not torch.equal(g, w):
                        raise AssertionError(f"{tag} decode ({B}, {V}): {key} "
                                             f"!= plain")
                sides[tag] = kern
            this_ms, base_ms = ms(sides["this"], sides["base"])
            print(f"ab[decode_masks ({B}, {V}) n=4 log2_m=14 k=2 canary 2^20 "
                  f"k=4, a stepped pool]: base {base_ms:.5f} ms, this "
                  f"{this_ms:.5f} ms [{card}]")

    if "bloom" in args.only:
        # the byte path's scan: bloom_probe at the path's shape and fill
        from repro_torch.core import BloomFilter
        N = 4_300_000 - 8 + 1
        ha, hb = u32(1, N), u32(1, N)
        bf = BloomFilter(log2_m=22, k=4)
        bits = bf.add(bf.init(dev), u32(1, 500_000), u32(1, 500_000))
        fill = float(bf.fill_fraction(bits))
        want = ref.bloom_probe_ref(ha, hb, bits, k=4, log2_m=22)
        sides = {}
        for tag in ("base", "this"):
            kern = on(tag, "bloom", lambda: bloom.bloom_probe(
                ha, hb, bits, k=4, log2_m=22))
            if not torch.equal(kern(), want):
                raise AssertionError(f"{tag} bloom_probe: kernel != plain")
            sides[tag] = kern
        this_ms, base_ms = ms(sides["this"], sides["base"])
        print(f"ab[bloom_probe (1, {N}) k=4 log2_m=22, fill {fill:.4f}]: base "
              f"{base_ms:.5f} ms, this {this_ms:.5f} ms [{card}]")

    if "hll" in args.only:
        # the byte path's count: hll_update at the path's shape
        N = 4_300_000 - 5 + 1
        h28 = torch.randint(0, 1 << 28, (N,), generator=gen, device=dev,
                            dtype=torch.int64).to(torch.uint32)
        want = ref.hll_update_ref(h28, b=12, rank_bits=16)
        sides = {}
        for tag in ("base", "this"):
            kern = on(tag, "hll", lambda: hll.hll_update(h28, b=12,
                                                         rank_bits=16))
            if not torch.equal(kern(), want):
                raise AssertionError(f"{tag} hll_update: kernel != plain")
            sides[tag] = kern
        this_ms, base_ms = ms(sides["this"], sides["base"])
        spread = {tag: chip_smoke.spread(
            [us for name, us in chip_smoke.launch_times(torch, kern)
             if "hll" in name]) for tag, kern in sides.items()}
        print(f"ab[hll_update N={N} b=12 rank_bits=16]: base {base_ms:.5f} "
              f"ms, this {this_ms:.5f} ms (the call); the kernel's own "
              f"events, min / median / max over 200 calls: base "
              f"{spread['base']}, this {spread['this']} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
