#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, and no network. In order it

1. prints the card's name and power limit;
2. builds every kernel under ``src/repro_torch/kernels/csrc`` with nvcc;
3. holds the plan kernel bit-exact against its plain PyTorch version on the
   card (``api.run(impl="kernel")`` against ``impl="ref"``), both families,
   over B in {64, 1024} and S in {7, 520, 8192} with random ``n_windows``,
   ``w_start`` and ``init``;
4. drives the dedup main path (``MinHashDeduper.add_batch``) over a 100,000
   document corpus with planted near-duplicates (CYCLIC) and over 20,000 of
   them (GENERAL), at the reference's published widths (n=8, L=32, k=64,
   16 bands): the kernel's launch count must rise, recall and precision
   against the planted truth must exceed 0.9, and 2,000 documents re-signed
   through the plain version on the card must give the same signatures;
5. times add_batch end to end, the kernel per launch at the main path's
   shape beside the plain version, and reckons the kernel's bound.

It prints one JSON line describing each kernel and, last, the device line.
Any failure raises and exits non-zero; without a CUDA card it exits 2.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM: 132 SMs at the 1.98 GHz boost clock (NVIDIA's Hopper white
# paper; the same figures give the data sheet's 67 TFLOP/s float32 as
# 132 x 128 x 2 x 1.98e9), and 3.35 TB/s of HBM3. Each SM issues integer
# instructions to two pipes of 64 lanes a clock: the INT32 (ALU) pipe, which
# runs logic, shifts and min/max, and the FMA pipe, which also runs IMAD.
LANES_PER_S = 132 * 64 * 1.98e9     # one pipe, one instruction a lane-clock
HBM_BYTES_PER_S = 3.35e12

K, N, L, BANDS = 64, 8, 32, 16
STREAM_ROWS = 1024          # rows per launch on the dedup path
CHUNK_S = 512               # the deduper's default stream_chunk_s


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profiled(torch, fn, iters: int = 1):
    """Run ``fn`` ``iters`` times under torch.profiler after a warm-up.
    Returns (host seconds to issue the calls, wall seconds until the card
    finished, [(device us, name, count)] of every kernel, copy and fill
    the calls put on the card, largest first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        issue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's event repeats its kernels' time
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        raise RuntimeError("torch.profiler saw no device time")
    return issue, wall, rows


def device_ms(torch, fn, iters: int):
    """(device ms, host ms) per call of ``fn``. The host needs longer to
    issue a launch than the card needs to run it, so CUDA events around a
    loop would time the host; the card's own time is the sum of the device
    events the calls produced."""
    issue, _, rows = profiled(torch, fn, iters)
    return sum(r[0] for r in rows) / 1e3 / iters, issue * 1e3 / iters


def window_ops(plan) -> tuple:
    """Fewest integer instructions the plan's function needs per valid
    window, as (ALU-pipe, FMA-pipe) counts. The hash is counted in its
    rolling form, one step per window: CYCLIC h' = rotl(h, 1) ^ rotl(out, n)
    ^ in is two rotations (one funnel shift each at L = 32; two shifts below
    it, with the OR and the mask folded into the XORs) and the XORs (one
    three-input LOP3 at L = 32, two below); GENERAL h' = x*h ^ c*out ^ in
    with c = x^n mod p is one shift-reduce step for x*h and one per further
    bit of c (shift, sign spread, LOP3 at L = 32; two more below), one XOR
    per set bit of c and one LOP3 to join the three. Then one AND for the
    discard mask, and per signature lane one IMAD (a*h + b, FMA pipe) and
    one IMNMX (the min, ALU pipe)."""
    from repro_torch.core.gf2 import x_pow_mod_host
    hs = plan.hash
    full = hs.L == 32
    if hs.family == "cyclic":
        rots = sum(1 for r in (1 % hs.L, hs.n % hs.L) if r)
        hash_ops = rots * (1 if full else 2) + (1 if full else 2)
    else:
        c = x_pow_mod_host(hs.n, hs.p, hs.L)
        step = 3 if full else 5
        hash_ops = step * c.bit_length() + bin(c).count("1") + 1
    k = sum(spec.k for _, spec in plan.sketches)
    return hash_ops + 1 + k, k


def ops_bound_ms(plan, windows: int) -> float:
    """Least ms for ``windows`` valid windows by integer issue: the ALU
    pipe's own instructions at one pipe's rate, or all of them spread over
    both pipes, whichever is longer."""
    alu, fma = window_ops(plan)
    return windows * max(alu, (alu + fma) / 2) / LANES_PER_S * 1e3


def device_busy(torch, fn, card: str, what: str) -> None:
    """Profile one call of ``fn``: wall time, the card's busy time and the
    top device events by it."""
    _, wall, rows = profiled(torch, fn)
    busy = sum(r[0] for r in rows) / 1e6
    top = "; ".join(f"{k[:48]} x{c} {t / 1e3:.3f} ms" for t, k, c in rows[:6])
    print(f"profile[{what}]: wall {wall:.3f} s under the profiler, device "
          f"busy {busy:.4f} s = {busy / wall:.4f} of it, idle "
          f"{1 - busy / wall:.4f}; by device time: {top} [{card}]")


def check_kernel(torch, api, plan, gen, B, S):
    """One kernel-vs-plain comparison on the card; returns max |diff|."""
    dev = torch.device("cuda")
    W = max(0, S - plan.hash.n + 1)
    x = torch.randint(0, 1 << 32, (B, S), generator=gen, dtype=torch.int64)
    nw = torch.randint(0, W + 2, (B,), generator=gen, dtype=torch.int32)
    ws = torch.randint(0, plan.hash.n + 1, (B,), generator=gen,
                       dtype=torch.int32)
    a = torch.randint(0, 1 << 32, (K,), generator=gen, dtype=torch.int64) | 1
    b = torch.randint(0, 1 << 32, (K,), generator=gen, dtype=torch.int64)
    init = torch.randint(0, 1 << 32, (B, K), generator=gen,
                         dtype=torch.int64)
    u32 = lambda t: t.to(torch.uint32).to(dev)
    args = dict(n_windows=nw.to(dev), w_start=ws.to(dev),
                operands={"sig": {"a": u32(a), "b": u32(b),
                                  "init": u32(init)}})
    got = api.run(plan, u32(x), impl="kernel", **args)["sig"]
    want = api.run(plan, u32(x), impl="ref", **args)["sig"]
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(
            f"kernel != plain version: {plan.hash.family} B={B} S={S}, "
            f"max |diff| {err}")
    return err


def dedup_run(torch, corpus_docs, truth, family, sketch_fused, dedup, card):
    """The main path: add_batch over the corpus with the launch count read
    around it; returns (deduper, launches, seconds, tokens)."""
    cfg = dedup.DedupConfig(vocab=8192, threshold=0.5, ngram_n=N, L=L,
                            n_signatures=K, lsh_bands=BANDS, family=family,
                            stream_rows=STREAM_ROWS, stream_chunk_s=CHUNK_S,
                            device="cuda")
    dd = dedup.MinHashDeduper(cfg)
    tokens = sum(len(d) for d in corpus_docs)
    torch.cuda.synchronize()
    sketch_fused.LAUNCHES = 0
    t0 = time.perf_counter()
    flags = dd.add_batch(corpus_docs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = sketch_fused.LAUNCHES
    tp = int((flags & truth).sum())
    recall = tp / max(int(truth.sum()), 1)
    precision = tp / max(int(flags.sum()), 1)
    print(f"main[{family}]: {len(corpus_docs)} docs, {tokens} tokens, "
          f"stream_rows={STREAM_ROWS}, stream_chunk_s={CHUNK_S}: add_batch "
          f"{dt:.3f} s = {tokens / dt:.0f} tokens/s, {launches} kernel "
          f"launches, recall {recall:.4f}, precision {precision:.4f} "
          f"[{card}]")
    if launches < 1:
        raise AssertionError(f"{family}: add_batch launched no kernel")
    if not (recall > 0.9 and precision > 0.9):
        raise AssertionError(f"{family}: recall {recall} / precision "
                             f"{precision} not above 0.9")
    return dd, launches, dt, tokens


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.data import corpus, dedup
    from repro_torch.kernels import _build, api, ref, sketch_fused
    from repro_torch.kernels.plan import HashSpec, MinHashSpec, SketchPlan

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build(_build.sources())
    print(f"build: {_build.sources()} with {_build.nvcc()} into "
          f"{_build.BUILD_DIR} in {time.perf_counter() - t0:.2f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"build[{name}]: {line.strip()}")

    # -- 3. kernel against plain version ----------------------------------
    plans = {f: SketchPlan(HashSpec(family=f, n=N, L=L),
                           (("sig", MinHashSpec(k=K)),))
             for f in ("cyclic", "general")}
    gen = torch.Generator().manual_seed(0)
    max_err = 0
    for family, plan in plans.items():
        for B in (64, 1024):
            for S in (7, 520, 8192):
                max_err = max(max_err, check_kernel(torch, api, plan, gen,
                                                    B, S))
                print(f"check: {family} B={B} S={S} k={K}: kernel == "
                      f"plain version on the card")

    # -- 4. the main path ---------------------------------------------------
    t0 = time.perf_counter()
    spec = corpus.CorpusSpec(n_docs=100_000, dup_rate=0.25,
                             mutate_frac=0.015, vocab=8192, seed=42)
    docs, dup_of = corpus.documents(spec)
    truth = dup_of >= 0
    print(f"corpus: {len(docs)} docs, {int(truth.sum())} planted "
          f"near-duplicates, made in {time.perf_counter() - t0:.2f} s")
    dd, launches, dt, tokens = dedup_run(torch, docs, truth, "cyclic",
                                         sketch_fused, dedup, card)

    # re-sign 2,000 documents through the plain version on the card
    plain = dedup.MinHashDeduper(dedup.DedupConfig(**{**dd.cfg.__dict__,
                                                      "impl": "ref"}))
    plain.import_params(dd.export_state()["params"])
    sub = docs[:2000]
    if not np.array_equal(dd.signature_many(sub), plain.signature_many(sub)):
        raise AssertionError("cyclic: kernel signatures != plain version")
    print("main[cyclic]: 2000 documents re-signed by the plain version on "
          "the card: equal")

    # signing alone (warm), to split add_batch into card and host work
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dd.signature_many(docs)
    torch.cuda.synchronize()
    t_sign = time.perf_counter() - t0
    print(f"main[cyclic]: signature_many alone {t_sign:.3f} s = "
          f"{tokens / t_sign:.0f} tokens/s; LSH probe + verify "
          f"{dt - t_sign:.3f} s of add_batch [{card}]")
    device_busy(torch, lambda: dd.signature_many(docs[:20_000]), card,
                "cyclic signature_many, 20000 docs")

    gdocs, gtruth = docs[:20_000], truth[:20_000]
    gdd, glaunches, _, _ = dedup_run(torch, gdocs, gtruth, "general",
                                     sketch_fused, dedup, card)
    gplain = dedup.MinHashDeduper(dedup.DedupConfig(**{**gdd.cfg.__dict__,
                                                       "impl": "ref"}))
    gplain.import_params(gdd.export_state()["params"])
    if not np.array_equal(gdd.signature_many(sub),
                          gplain.signature_many(sub)):
        raise AssertionError("general: kernel signatures != plain version")
    print("main[general]: 2000 documents re-signed by the plain version on "
          "the card: equal")

    # -- 5. the kernel at the main path's shape -----------------------------
    # one launch of the dedup path: stream_rows rows of n-1 carried symbols
    # plus a full chunk, every window valid, a carried signature
    plan = plans["cyclic"]
    dev = torch.device("cuda")
    B, S = STREAM_ROWS, N - 1 + CHUNK_S
    x = torch.randint(0, 1 << 32, (B, S), generator=gen,
                      dtype=torch.int64).to(torch.uint32).to(dev)
    nw = torch.full((B,), CHUNK_S, dtype=torch.int32, device=dev)
    ws = torch.zeros((B,), dtype=torch.int32, device=dev)
    ops = {"sig": {"a": dd.mh_params["a"], "b": dd.mh_params["b"],
                   "init": api.full_u32((B, K), 0xFFFFFFFF, dev)}}
    kern = lambda: sketch_fused.sketch_plan_fused(x, None, nw, ops,
                                                  plan=plan, w_start=ws)
    plain_fn = lambda: ref.sketch_plan_ref(plan, x, None, nw, ops,
                                           w_start=ws)
    if not torch.equal(kern()["sig"], plain_fn()["sig"]):
        raise AssertionError("kernel != plain version at the main shape")
    # plain, kernel, kernel, plain: compare within one call, in turns
    (p1, _), (k1, kh), (k2, _), (p2, ph) = (
        device_ms(torch, plain_fn, 10), device_ms(torch, kern, 200),
        device_ms(torch, kern, 200), device_ms(torch, plain_fn, 10))
    ms, plain_ms = min(k1, k2), min(p1, p2)
    windows = B * CHUNK_S
    alu, fma = window_ops(plan)
    bytes_needed = 4 * (B * S + 2 * B + 2 * K + 2 * B * K)
    t_ops = ops_bound_ms(plan, windows)
    t_bytes = bytes_needed / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"kernel[cyclic] B={B} S={S} k={K}: {ms:.5f} ms per launch "
          f"({k1:.5f}, {k2:.5f}); plain version {plain_ms:.5f} ms "
          f"({p1:.5f}, {p2:.5f}); bound {bound_ms:.5f} ms by {bound_by} "
          f"({windows} windows x ({alu} ALU + {fma} FMA) instructions: "
          f"{t_ops:.5f} ms; {bytes_needed} bytes: {t_bytes:.5f} ms); "
          f"bound / time {bound_ms / ms:.3f}; the host takes {kh:.5f} ms to "
          f"issue one launch, {ph:.5f} ms one plain call [{card}]")
    gplan = plans["general"]
    gk, _ = device_ms(torch, lambda: sketch_fused.sketch_plan_fused(
        x, None, nw, ops, plan=gplan, w_start=ws), 200)
    gb = ops_bound_ms(gplan, windows)
    print(f"kernel[general] B={B} S={S} k={K}: {gk:.5f} ms per launch; "
          f"bound {gb:.5f} ms by operations ({window_ops(gplan)} ALU, FMA "
          f"instructions a window); bound / time {gb / gk:.3f} [{card}]")
    # the deduper's default stream_rows: a launch of few rows, which the
    # launcher spreads over the card with shorter segments
    Bd = dedup.DedupConfig().stream_rows
    opsd = {"sig": {**ops["sig"], "init": ops["sig"]["init"][:Bd]}}
    kd = lambda: sketch_fused.sketch_plan_fused(x[:Bd], None, nw[:Bd], opsd,
                                                plan=plan, w_start=ws[:Bd])
    if not torch.equal(kd()["sig"], ref.sketch_plan_ref(
            plan, x[:Bd], None, nw[:Bd], opsd, w_start=ws[:Bd])["sig"]):
        raise AssertionError("kernel != plain version at the default shape")
    dms, _ = device_ms(torch, kd, 200)
    db = ops_bound_ms(plan, Bd * CHUNK_S)
    print(f"kernel[cyclic] default stream_rows B={Bd} S={S} k={K}: "
          f"{dms:.5f} ms per launch; bound {db:.5f} ms by operations; "
          f"bound / time {db / dms:.3f} [{card}]")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; total {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "sketch_plan_minhash",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sketch_plan.cu",
        "replaces": "src/repro/kernels/sketch_fused.py:379",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"launches: main path (cyclic add_batch) {launches}, general "
          f"add_batch {glaunches}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
