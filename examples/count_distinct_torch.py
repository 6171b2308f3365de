"""The paper's section 2 motivation at corpus scale, on the port: estimate
the number of DISTINCT 15-grams in a 4.3-Mchar corpus with 16 KB of state
(``examples/count_distinct.py`` through ``repro_torch``).

At n = 15 a 32-bit CYCLIC hash keeps only 18 pairwise-independent bits
(Theorem 1 costs n - 1), too few for ~4M distinct values; two independent
CYCLIC draws give the register index (one) and the trailing-zero rank (the
other), jointly pairwise independent. On a card both draws run the fused
lookup + rolling-hash kernel (``ops.cyclic_fused``) and the registers the
HLL kernel (``kernels.hll.hll_update``); ``--device cpu`` runs their plain
versions.

Run: PYTHONPATH=src python examples/count_distinct_torch.py [--device cpu]
       [--chars N]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import HyperLogLog, make_family
from repro_torch.data.corpus import bench_corpus
from repro_torch.kernels import hll as hll_kernel
from repro_torch.kernels import ops

N, B = 15, 12


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--chars", type=int, default=4_300_000)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (pass "
                         "--device cpu to run on the CPU)")
    dev = torch.device(args.device)
    corpus = bench_corpus(args.chars)
    print(f"corpus: {len(corpus):,} chars; counting distinct {N}-grams on "
          f"{dev}")

    fam = make_family("cyclic", n=N, L=32)
    ta = fam.init(torch.Generator().manual_seed(0), 256, dev)["h1"]
    tb = fam.init(torch.Generator().manual_seed(1), 256, dev)["h1"]
    hll = HyperLogLog(b=B)
    t0 = time.perf_counter()
    chars = torch.from_numpy(corpus[None].astype(np.int32)).to(dev)
    h_idx = fam.pairwise_bits(ops.cyclic_fused(chars, ta, n=N))[0]
    h_rank = fam.pairwise_bits(ops.cyclic_fused(chars, tb, n=N))[0]
    # one word a window: the rank draw's 18 bits above the index's 12, so
    # the HLL kernel's index is h_idx's low bits and its rank h_rank's
    words = (h_rank.to(torch.int64) << B) | (h_idx.to(torch.int64)
                                             & ((1 << B) - 1))
    regs = hll_kernel.hll_update(words.to(torch.uint32), b=B,
                                 rank_bits=fam.out_bits)
    est = float(hll.estimate(regs))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_hash = time.perf_counter() - t0
    split = hll.update_split(hll.init(dev), h_idx, h_rank,
                             rank_bits=fam.out_bits)
    assert torch.equal(regs, split)     # the packed words are update_split
    print(f"HLL estimate: {est:,.0f} distinct {N}-grams ({t_hash:.2f}s, "
          f"{len(corpus) / t_hash / 1e6:.1f} Mchar/s, {hll.m * 4} bytes of "
          f"state)")

    t0 = time.perf_counter()
    wins = np.lib.stride_tricks.sliding_window_view(
        np.asarray(corpus, np.uint8), N)
    truth = len({w.tobytes() for w in wins})
    t_exact = time.perf_counter() - t0
    print(f"exact count:  {truth:,} ({t_exact:.2f}s, "
          f"{truth * N / 1e6:.0f} MB of set keys)")
    err = abs(est - truth) / truth
    print(f"relative error: {err:.2%}")
    assert err < 0.1
    print("OK")


if __name__ == "__main__":
    main()
