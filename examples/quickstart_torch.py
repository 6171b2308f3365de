"""Quickstart of the PyTorch/CUDA port: the paper's hash families in a
minute (``examples/quickstart.py`` through ``repro_torch``).

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
       [--chars N]
On a card (the default) the plan and the sharded plan run the CUDA
kernels; ``--device cpu`` runs their plain versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import CountMinSketch, HyperLogLog, MinHash, make_family
from repro_torch.core import independence as ind
from repro_torch.kernels import api, shard
from repro_torch.kernels.plan import (CountMinSpec, HashSpec, HLLSpec,
                                      MinHashSpec, SketchPlan)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--chars", type=int, default=200_000,
                    help="length of the random byte stream of sections 3-4")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (pass "
                         "--device cpu to run on the CPU)")
    dev = torch.device(args.device)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    text = b"recursive n-gram hashing is pairwise independent, at best"
    tokens = torch.from_numpy(np.frombuffer(text, dtype=np.uint8).astype(
        np.int64)).to(dev)
    n = 5

    print("=== 1. One family, three identical evaluation forms ===")
    fam = make_family("cyclic", n=n, L=32)
    params = fam.init(gen(0), 256, dev)
    direct = fam.hash_windows_direct(params, tokens)
    stream = fam.hash_stream(params, tokens)      # paper Algorithm 4
    parallel = fam.hash_windows(params, tokens)   # prefix-XOR form
    assert torch.equal(direct, stream) and torch.equal(direct, parallel)
    print(f"hashed {len(text)} chars -> {direct.shape[0]} {n}-gram "
          f"fingerprints on {dev}")
    print("first 4:", [hex(int(h)) for h in direct[:4]])

    print("\n=== 2. The paper's theorems, exactly (enumeration, small L) ===")
    g2 = make_family("general", n=2, L=4)
    print("GENERAL pairwise independent:",
          ind.is_kwise_independent(g2, [[0, 0], [1, 1]], sigma=2))
    print("GENERAL 3-wise (Prop 1 says impossible):",
          ind.is_kwise_independent(g2, [[0, 0], [0, 1], [1, 1]], sigma=2))
    cyc = make_family("cyclic", n=2, L=4)
    print("CYCLIC uniform on raw bits (Lemma 3 says no):",
          ind.is_uniform(cyc, [0, 0], sigma=1))
    print("CYCLIC pairwise after dropping n-1 bits (Thm 1):",
          ind.is_kwise_independent(cyc, [[0, 0], [1, 1]], sigma=2,
                                   transform=cyc.pairwise_bits,
                                   bits=cyc.out_bits))

    print("\n=== 3. Count distinct n-grams without storing them ===")
    rng = np.random.default_rng(0)
    big_np = rng.integers(0, 256, size=args.chars)
    big = torch.from_numpy(big_np).to(dev)
    fam8 = make_family("cyclic", n=8, L=32)
    p8 = fam8.init(gen(1), 256, dev)
    hashes = fam8.pairwise_bits(fam8.hash_windows(p8, big))
    hll = HyperLogLog(b=10, hash_bits=fam8.out_bits)
    est = float(hll.estimate(hll.update(hll.init(dev), hashes)))
    wins = np.lib.stride_tricks.sliding_window_view(big_np.astype(np.uint8),
                                                    8)
    truth = len({w.tobytes() for w in wins})
    err = abs(est - truth) / truth
    print(f"HLL estimate: {est:,.0f}   exact: {truth:,}   error: {err:.2%}  "
          f"(4 KB of state vs {truth * 8 / 1e6:.1f} MB)")
    assert err < 0.1

    print("\n=== 4. The data plane: one pass, every sketch ===")
    mh = MinHash(k=16)
    mhp = mh.init(gen(2), dev)
    cms = CountMinSketch(depth=4, log2_width=12)
    cmsp = cms.init(gen(3), dev)
    plan = SketchPlan(hash=HashSpec(family="cyclic", n=8, L=32),
                      sketches={"sig": MinHashSpec(k=16),
                                "card": HLLSpec(b=10),
                                "freq": CountMinSpec(depth=4,
                                                     log2_width=12)})
    ops = {"sig": {"a": mhp["a"], "b": mhp["b"]},
           "freq": {"a": cmsp["a"], "b": cmsp["b"]}}
    out = api.run(plan, fam8._lookup(p8, big[None, :]), operands=ops)
    est_plan = float(hll.estimate(out["card"]))
    print(f"plan {plan.hash.family}/n={plan.hash.n}: MinHash sig "
          f"{tuple(out['sig'].shape)}, HLL estimate {est_plan:,.0f}, CMS "
          f"heaviest cell {int(out['freq'].max())}: one fused pass for all "
          f"three")
    assert est_plan == est                 # the same registers as section 3
    gfam = make_family("general", n=8, L=32)
    gplan = SketchPlan(hash=HashSpec(family="general", n=8, L=32),
                       sketches={"sig": MinHashSpec(k=16)})
    gout = api.run(gplan, gfam._lookup(gfam.init(gen(4), 256, dev),
                                       big[None, :]),
                   operands={"sig": ops["sig"]})
    print(f"same plan, GENERAL family (p={hex(gplan.hash.p)}): sig "
          f"{tuple(gout['sig'].shape)}: swap the family, keep the pipeline")

    print("\n=== 5. Scaling out: the same plan over a data mesh ===")
    # four row shards of the one device (virtual shards); HLL registers
    # merge by max, CountMin tables by sum, ragged rows are padded with
    # n_windows = 0: the outputs equal the one-device ones bit for bit
    mesh = shard.DataMesh((dev,) * 4)
    docs = torch.from_numpy(rng.integers(0, 256, size=(5, 4096))).to(dev)
    sharded = shard.run_sharded(plan, fam8._lookup(p8, docs), operands=ops,
                                mesh=mesh)
    single = api.run(plan, fam8._lookup(p8, docs), operands=ops)
    for k in ("sig", "card", "freq"):
        assert torch.equal(sharded[k], single[k])
    print(f"{mesh.size} shards, batch of {docs.shape[0]}: sharded "
          f"sig/registers/counts bit-identical to api.run")
    print("OK")


if __name__ == "__main__":
    main()
