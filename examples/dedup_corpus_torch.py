"""Near-duplicate detection over a corpus with planted duplicates, on the
port: MinHash over pairwise-independent CYCLIC fingerprints (Theorem-1
bits), ``examples/dedup_corpus.py`` through ``repro_torch``. On a card the
signatures come from the fused plan kernel; ``--device cpu`` runs its
plain version.

Run: PYTHONPATH=src python examples/dedup_corpus_torch.py [--device cpu]
       [--docs N]
"""
import argparse
import time

import torch

from repro_torch.data.corpus import CorpusSpec, documents
from repro_torch.data.dedup import DedupConfig, MinHashDeduper


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--docs", type=int, default=500)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (pass "
                         "--device cpu to run on the CPU)")
    spec = CorpusSpec(n_docs=args.docs, dup_rate=0.25, mutate_frac=0.015,
                      seed=42, vocab=8192)
    docs, dup_of = documents(spec)
    truth = dup_of >= 0
    print(f"{len(docs)} documents, {truth.sum()} planted near-duplicates "
          f"(~{spec.mutate_frac:.1%} token mutations each)")

    dd = MinHashDeduper(DedupConfig(vocab=8192, threshold=0.5, ngram_n=8,
                                    device=args.device))
    t0 = time.perf_counter()
    # the batched data plane: fused signing in fixed stream tiles, then the
    # band-sharded LSH probe (the same verdicts as one document at a time)
    flagged = dd.add_batch(docs)
    dt = time.perf_counter() - t0

    tp = (flagged & truth).sum()
    fp = (flagged & ~truth).sum()
    fn = (~flagged & truth).sum()
    tokens = sum(len(d) for d in docs)
    print(f"flagged {flagged.sum()} docs in {dt:.2f}s "
          f"({tokens / dt / 1e3:.0f} ktok/s, first call included) on "
          f"{args.device}")
    print(f"recall {tp / truth.sum():.1%}  precision "
          f"{tp / max(tp + fp, 1):.1%}  missed {fn}")
    assert tp / truth.sum() > 0.9 and tp / max(tp + fp, 1) > 0.9
    print("OK")


if __name__ == "__main__":
    main()
