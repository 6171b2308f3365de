"""Synthetic corpora.

The paper benchmarks on the King James Bible (4.3 Mchar ASCII), which is not
shipped offline; `bench_corpus()` generates a reproducible 4.3-Mchar byte
stream whose unigram distribution matches English letter frequencies — the
hash families are data-independent in cost, so speed *ratios* (claim C8)
are preserved (DESIGN.md §7).

`documents()` generates token documents with a controlled duplication rate —
ground truth for the dedup pipeline tests and benchmarks.

A copy of the JAX package's ``repro/data/corpus.py`` (numpy only), kept so
the port depends on nothing of ``repro``; the same spec gives the same
documents in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

# English letter frequencies (a-z, space-heavy), from public tables.
_EN = {
    " ": 0.1828, "e": 0.1026, "t": 0.0751, "a": 0.0654, "o": 0.0616,
    "n": 0.0572, "i": 0.0558, "s": 0.0532, "r": 0.0499, "h": 0.0498,
    "l": 0.0331, "d": 0.0328, "u": 0.0228, "c": 0.0223, "m": 0.0203,
    "f": 0.0198, "w": 0.0170, "g": 0.0162, "p": 0.0150, "y": 0.0142,
    "b": 0.0126, "v": 0.0079, "k": 0.0056, "x": 0.0014, "j": 0.0010,
    "q": 0.0008, "z": 0.0005, ",": 0.0100, ".": 0.0090, "\n": 0.0043,
}


def bench_corpus(n_chars: int = 4_300_000, seed: int = 0) -> np.ndarray:
    """English-like byte stream, ~the size of the King James Bible."""
    rng = np.random.default_rng(seed)
    syms = np.frombuffer("".join(_EN).encode(), dtype=np.uint8)
    probs = np.asarray(list(_EN.values()))
    probs = probs / probs.sum()
    return rng.choice(syms, size=n_chars, p=probs).astype(np.int32)


def zipf_tokens(n: int, vocab: int, alpha: float = 1.1, seed: int = 0,
                rng=None) -> np.ndarray:
    """Zipf-distributed token ids (LM-like marginal statistics)."""
    rng = rng or np.random.default_rng(seed)
    ranks = rng.zipf(alpha, size=n).astype(np.int64)
    return ((ranks - 1) % vocab).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    n_docs: int = 1000
    doc_len: Tuple[int, int] = (128, 1024)   # min, max tokens
    vocab: int = 8192
    dup_rate: float = 0.2                    # fraction of docs that are near-dups
    mutate_frac: float = 0.02                # token flips applied to a dup
    seed: int = 0


def documents(spec: CorpusSpec) -> Tuple[List[np.ndarray], np.ndarray]:
    """Generate docs with known (near-)duplicates.

    Returns (docs, dup_of): dup_of[i] == -1 for originals, else the index of
    the source document that doc i near-duplicates.
    """
    rng = np.random.default_rng(spec.seed)
    docs: List[np.ndarray] = []
    dup_of = np.full(spec.n_docs, -1, dtype=np.int64)
    for i in range(spec.n_docs):
        if docs and rng.random() < spec.dup_rate:
            src = int(rng.integers(0, len(docs)))
            doc = docs[src].copy()
            flips = rng.random(doc.shape) < spec.mutate_frac
            doc[flips] = zipf_tokens(int(flips.sum()), spec.vocab, rng=rng)
            dup_of[i] = src
        else:
            n = int(rng.integers(spec.doc_len[0], spec.doc_len[1] + 1))
            doc = zipf_tokens(n, spec.vocab, rng=rng)
        docs.append(doc)
    return docs, dup_of
