"""The benchmark's one traffic generator: every mix under ``bench/traffic/``
is a JSON file of parameters that this module reads.

A frozen copy of ``src/repro_torch/data/corpus.py``'s ``documents()`` and
``zipf_tokens()`` (numpy only), extended for the benchmark:

* token ids are drawn from a Zipf law truncated to the vocabulary through an
  inverse-CDF table of 2^24 entries, so a block of any size is two
  vectorised calls (uniform integers, then a gather) instead of ``rng.zipf``
  a document at a time;
* document lengths follow a clipped log-normal law (``length``);
* a near-duplicate copies a source drawn uniformly from every earlier
  document of the stream and mutates a share of its tokens, the share drawn
  from a mixture of levels (``mutations``);
* token blocks of fixed shape (``kind: token_blocks``) for the corpus scan,
  with a fixed number of rows that carry copies of eval passages.

Kinds of mix:

``documents``  ``{"vocab", "zipf_alpha", "length": {"median", "sigma",
               "min", "max"}, "dup_share", "mutations": [[weight, frac],
               ...], "batch_docs"}``. Batch ``i`` is a pure function of the
               seed, ``i`` and the documents of batches ``0..i-1``, so a
               stream is the same however fast it is consumed, and no
               document is ever fed twice.
``token_blocks`` ``{"vocab", "zipf_alpha", "block": [T, B, C],
               "pool_blocks", "planted_row_share"}``: a pool of host blocks
               that a scan cycles through.

Run as a script, the module writes a ``documents`` stream to its standard
output for the harness (``python generate.py '<mix as JSON>' <seed>``): each
batch as a 16-byte header (number of documents, number of tokens, both
little-endian int64), the (docs + 1,) int64 offsets, then the int32 tokens.
It stops when the reader closes the pipe.
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

TABLE_BITS = 24

# streams of the seed that the parts of a run draw from, so that no two
# share random numbers
TAG_DOCS, TAG_WARM, TAG_POOL, TAG_EVAL = 1, 2, 3, 4


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A generator for one part of a run: the seed (any whole number >= 0)
    and the part's tags, through numpy's SeedSequence."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tags]))


def zipf_table(vocab: int, alpha: float, bits: int = TABLE_BITS) -> np.ndarray:
    """(2^bits,) int32 inverse-CDF table of Zipf(alpha) over ids 0..vocab-1
    (id i has weight (i + 1)^-alpha): entry u holds the id whose CDF
    interval holds (u + 0.5) / 2^bits."""
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -float(alpha)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    # the grid points (u + 0.5) / 2^bits at or below each CDF value
    ends = np.clip(np.floor(cdf * (1 << bits) + 0.5), 0, 1 << bits).astype(
        np.int64)
    ends[-1] = 1 << bits
    counts = np.diff(np.concatenate([[0], ends]))
    return np.repeat(np.arange(vocab, dtype=np.int32), counts)


def zipf_tokens(table: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` token ids drawn through ``zipf_table``'s table."""
    u = rng.integers(0, table.shape[0], size=n, dtype=np.uint32)
    return table[u]


def doc_lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` clipped log-normal document lengths (int64)."""
    raw = rng.lognormal(np.log(spec["median"]), spec["sigma"], size=n)
    return np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)


class DocumentStream:
    """The ``documents`` mix, batch by batch, with the stream's history."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.table = zipf_table(mix["vocab"], mix["zipf_alpha"])
        self.history: List[np.ndarray] = []
        self.batches = 0
        w = np.asarray([m[0] for m in mix["mutations"]], np.float64)
        self.levels = np.asarray([m[1] for m in mix["mutations"]], np.float64)
        self.level_p = w / w.sum()

    def next_batch(self) -> List[np.ndarray]:
        mix, D = self.mix, int(self.mix["batch_docs"])
        rng = rng_for(self.seed, TAG_DOCS, self.batches)
        base = len(self.history)
        dup = rng.random(D) < mix["dup_share"]
        if base == 0:
            dup[0] = False                      # nothing to copy yet
        lengths = doc_lengths(mix["length"], D, rng)
        fresh = zipf_tokens(self.table, int(lengths[~dup].sum()), rng)
        cuts = np.cumsum(lengths[~dup])[:-1]
        originals = iter(np.split(fresh, cuts))
        # sources, levels and replacement tokens are drawn for every document
        # alike, so the draws of a batch do not depend on which are copies
        src_u = rng.random(D)
        level = rng.choice(len(self.levels), size=D, p=self.level_p)
        docs: List[np.ndarray] = []
        for i in range(D):
            if not dup[i]:
                docs.append(next(originals))
                continue
            src = int(src_u[i] * (base + i))
            srcdoc = self.history[src] if src < base else docs[src - base]
            doc = srcdoc.copy()
            flips = rng.random(doc.shape[0]) < self.levels[level[i]]
            doc[flips] = zipf_tokens(self.table, int(flips.sum()), rng)
            docs.append(doc)
        self.history.extend(docs)
        self.batches += 1
        return docs


def warm_documents(seed: int, vocab: int, rows: int, chunk: int,
                   chunk_counts: Sequence[int]) -> List[np.ndarray]:
    """Documents for a warm-up that is not part of the traffic: ``rows``
    documents of ``c * chunk`` tokens for each ``c`` in ``chunk_counts``."""
    rng = rng_for(seed, TAG_WARM)
    return [rng.integers(0, vocab, size=c * chunk, dtype=np.int32)
            for c in chunk_counts for _ in range(rows)]


def eval_passages(seed: int, vocab: int, alpha: float, count: int,
                  length: int) -> np.ndarray:
    """(count, length) int32 eval passages of Zipf tokens."""
    rng = rng_for(seed, TAG_EVAL)
    return zipf_tokens(zipf_table(vocab, alpha), count * length,
                       rng).reshape(count, length)


def token_pool(mix: dict, seed: int,
               evals: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """The ``token_blocks`` mix: (P, T, B, C) int32 blocks and the (R,)
    planted rows. A planted row holds, in every block, a contiguous stretch
    of the concatenated eval passages ``evals``."""
    T, B, C = mix["block"]
    P = int(mix["pool_blocks"])
    rng = rng_for(seed, TAG_POOL)
    table = zipf_table(mix["vocab"], mix["zipf_alpha"])
    pool = zipf_tokens(table, P * T * B * C, rng).reshape(P, T, B, C)
    n_planted = int(round(mix["planted_row_share"] * B))
    planted = np.sort(rng.choice(B, size=n_planted, replace=False))
    if n_planted and evals is not None:
        flat = evals.reshape(-1)
        span = T * C
        if flat.shape[0] < span:
            raise ValueError(f"eval passages hold {flat.shape[0]} tokens, a "
                             f"planted row needs {span}")
        for p in range(P):
            for r in planted:
                s = int(rng.integers(0, flat.shape[0] - span + 1))
                pool[p, :, r, :] = flat[s : s + span].reshape(T, C)
    return pool, planted


def write_stream(mix: dict, seed: int, out) -> None:
    """Write batches of a ``documents`` mix to the binary stream ``out``
    until the reader goes away."""
    stream = DocumentStream(mix, seed)
    try:
        while True:
            docs = stream.next_batch()
            offsets = np.zeros(len(docs) + 1, np.int64)
            np.cumsum([d.shape[0] for d in docs], out=offsets[1:])
            tokens = np.concatenate(docs).astype(np.int32, copy=False)
            out.write(np.asarray([len(docs), tokens.shape[0]],
                                 np.int64).tobytes())
            out.write(offsets.tobytes())
            out.write(tokens.tobytes())
            out.flush()
    except (BrokenPipeError, OSError):
        pass


def read_batch(inp) -> Optional[List[np.ndarray]]:
    """One batch of :func:`write_stream`'s format from ``inp``, or None at
    the end of the stream."""
    head = inp.read(16)
    if len(head) < 16:
        return None
    D, N = (int(v) for v in np.frombuffer(head, np.int64))
    offsets, tokens = inp.read(8 * (D + 1)), inp.read(4 * N)
    if len(offsets) < 8 * (D + 1) or len(tokens) < 4 * N:
        return None                     # the writer went away mid-batch
    offsets = np.frombuffer(offsets, np.int64)
    tokens = np.frombuffer(tokens, np.int32)
    return [tokens[offsets[i]:offsets[i + 1]] for i in range(D)]


if __name__ == "__main__":
    write_stream(json.loads(sys.argv[1]), int(sys.argv[2]), sys.stdout.buffer)
