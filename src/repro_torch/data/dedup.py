"""Hash-based near-duplicate detection — the paper's families in production.

Per document: rolling CYCLIC (or GENERAL) hashes of every n-gram, with the
Theorem-1 discard, feed a MinHash signature; Jaccard over signatures >=
``threshold`` flags a near-duplicate. Pairwise independence of the window
hashes is what makes the MinHash collision estimator unbiased.

Signing is streamed and fused: a one-MinHash :class:`SketchPlan` is built
once, and rows advance ``stream_rows`` at a time through fixed
``(stream_block_chunks, stream_rows, stream_chunk_s)`` chunk blocks
(:mod:`repro_torch.kernels.stream`). A row is a document, or a segment of
one: a window hash depends only on its n symbols and a MinHash lane is a
minimum over windows, so a document longer than one block
(``stream_block_chunks x stream_chunk_s`` symbols) may be cut into
segments of at most one block, each after the first opening with the n-1
symbols before it as history (a fresh row's first n-1 symbols make no
window), and its signature is the lane-wise minimum of its segments'
signatures (:func:`_segment_docs`). A call takes that layout only when it
issues fewer chunk launches than one row a document (:func:`_chunk_launches`
counts both from the lengths), so a group no longer advances until its
longest document ends. The host tiles a block (:func:`_tile_blocks`) in a
few NumPy copies, not row by row: one clip gives every block's lengths for
the group, and each row that still has tokens copies its whole chunks as
one reshape and its tail in one more. On CUDA every chunk is one launch of
the plan kernel, which hashes, discards, remixes and takes the minima in
one pass; the next block's copy to the card overlaps the current block's
kernels, and the signatures of every group come back in one read at the
end of the call. Masked windows are excluded from the min outright, so
signatures do not depend on chunking or on the layout.

The LSH index (:class:`BandShardedLSHIndex`) partitions the band->key map by
band id; candidate pairs are Jaccard-verified sequentially in document
order, so :meth:`MinHashDeduper.add_batch` reproduces the streaming
per-document path (:meth:`MinHashDeduper.check_and_add`) exactly.
:func:`candidate_count` counts the candidates the probes return and
:func:`segment_count` the rows signing signs; a profiler that records sees
``add_batch``'s spans ``dedup.sign`` (with ``dedup.tile`` for each block's
host tiling and ``dedup.drain`` for the signatures' one read-back),
``dedup.probe`` and ``dedup.verify`` (:mod:`repro_torch.trace`).

The families outside the fused engine (THREEWISE, ID37) sign through the
bucketed path (:meth:`MinHashDeduper._signature_many_bucketed`): documents
grouped by power-of-two length bucket, the family's window hashes
materialised and folded by the plain masked-min reduction, as the JAX
package does. BUFFERED-GENERAL gives GENERAL's bits and signs on its plan.
:meth:`MinHashDeduper.signature_unfused`, :func:`signature_batch` (the
unfused parity oracles) and :func:`exact_duplicate_mask` (a k=4 MinHash
plan: one plan launch on CUDA) complete the module.

Multi-device signing: with ``mesh`` (a
:class:`~repro_torch.kernels.shard.DataMesh`) or ``DedupConfig.data_shards``
each group's stream carry is row-sharded over the mesh
(:mod:`repro_torch.kernels.stream`); ``stream_rows`` is then a per-shard
tile budget, so a group holds up to ``stream_rows`` x d rows.
Signatures are per row, so they do not depend on the shard count.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import Cyclic, General, MinHash, make_family, u32
from repro_torch.kernels import api, shard, stream
from repro_torch.kernels import ref as kref
from repro_torch.kernels.plan import HashSpec, MinHashSpec, SketchPlan


# LSH candidates returned by probe_batch: the sum over documents of both
# candidate sets' sizes. Context-local and monotonic, as the streaming
# executor's dispatch count
_candidates = trace.Counter("repro_torch.data.dedup._candidates")


def candidate_count() -> int:
    """LSH candidates (index and batch, a document each) that
    :meth:`BandShardedLSHIndex.probe_batch` returned in this context."""
    return _candidates.get()


# rows the streamed signing path signed: one a document, or its segments
_segments = trace.Counter("repro_torch.data.dedup._segments")


def segment_count() -> int:
    """Rows :meth:`MinHashDeduper.signature_many` signed through the
    streaming executor in this context: one a document of at most one
    block, or a longer document's segments where the segmented layout was
    taken."""
    return _segments.get()


def _plan_for_family(fam, k: int) -> Optional[SketchPlan]:
    """One-MinHash SketchPlan for a fused-capable family, else None."""
    if isinstance(fam, Cyclic):
        hs = HashSpec(family="cyclic", n=fam.n, L=fam.L, discard=True)
    elif isinstance(fam, General):
        hs = HashSpec(family="general", n=fam.n, L=fam.L, p=fam.p)
    else:
        return None
    return SketchPlan(hs, (("sig", MinHashSpec(k=k)),))


@dataclasses.dataclass
class DedupConfig:
    ngram_n: int = 8
    L: int = 32
    n_signatures: int = 64
    lsh_bands: int = 16          # bands x rows = n_signatures
    threshold: float = 0.7
    family: str = "cyclic"
    vocab: int = 1 << 17
    seed: int = 0
    impl: str = "auto"           # kernel dispatch: auto | kernel | ref
    # sign over a data mesh of this many shards (None = one device)
    data_shards: Optional[int] = None
    # probe the band-sharded LSH index on a thread pool of this many workers
    # (0/1 = in-line; band shards are independent either way)
    lsh_workers: int = 0
    # chunked streaming signing: documents advance through fixed
    # (stream_rows, stream_chunk_s) tiles, stream_block_chunks to a block
    stream_rows: int = 64
    stream_chunk_s: int = 512
    stream_block_chunks: int = 8
    device: str = "cuda"


def _block_sizes(n_symbols: int, Cs: int, T0: int) -> List[int]:
    """Chunks of each block a group whose longest row holds ``n_symbols``
    runs: full ``T0``-chunk blocks, then one pow2-sized tail block (at least
    one chunk, so an empty group still runs one block)."""
    n_chunks = max(1, -(-n_symbols // Cs))
    sizes = [T0] * (n_chunks // T0)
    if n_chunks % T0:
        sizes.append(1 << int(np.ceil(np.log2(n_chunks % T0))))
    return sizes


def _tile_blocks(group: Sequence[np.ndarray], Bt: int, Cs: int, T0: int):
    """One signing group's token blocks: yields ``(toks, lengths)``, a
    ``(T, Bt, Cs)`` int32 block and its ``(T, Bt)`` int32 real-symbol
    counts, over full ``T0``-chunk blocks and then one pow2-sized tail
    block. Row r of chunk c holds tokens ``[c * Cs, (c + 1) * Cs)`` of
    ``group[r]``, zero-padded; rows past the group and chunks past a
    document are 0-length. Each block is filled under the span
    ``dedup.tile``, a live row's segment in at most two copies (its whole
    chunks, then its tail), and only one block is held at a time."""
    lens = np.fromiter(map(len, group), np.int64, len(group))
    sizes = _block_sizes(int(lens.max(initial=0)), Cs, T0)
    lo = np.arange(sum(sizes), dtype=np.int64) * Cs
    lengths = np.zeros((len(lo), Bt), np.int32)
    lengths[:, : len(group)] = np.clip(lens[None, :] - lo[:, None], 0, Cs)
    done = 0
    for T in sizes:
        with trace.span("dedup.tile"):
            start = done * Cs
            toks = np.zeros((T, Bt, Cs), np.int32)
            for r in np.flatnonzero(lens > start):
                seg = group[r][start : start + T * Cs]
                k, rest = divmod(len(seg), Cs)
                toks[:k, r] = seg[: k * Cs].reshape(k, Cs)
                if rest:
                    toks[k, r, :rest] = seg[k * Cs :]
        yield toks, lengths[done : done + T]
        done += T


def _chunk_launches(lens: np.ndarray, Bt: int, Cs: int, T0: int) -> int:
    """Chunk launches of signing rows of ``lens`` symbols (in descending
    order) ``Bt`` at a time: the blocks :func:`_block_sizes` gives each
    group's longest row, as :func:`_tile_blocks` lays them out."""
    return sum(sum(_block_sizes(int(x), Cs, T0)) for x in lens[::Bt])


def _segment_docs(docs: Sequence[np.ndarray], lens: np.ndarray, span: int,
                  h: int):
    """Documents of ``lens`` symbols -> ``(rows, row_lens, starts)``: each
    document's segments in document order, their lengths, and the index of
    each document's first. A document of at most ``span`` symbols is one
    segment; a longer one's j-th is the view
    ``doc[j * (span - h) : j * (span - h) + span]``, cut at its end, for as
    long as it holds a symbol past its first ``h``. With ``h = n - 1`` the
    windows ending in a later segment's first ``h`` symbols are its
    history, which the stream masks, so every window of a document falls
    in exactly one of its segments."""
    step = span - h
    counts = np.maximum(1, -(-(lens - h) // step))
    rows: List[np.ndarray] = []
    row_lens: List[int] = []
    for doc, N, k in zip(docs, lens.tolist(), counts.tolist()):
        if k == 1:
            rows.append(doc)
            row_lens.append(N)
        else:
            rows.extend(doc[j * step : j * step + span] for j in range(k))
            row_lens.extend([span] * (k - 1) + [N - (k - 1) * step])
    starts = np.zeros(len(docs), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    return rows, np.asarray(row_lens, np.int64), starts


def _bucket(n: int) -> int:
    """Next power-of-two length >= n (the bucketed path's shapes)."""
    return 1 << int(np.ceil(np.log2(max(n, 2))))


def pack_band(shard: Dict[bytes, List[int]]) -> Dict[str, np.ndarray]:
    """One LSH band shard -> a flat tree of arrays (checkpointable).

    Keys and id lists are variable-length, so both are stored flattened
    with offset vectors; insertion order is preserved exactly, which is
    what makes a packed->unpacked index behave bit-identically.
    """
    keys = list(shard.keys())
    key_off = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(k) for k in keys], out=key_off[1:])
    ids = [shard[k] for k in keys]
    id_off = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(v) for v in ids], out=id_off[1:])
    return {
        "key_bytes": (np.frombuffer(b"".join(keys), np.uint8)
                      if keys else np.zeros((0,), np.uint8)),
        "key_offsets": key_off,
        "ids": (np.concatenate([np.asarray(v, np.int64) for v in ids])
                if keys else np.zeros((0,), np.int64)),
        "id_offsets": id_off,
    }


def unpack_band(tree) -> Dict[bytes, List[int]]:
    """Inverse of :func:`pack_band` (order-preserving)."""
    kb = np.asarray(tree["key_bytes"], np.uint8).tobytes()
    ko = np.asarray(tree["key_offsets"], np.int64)
    ids = np.asarray(tree["ids"], np.int64)
    io = np.asarray(tree["id_offsets"], np.int64)
    return {kb[ko[i]:ko[i + 1]]: [int(x) for x in ids[io[i]:io[i + 1]]]
            for i in range(len(ko) - 1)}


def _fold_candidates(per_band, D: int) -> Tuple[List[set], List[set]]:
    """Every band's group-by (:meth:`BandShardedLSHIndex._probe_shard`) ->
    per-doc candidate sets ``(index_cand, batch_cand)``."""
    index_cand: List[set] = [set() for _ in range(D)]
    batch_cand: List[set] = [set() for _ in range(D)]
    for groups in per_band:
        for members, hit in groups:
            for pos, i in enumerate(members):
                if hit:
                    index_cand[i].update(hit)
                if pos:
                    batch_cand[i].update(members[:pos].tolist())
    return index_cand, batch_cand


class BandShardedLSHIndex:
    """The LSH band->key map, partitioned by band id.

    Each band owns an independent ``{band_key: [doc_id, ...]}`` shard, so a
    probe (or insert) decomposes into ``n_bands`` disjoint lookups that can
    run concurrently. Shard results are combined into per-document
    candidate *sets* before any Jaccard verification, and the verify loop
    stays sequential in document order, so first-wins semantics hold
    whatever the schedule.
    """

    # below this many batch rows a pooled probe loses to its own task
    # handoffs (each shard's np.unique group-by is microseconds)
    _POOL_MIN_ROWS = 64

    def __init__(self, n_bands: int, workers: int = 0):
        self.n_bands = n_bands
        self.workers = workers
        # one pool for the index's lifetime, created lazily on the first
        # pooled probe; close() releases it
        self._pool: Optional[ThreadPoolExecutor] = None
        self.shards: List[Dict[bytes, List[int]]] = [
            {} for _ in range(n_bands)]

    def close(self) -> None:
        """Release the probe thread pool (the index stays usable). Idempotent."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __enter__(self) -> "BandShardedLSHIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def insert(self, doc_id: int, keys: Sequence[bytes]) -> None:
        """Register a kept document under its band keys (one per shard)."""
        for shard_b, kb in zip(self.shards, keys):
            shard_b.setdefault(kb, []).append(doc_id)

    def pack(self) -> Dict[str, Dict[str, np.ndarray]]:
        """All band shards as a checkpointable tree of arrays."""
        return {f"band_{b:04d}": pack_band(s)
                for b, s in enumerate(self.shards)}

    @classmethod
    def unpack(cls, tree, workers: int = 0) -> "BandShardedLSHIndex":
        """Rebuild an index from :meth:`pack`'s tree."""
        idx = cls(len(tree), workers=workers)
        idx.shards = [unpack_band(tree[f"band_{b:04d}"])
                      for b in range(len(tree))]
        return idx

    def probe(self, keys: Sequence[bytes]) -> set:
        """Union of the doc ids colliding with ``keys`` in any band."""
        out: set = set()
        for shard_b, kb in zip(self.shards, keys):
            out.update(shard_b.get(kb, ()))
        return out

    def _probe_shard(self, b: int, col: np.ndarray):
        """One band shard's group-by: (D,) void keys -> [(members, hits)]:
        batch positions sharing a band key (ascending) and the index doc ids
        already stored under that key. The service's workers probe their
        bands with it too."""
        shard_b = self.shards[b]
        uniq, inv = np.unique(col, return_inverse=True)
        hits = [shard_b.get(u.tobytes()) for u in uniq]
        order = np.argsort(inv, kind="stable")
        sorted_inv = inv[order]
        starts = np.flatnonzero(
            np.r_[True, sorted_inv[1:] != sorted_inv[:-1]])
        ends = np.r_[starts[1:], len(order)]
        return [(order[s:e], hits[sorted_inv[s]])
                for s, e in zip(starts, ends)]

    def probe_batch(self, kb: np.ndarray) -> Tuple[List[set], List[set]]:
        """(D, n_bands) void band keys -> per-doc candidate sets
        ``(index_cand, batch_cand)``: doc ids already in the index whose
        band keys collide with doc i, and earlier batch positions colliding
        with doc i."""
        D = kb.shape[0]
        cols = [np.ascontiguousarray(kb[:, b]) for b in range(self.n_bands)]
        if self.workers > 1 and D >= self._POOL_MIN_ROWS:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.workers)
            per_band = list(self._pool.map(self._probe_shard,
                                           range(self.n_bands), cols))
        else:
            per_band = [self._probe_shard(b, col)
                        for b, col in enumerate(cols)]
        index_cand, batch_cand = _fold_candidates(per_band, D)
        _candidates.add(sum(map(len, index_cand))
                        + sum(map(len, batch_cand)))
        return index_cand, batch_cand


class MinHashDeduper:
    """Near-dedup with a band-sharded LSH index; streamed, fused signing on
    ``cfg.device``, or over ``mesh`` (an explicit mesh wins over
    ``cfg.data_shards``)."""

    def __init__(self, cfg: DedupConfig, mesh=None):
        if cfg.n_signatures % cfg.lsh_bands:
            raise ValueError(f"n_signatures={cfg.n_signatures} is not a "
                             f"multiple of lsh_bands={cfg.lsh_bands}")
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.mesh = shard.resolve(mesh, cfg.data_shards, self.device)
        self.rows = cfg.n_signatures // cfg.lsh_bands
        gen = torch.Generator().manual_seed(cfg.seed)
        self.fam = make_family(cfg.family, n=cfg.ngram_n, L=cfg.L)
        self.fam_params = self.fam.init(gen, cfg.vocab, self.device)
        self.mh = MinHash(k=cfg.n_signatures)
        self.mh_params = self.mh.init(gen, self.device)
        # None for the families the fused engine does not cover
        self.plan = _plan_for_family(self.fam, cfg.n_signatures)
        self._index = BandShardedLSHIndex(cfg.lsh_bands,
                                          workers=cfg.lsh_workers)
        self._sigs: List[np.ndarray] = []

    def close(self) -> None:
        """Release the index's probe thread pool. Idempotent."""
        self._index.close()

    def __enter__(self) -> "MinHashDeduper":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- durability ---------------------------------------------------------

    def export_state(self) -> Dict:
        """Everything a restart needs to continue bit-identically: the
        sampled hash parameters (h1 table + MinHash remix lanes), the
        signature store and the packed band index, as host numpy arrays."""
        sigs = (np.stack([np.asarray(s, np.uint32) for s in self._sigs])
                if self._sigs
                else np.zeros((0, self.cfg.n_signatures), np.uint32))
        host = lambda tree: {k: v.cpu().numpy() for k, v in tree.items()}
        return {"params": {"fam": host(self.fam_params),
                           "mh": host(self.mh_params)},
                "sigs": sigs,
                "index": self._index.pack()}

    def import_params(self, params: Dict) -> None:
        """Re-bind the sampled hash parameters (BEFORE any state import):
        ``{"fam": {"h1": (vocab,)}, "mh": {"a": (k,), "b": (k,)}}`` as
        tensors (:func:`repro_torch.convert.params_from_jax`) or arrays."""
        self.fam_params = {k: api.as_u32(v, self.device).contiguous()
                           for k, v in params["fam"].items()}
        self.mh_params = {k: api.as_u32(v, self.device).contiguous()
                          for k, v in params["mh"].items()}

    def import_state(self, tree: Dict) -> None:
        """Restore from :meth:`export_state`'s tree: params first, then the
        signature store and band index (insertion order preserved)."""
        self.import_params(tree["params"])
        sigs = np.asarray(tree["sigs"], np.uint32)
        if sigs.ndim != 2 or sigs.shape[1] != self.cfg.n_signatures:
            raise ValueError(f"sigs shape {sigs.shape} != (D, "
                             f"{self.cfg.n_signatures})")
        self._sigs = [sigs[i] for i in range(sigs.shape[0])]
        if len(tree["index"]) != self.cfg.lsh_bands:
            raise ValueError(f"index has {len(tree['index'])} bands, config "
                             f"expects {self.cfg.lsh_bands}")
        self._index.close()
        self._index = BandShardedLSHIndex.unpack(tree["index"],
                                                 workers=self.cfg.lsh_workers)

    # -- signing ------------------------------------------------------------

    def signature_many(self, docs: Sequence[np.ndarray]) -> np.ndarray:
        """Sign a whole document list: (D, k) uint32 through the streaming
        executor.

        Rows are documents or segments of them (the module docstring): a
        document longer than one block (``stream_block_chunks`` x
        ``stream_chunk_s`` symbols) signs as segments of at most one block,
        min-merged into its signature, when that issues fewer chunk
        launches than one row a document, counted from the lengths alone.
        Rows are grouped ``stream_rows`` at a time by descending length
        (signatures are per row, so packing similar lengths together only
        cuts masked work); each group advances through ``(T, stream_rows,
        stream_chunk_s)`` token blocks — full ``stream_block_chunks``-chunk
        blocks plus one pow2-sized tail block. A block's tokens go to the
        card through pinned memory and are mapped through h1 there; a row
        that runs out of symbols submits 0-length chunks, and a document
        shorter than the n-gram window signs to the sentinel signature.
        Every group's signatures stay on the card until one read-back at
        the end of the call. A family without a fused plan signs through
        :meth:`_signature_many_bucketed`. Under a mesh of d shards a group
        holds up to ``stream_rows`` x d rows (a power of two times
        ``stream_rows``, at most what the rows fill).
        """
        with trace.span("dedup.sign"):
            if self.plan is None:
                return self._signature_many_bucketed(docs)
            return self._signature_many_streamed(docs)

    def _group_rows(self, R: int) -> int:
        """Rows a signing group of ``R`` rows to sign holds: ``stream_rows``,
        times a power of two up to the mesh's shards where the rows fill
        them."""
        Bt = self.cfg.stream_rows
        d = self.mesh.size if self.mesh is not None else 1
        if d > 1 and R >= 2 * Bt:
            Bt *= 1 << int(np.log2(min(d, R // Bt)))
        return Bt

    def _signature_many_streamed(self, docs: Sequence[np.ndarray]
                                 ) -> np.ndarray:
        """:meth:`signature_many` through the streaming executor."""
        cfg = self.cfg
        if not len(docs):
            return np.empty((0, cfg.n_signatures), np.uint32)
        docs = [np.asarray(d) for d in docs]
        Cs, T0 = cfg.stream_chunk_s, max(1, cfg.stream_block_chunks)
        span, h = T0 * Cs, self.plan.hash.n - 1
        rows, starts = docs, None
        lens = np.fromiter(map(len, docs), np.int64, len(docs))
        order = np.argsort(-lens, kind="stable")
        Bt = self._group_rows(len(rows))
        if span > h and lens.max(initial=0) > span:
            seg_rows, seg_lens, seg_starts = _segment_docs(docs, lens, span,
                                                           h)
            seg_order = np.argsort(-seg_lens, kind="stable")
            seg_Bt = self._group_rows(len(seg_rows))
            if (_chunk_launches(seg_lens[seg_order], seg_Bt, Cs, T0)
                    < _chunk_launches(lens[order], Bt, Cs, T0)):
                rows, starts, order, Bt = (seg_rows, seg_starts, seg_order,
                                           seg_Bt)
        _segments.add(len(rows))
        operands = {"sig": {"a": self.mh_params["a"],
                            "b": self.mh_params["b"]}}
        sigs = []
        for g in range(0, len(rows), Bt):
            group = [rows[i] for i in order[g : g + Bt]]

            def blocks():
                for toks, lengths in _tile_blocks(group, Bt, Cs, T0):
                    # the copy and the h1 lookup are queued asynchronously
                    # behind the kernels of the block before
                    dev_toks = stream.stage(toks, self.device)
                    yield self.fam._lookup(self.fam_params, dev_toks), lengths

            state = stream.init_state(self.plan, Bt, device=self.device,
                                      mesh=self.mesh)
            state = stream.feed(self.plan, blocks(), state,
                                operands=operands, impl=cfg.impl)
            # kept on the card: the next group's host work overlaps this
            # one's kernels until the one read-back below
            sigs.append(stream.finalize(self.plan, state,
                                        batch=len(group))["sig"])
        with trace.span("dedup.drain"):
            got = torch.cat([s.view(torch.int32) for s in sigs]).cpu()
        out = np.empty((len(rows), cfg.n_signatures), np.uint32)
        out[order] = got.numpy().view(np.uint32)
        if starts is None:
            return out
        return np.minimum.reduceat(out, starts, axis=0)

    def _signature_batch(self, tokens: torch.Tensor,
                         n_windows: torch.Tensor) -> torch.Tensor:
        """(D, S) bucket-padded tokens + (D,) valid-window counts -> (D, k)
        uint32: the family's window hashes through the plain masked-min
        reduction."""
        h = self.fam.hash_windows_batched(self.fam_params, tokens)
        if hasattr(self.fam, "pairwise_bits"):
            h = self.fam.pairwise_bits(h)
        h = u32.lanes(h)
        idx = torch.arange(h.shape[-1], device=h.device)
        valid = idx[None, :] < n_windows.to(torch.int64)[:, None]
        return kref.minhash_reduce(h, valid, self.mh_params["a"],
                                   self.mh_params["b"]).to(torch.uint32)

    def _signature_many_bucketed(self, docs: Sequence[np.ndarray]) -> np.ndarray:
        """Signing by (length bucket, row bucket) shape: one call of
        :meth:`_signature_batch` per shape. The path of the families
        without a fused plan."""
        D = len(docs)
        out = np.empty((D, self.cfg.n_signatures), np.uint32)
        groups: Dict[int, List[int]] = {}
        for i, d in enumerate(docs):
            groups.setdefault(_bucket(len(d)), []).append(i)
        for bucket, idxs in sorted(groups.items()):
            # the unfused families roll over the padded width directly, so
            # it must admit at least one physical window
            width = max(bucket, self.cfg.ngram_n)
            # rows capped so the plain (rows, bucket, k_chunk) remix tile
            # stays bounded whatever the bucket
            max_rows = max(8, (1 << 20) // bucket)
            for s in range(0, len(idxs), max_rows):
                chunk = idxs[s : s + max_rows]
                Dp = max(8, 1 << int(np.ceil(np.log2(len(chunk)))))
                toks = np.zeros((Dp, width), np.int32)
                nw = np.zeros((Dp,), np.int32)
                for r, i in enumerate(chunk):
                    d = np.asarray(docs[i])
                    toks[r, : len(d)] = d
                    nw[r] = max(0, len(d) - self.cfg.ngram_n + 1)
                sigs = self._signature_batch(
                    torch.from_numpy(toks).to(self.device),
                    torch.from_numpy(nw).to(self.device))
                out[np.asarray(chunk)] = sigs.cpu().numpy()[: len(chunk)]
        return out

    def signature(self, tokens: np.ndarray) -> np.ndarray:
        return self.signature_many([tokens])[0]

    def signature_unfused(self, tokens: np.ndarray) -> np.ndarray:
        """One document's signature the unfused way — window hashes
        materialised, remixed, masked and reduced — bit-identical to
        :meth:`signature`."""
        n = len(tokens)
        # the unfused hash needs at least one physical window to roll over
        padded = np.zeros((1, max(_bucket(n), self.cfg.ngram_n)), np.int32)
        padded[0, :n] = tokens
        n_windows = torch.tensor([max(0, n - self.cfg.ngram_n + 1)],
                                 device=self.device)
        return self._signature_batch(
            torch.from_numpy(padded).to(self.device),
            n_windows)[0].cpu().numpy()

    # -- LSH band index -----------------------------------------------------

    def _band_keys(self, sigs: np.ndarray) -> np.ndarray:
        """(D, k) uint32 -> (D, bands) void scalars; .tobytes() of a key
        equals the per-band row-bytes dict key."""
        D = sigs.shape[0]
        blocks = np.ascontiguousarray(
            sigs.reshape(D, self.cfg.lsh_bands, self.rows))
        return blocks.view(np.dtype((np.void, self.rows * 4)))[..., 0]

    def _insert(self, sig: np.ndarray, keys: Sequence[bytes]) -> int:
        doc_id = len(self._sigs)
        self._sigs.append(sig)
        self._index.insert(doc_id, keys)
        return doc_id

    def _best_match(self, sig: np.ndarray,
                    candidates: Sequence[int]) -> Tuple[float, Optional[int]]:
        if not candidates:
            return 0.0, None
        cand_sigs = np.stack([self._sigs[c] for c in candidates])
        jac = (cand_sigs == sig[None, :]).mean(axis=1)
        best = int(np.argmax(jac))
        return float(jac[best]), candidates[best]

    def add_batch(self, docs: Sequence[np.ndarray]) -> np.ndarray:
        """Dedup a document batch; returns (D,) bool duplicate flags.

        Signing streams fixed-shape chunks through the plan kernel;
        candidate generation probes every band shard against both the batch
        and the existing index. Only candidate pairs are Jaccard-verified,
        sequentially in document order, so the decisions match the
        per-document :meth:`check_and_add` path exactly (a doc is only
        compared against *kept* predecessors).
        """
        D = len(docs)
        flags = np.zeros(D, bool)
        if D == 0:
            return flags
        with trace.span("dedup.add_batch"):
            sigs = self.signature_many(docs)
            with trace.span("dedup.probe"):
                kb = self._band_keys(sigs)
                index_cand, batch_cand = self._index.probe_batch(kb)
            with trace.span("dedup.verify"):
                gid: List[Optional[int]] = [None] * D
                for i in range(D):
                    cands = set(index_cand[i])
                    cands.update(gid[j] for j in batch_cand[i]
                                 if gid[j] is not None)
                    best_j, best_id = self._best_match(sigs[i], sorted(cands))
                    if best_id is not None and best_j >= self.cfg.threshold:
                        flags[i] = True
                    else:
                        gid[i] = self._insert(sigs[i],
                                              [k.tobytes() for k in kb[i]])
        return flags

    def check_and_add(self, tokens: np.ndarray) -> Tuple[bool, Optional[int], float]:
        """Streaming API: returns (is_duplicate, matched_doc_id,
        best_jaccard); adds the doc to the index if it is not a duplicate."""
        sig = self.signature(tokens)
        keys = [k.tobytes() for k in self._band_keys(sig[None])[0]]
        candidates = self._index.probe(keys)
        best_j, best_id = self._best_match(sig, sorted(candidates))
        if best_id is not None and best_j >= self.cfg.threshold:
            return True, best_id, best_j
        self._insert(sig, keys)
        return False, None, best_j

    def __len__(self):
        return len(self._sigs)


def signature_batch(fam, fam_params, mh: MinHash, mh_params,
                    tokens) -> torch.Tensor:
    """The unfused reference: (B, S) tokens -> (B, k) uint32, each row's
    window hashes materialised and remixed (the parity oracle of the fused
    paths)."""
    rows = []
    for t in torch.as_tensor(tokens):
        h = fam.hash_windows(fam_params, t)
        if hasattr(fam, "pairwise_bits"):
            h = fam.pairwise_bits(h)
        rows.append(mh.signature(mh_params, h))
    return torch.stack(rows)


def signature_batch_fused(fam, fam_params, mh: MinHash, mh_params, tokens,
                          n_windows=None, impl: str = "auto") -> torch.Tensor:
    """Batched signatures: (B, S) tokens -> (B, k) uint32 on the
    parameters' device. CYCLIC and GENERAL run the plan engine (one kernel
    launch on CUDA); the other families fall back to
    :func:`signature_batch` (which takes no ``n_windows``)."""
    plan = _plan_for_family(fam, mh.k)
    if plan is None:
        return signature_batch(fam, fam_params, mh, mh_params, tokens)
    h1v = fam._lookup(fam_params, tokens)
    return api.run(plan, h1v, n_windows=n_windows,
                   operands={"sig": {"a": mh_params["a"],
                                     "b": mh_params["b"]}},
                   impl=impl)["sig"]


_EXACT_MH = MinHash(k=4)


def exact_duplicate_mask(fam, fam_params, tokens, *, mh_params=None,
                         impl: str = "auto") -> torch.Tensor:
    """(B, S) batch -> (B,) bool: True where a sequence's k=4 MinHash of
    its whole content equals an earlier sequence's in the batch (the exact
    dedup pass). ``mh_params`` are the four remix lanes (default: drawn
    from ``torch.Generator().manual_seed(0)`` on the parameters' device;
    the JAX package draws its own from ``PRNGKey(0)``, so parity carries
    those across)."""
    dev = fam_params["h1"].device
    if mh_params is None:
        mh_params = _EXACT_MH.init(torch.Generator().manual_seed(0), dev)
    tokens = torch.as_tensor(tokens, device=dev)
    sigs = u32.lanes(signature_batch_fused(fam, fam_params, _EXACT_MH,
                                           mh_params, tokens, impl=impl))
    B = sigs.shape[0]
    eq = (sigs[:, None, :] == sigs[None, :, :]).all(dim=-1)
    earlier = torch.ones((B, B), dtype=torch.bool, device=dev).tril(-1)
    return (eq & earlier).any(dim=1)
