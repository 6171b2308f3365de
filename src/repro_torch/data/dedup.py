"""Hash-based near-duplicate detection — the paper's families in production.

Per document: rolling CYCLIC (or GENERAL) hashes of every n-gram, with the
Theorem-1 discard, feed a MinHash signature; Jaccard over signatures >=
``threshold`` flags a near-duplicate. Pairwise independence of the window
hashes is what makes the MinHash collision estimator unbiased.

Signing is streamed and fused: a one-MinHash :class:`SketchPlan` is built
once, and documents advance ``stream_rows`` at a time through fixed
``(stream_block_chunks, stream_rows, stream_chunk_s)`` chunk blocks
(:mod:`repro_torch.kernels.stream`). On CUDA every chunk is one launch of
the plan kernel, which hashes, discards, remixes and takes the minima in
one pass; the next block's copy to the card overlaps the current block's
kernels. Masked windows are excluded from the min outright, so signatures
do not depend on chunking.

The LSH index (:class:`BandShardedLSHIndex`) partitions the band->key map by
band id; candidate pairs are Jaccard-verified sequentially in document
order, so :meth:`MinHashDeduper.add_batch` reproduces the streaming
per-document path (:meth:`MinHashDeduper.check_and_add`) exactly.

Not ported yet: multi-device signing (``data_shards``, ``mesh``), the
families outside the fused engine (``make_family`` raises for them) with
their bucketed signing fallback, and ``exact_duplicate_mask`` (ROADMAP.md,
Queue 1).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import Cyclic, General, MinHash, make_family
from repro_torch.kernels import api, stream
from repro_torch.kernels.plan import HashSpec, MinHashSpec, SketchPlan


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
    # multi-device signing is not ported: None or 1
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
        already stored under that key."""
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


class MinHashDeduper:
    """Near-dedup with a band-sharded LSH index; streamed, fused signing on
    ``cfg.device``."""

    def __init__(self, cfg: DedupConfig, mesh=None):
        if mesh is not None or cfg.data_shards not in (None, 1):
            raise NotImplementedError(
                "multi-device signing (mesh / data_shards) is not ported to "
                "repro_torch yet (ROADMAP.md, Queue 1 item 7)")
        if cfg.n_signatures % cfg.lsh_bands:
            raise ValueError(f"n_signatures={cfg.n_signatures} is not a "
                             f"multiple of lsh_bands={cfg.lsh_bands}")
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.rows = cfg.n_signatures // cfg.lsh_bands
        gen = torch.Generator().manual_seed(cfg.seed)
        self.fam = make_family(cfg.family, n=cfg.ngram_n, L=cfg.L)
        self.fam_params = self.fam.init(gen, cfg.vocab, self.device)
        self.mh = MinHash(k=cfg.n_signatures)
        self.mh_params = self.mh.init(gen, self.device)
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

        Documents are grouped ``stream_rows`` at a time by descending length
        (signatures are per row, so packing similar lengths together only
        cuts masked work); each group advances through ``(T, stream_rows,
        stream_chunk_s)`` token blocks — full ``stream_block_chunks``-chunk
        blocks plus one pow2-sized tail block. A block's tokens go to the
        card through pinned memory and are mapped through h1 there; a row
        that runs out of symbols submits 0-length chunks, and a document
        shorter than the n-gram window signs to the sentinel signature.
        """
        cfg = self.cfg
        D = len(docs)
        out = np.empty((D, cfg.n_signatures), np.uint32)
        Bt, Cs = cfg.stream_rows, cfg.stream_chunk_s
        T0 = max(1, cfg.stream_block_chunks)
        operands = {"sig": {"a": self.mh_params["a"],
                            "b": self.mh_params["b"]}}
        order = np.argsort([-len(d) for d in docs], kind="stable")
        for g in range(0, D, Bt):
            sel = order[g : g + Bt]
            group = [np.asarray(docs[i]) for i in sel]
            max_len = max((len(d) for d in group), default=0)
            n_chunks = max(1, -(-max_len // Cs))

            def blocks():
                # full T0-chunk blocks, then one pow2-sized tail block
                done = 0
                while done < n_chunks:
                    rem = n_chunks - done
                    T = T0 if rem >= T0 else 1 << int(np.ceil(np.log2(rem)))
                    toks = np.zeros((T, Bt, Cs), np.int32)
                    lengths = np.zeros((T, Bt), np.int32)
                    for t in range(T):
                        lo = (done + t) * Cs
                        for r, d in enumerate(group):
                            v = int(np.clip(len(d) - lo, 0, Cs))
                            if v:
                                toks[t, r, :v] = d[lo : lo + v]
                                lengths[t, r] = v
                    done += T
                    # the copy and the h1 lookup are queued asynchronously
                    # behind the kernels of the block before
                    dev_toks = stream._to_device(toks, self.device)
                    yield self.fam._lookup(self.fam_params, dev_toks), lengths

            state = stream.init_state(self.plan, Bt, device=self.device)
            state = stream.feed(self.plan, blocks(), state,
                                operands=operands, impl=cfg.impl)
            sigs = stream.finalize(self.plan, state)["sig"].cpu().numpy()
            out[sel] = sigs[: len(group)]
        return out

    def signature(self, tokens: np.ndarray) -> np.ndarray:
        return self.signature_many([tokens])[0]

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
        sigs = self.signature_many(docs)
        kb = self._band_keys(sigs)
        index_cand, batch_cand = self._index.probe_batch(kb)
        gid: List[Optional[int]] = [None] * D
        for i in range(D):
            cands = set(index_cand[i])
            cands.update(gid[j] for j in batch_cand[i] if gid[j] is not None)
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
        keys = [sig[b * self.rows : (b + 1) * self.rows].tobytes()
                for b in range(self.cfg.lsh_bands)]
        candidates = self._index.probe(keys)
        best_j, best_id = self._best_match(sig, sorted(candidates))
        if best_id is not None and best_j >= self.cfg.threshold:
            return True, best_id, best_j
        self._insert(sig, keys)
        return False, None, best_j

    def __len__(self):
        return len(self._sigs)


def signature_batch_fused(fam, fam_params, mh: MinHash, mh_params, tokens,
                          n_windows=None, impl: str = "auto") -> torch.Tensor:
    """Fused batched signatures: (B, S) tokens -> (B, k) uint32 on the
    parameters' device, through the plan engine (one kernel launch on
    CUDA). Families outside the fused engine are not ported."""
    plan = _plan_for_family(fam, mh.k)
    if plan is None:
        raise NotImplementedError(
            f"{type(fam).__name__} has no fused plan; the unfused "
            f"signature path is not ported (ROADMAP.md, Queue 1 item 6)")
    h1v = fam._lookup(fam_params, tokens)
    return api.run(plan, h1v, n_windows=n_windows,
                   operands={"sig": {"a": mh_params["a"],
                                     "b": mh_params["b"]}},
                   impl=impl)["sig"]
