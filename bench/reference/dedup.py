"""The plain reference of near-duplicate removal: MinHash signatures of CYCLIC
window hashes with the Theorem-1 discard, LSH band keys, and first-wins
verdicts in document order, checked by Jaccard over signatures.

``signatures`` and ``verdicts`` judge a run; ``ReferenceDeduper`` is the
same semantics one document at a time, which tests hold ``verdicts``
against and which stands in the program's place, with a guarantee
broken, as the control. Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from bench.reference.hashing import M32, cyclic_windows, discard_mask, mulmod32

K_CHUNK = 16            # MinHash lanes remixed at once
CELLS = 1 << 22         # (rows x windows) of one signing tile


def signatures(docs: Sequence[np.ndarray], params: Dict[str, torch.Tensor],
               n: int, L: int, discard: bool = True) -> np.ndarray:
    """(D, k) uint32 MinHash signatures: lane i of a document is the least
    (a_i * h + b_i) mod 2^32 over its window hashes h (each kept to its
    L-n+1 low bits); a document with no window signs to 0xFFFFFFFF.
    ``params`` holds int64 lanes ``h1`` (vocab,), ``a`` and ``b`` (k,) on
    the device the work runs on."""
    h1, a, b = params["h1"], params["a"], params["b"]
    dev, k = h1.device, a.shape[0]
    mask = discard_mask(n, L, discard)
    # below 2^31 a product with a 32-bit lane stays inside int64
    direct = mask < 1 << 31
    lens = np.asarray([len(d) for d in docs], np.int64)
    order = np.argsort(lens, kind="stable")
    out = np.full((len(docs), k), M32, np.uint32)
    i = 0
    while i < len(order):
        S = max(int(lens[order[i]]), 1)
        # documents in ascending length: the tile's widest is its last
        j = i + 1
        while j < len(order) and (j + 1 - i) * max(int(lens[order[j]]), 1) <= CELLS:
            j += 1
        sel = order[i:j]
        S = max(int(lens[sel[-1]]), n)
        toks = np.zeros((len(sel), S), np.int32)
        for r, t in enumerate(sel):
            toks[r, : lens[t]] = docs[t]
        x = h1[torch.from_numpy(toks).to(dev).long()]
        h = cyclic_windows(x, n, L) & mask
        nw = torch.from_numpy(lens[sel] - n + 1).to(dev)
        valid = torch.arange(h.shape[1], device=dev)[None, :] < nw[:, None]
        # an invalid window repeats the row's first window: the minima stay
        h = torch.where(valid, h, h[:, :1])
        sig = torch.empty((len(sel), k), dtype=torch.int64, device=dev)
        for s in range(0, k, K_CHUNK):
            ac, bc = a[s : s + K_CHUNK], b[s : s + K_CHUNK]
            if direct:
                mixed = torch.addcmul(bc, h[:, :, None], ac)
            else:
                mixed = mulmod32(ac, h[:, :, None]) + bc
            mixed &= M32
            sig[:, s : s + K_CHUNK] = mixed.amin(dim=1)
        got = sig.cpu().numpy().astype(np.uint32)
        got[(lens[sel] - n + 1) <= 0] = M32
        out[sel] = got
        i = j
    return out


def band_keys(sigs: np.ndarray, bands: int) -> np.ndarray:
    """(N, k) uint32 -> (N, bands) keys: each band's lanes as one bytes
    value."""
    N, k = sigs.shape
    rows = k // bands
    blocks = np.ascontiguousarray(sigs.reshape(N, bands, rows))
    return blocks.view(np.dtype((np.void, rows * 4)))[..., 0]


def jaccard_ok(sigs: np.ndarray, i: np.ndarray, j: np.ndarray,
               threshold: float) -> np.ndarray:
    """Whether each pair's signature Jaccard (the share of equal lanes)
    reaches ``threshold``."""
    k = sigs.shape[1]
    out = np.zeros(i.shape[0], bool)
    for s in range(0, i.shape[0], 1 << 16):
        eq = (sigs[i[s : s + (1 << 16)]] == sigs[j[s : s + (1 << 16)]]).sum(1)
        out[s : s + (1 << 16)] = eq / k >= threshold
    return out


def verdicts(sigs: np.ndarray, bands: int, threshold: float,
             verify: bool = True) -> np.ndarray:
    """(N,) bool: document i, in stream order, is a near-duplicate iff some
    earlier document that was kept shares one of its LSH band keys and has
    a signature Jaccard >= ``threshold`` with it (``verify=False``: any
    kept document that shares a band key). A document that is not a
    near-duplicate is kept."""
    N = sigs.shape[0]
    keys = band_keys(sigs, bands)
    pairs = []
    for band in range(bands):
        _, gid = np.unique(keys[:, band], return_inverse=True)
        order = np.argsort(gid.reshape(-1), kind="stable")
        g = gid.reshape(-1)[order]
        d = 1
        while d < N:
            same = g[d:] == g[:-d]
            if not same.any():
                break
            # stable order: the earlier member of a pair comes first
            pairs.append(order[:-d][same].astype(np.int64) * N
                         + order[d:][same])
            d += 1
    flags = np.zeros(N, bool)
    if not pairs:
        return flags
    both = np.unique(np.concatenate(pairs))
    j, i = both // N, both % N
    if verify:
        ok = jaccard_ok(sigs, i, j, threshold)
        i, j = i[ok], j[ok]
    order = np.argsort(i, kind="stable")
    i, j = i[order], j[order]
    starts = np.flatnonzero(np.r_[True, i[1:] != i[:-1]]) if i.size else []
    ends = np.r_[starts[1:], i.size] if i.size else []
    for s, e in zip(starts, ends):
        if not flags[j[s:e]].all():
            flags[i[s]] = True
    return flags


class ReferenceDeduper:
    """The same semantics a document at a time: an LSH index of the kept
    documents' band keys, probed and then verified by Jaccard. With
    ``discard=False`` it signs all L bits of the window hashes (Theorem 1
    broken); with ``verify=False`` every band collision with a kept
    document flags (the verify skipped). Either is a control."""

    def __init__(self, params: Dict[str, torch.Tensor], n: int, L: int,
                 bands: int, threshold: float, discard: bool = True,
                 verify: bool = True):
        self.params, self.n, self.L = params, n, L
        self.bands, self.threshold = bands, threshold
        self.discard, self.verify = discard, verify
        self.index: List[Dict[bytes, List[int]]] = [{} for _ in range(bands)]
        self.kept: List[np.ndarray] = []

    def signature_many(self, docs: Sequence[np.ndarray]) -> np.ndarray:
        return signatures(docs, self.params, self.n, self.L, self.discard)

    def add_batch(self, docs: Sequence[np.ndarray]) -> np.ndarray:
        sigs = self.signature_many(docs)
        keys = band_keys(sigs, self.bands)
        flags = np.zeros(len(docs), bool)
        for r in range(len(docs)):
            kb = [keys[r, band].tobytes() for band in range(self.bands)]
            cands = set()
            for shard, key in zip(self.index, kb):
                cands.update(shard.get(key, ()))
            if cands and not self.verify:
                flags[r] = True
            elif cands:
                best = max(float((self.kept[c] == sigs[r]).mean())
                           for c in cands)
                flags[r] = best >= self.threshold
            if not flags[r]:
                for shard, key in zip(self.index, kb):
                    shard.setdefault(key, []).append(len(self.kept))
                self.kept.append(sigs[r])
        return flags

    def close(self) -> None:
        pass
