"""The plain reference of the corpus scan: HyperLogLog registers and CountMin
counts of every CYCLIC window of each row stream (a configuration's
``stats``), and each row's share of windows whose Bloom probes all hit an
eval filter (its ``decontam``); a configuration may give either or both.

A stream is a row of consecutive blocks: a window that spans two blocks is
counted once, in the block it ends in, and the first n-1 symbols of a
stream end no window. ``contribution`` is one block's part given the
symbols before it; ``scan`` combines the parts of a run that cycled a pool
of blocks; ``ReferenceScan`` is the same a block at a time, which stands in
the program's place, with a guarantee broken, as the control. Nothing here
imports the program.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from bench.reference.hashing import (M32, ctz, cyclic_windows, discard_mask,
                                     mulmod32)

ROWS = 256              # rows of one block hashed at once


def bloom_words(evals: np.ndarray, pa: torch.Tensor, pb: torch.Tensor,
                n: int, L: int, log2_m: int, k: int) -> torch.Tensor:
    """The eval filter: (2^log2_m / 32,) int64 lanes, bit p of the filter
    (word p >> 5, bit p & 31) set for every probe p = (ha + i * (hb | 1))
    mod 2^32 mod 2^log2_m, i < k, of every window of the eval passages
    (ha, hb the two draws' window hashes, each kept to L-n+1 bits)."""
    dev = pa.device
    mask = discard_mask(n, L)
    m = 1 << log2_m
    plane = torch.zeros((m,), dtype=torch.bool, device=dev)
    for s in range(0, evals.shape[0], ROWS):
        t = torch.from_numpy(np.asarray(evals[s : s + ROWS], np.int64)).to(dev)
        ha = cyclic_windows(pa[t], n, L) & mask
        hb = (cyclic_windows(pb[t], n, L) & mask) | 1
        i = torch.arange(k, device=dev, dtype=torch.int64)
        probes = ((ha[..., None] + i * hb[..., None]) & M32) & (m - 1)
        plane[probes.reshape(-1)] = True
    bits = plane.view(-1, 32).to(torch.int64)
    return (bits << torch.arange(32, device=dev, dtype=torch.int64)).sum(-1)


def hashing(cfg: dict):
    """(n, L) of the scan's window hashes: the stats and decontam halves that
    the configuration gives hash alike."""
    halves = [cfg[h] for h in ("stats", "decontam") if h in cfg]
    if not halves:
        raise ValueError("a scan gives stats, decontam or both")
    if any((h["ngram_n"], h["L"]) != (halves[0]["ngram_n"], halves[0]["L"])
           for h in halves):
        raise ValueError("the scan's stats and decontam hash alike")
    return halves[0]["ngram_n"], halves[0]["L"]


def contribution(block: np.ndarray, before: Optional[np.ndarray],
                 params: Dict[str, torch.Tensor], cfg: dict,
                 discard: bool = True) -> Dict:
    """One (T, B, C) block's part of a scan, given the (B, n-1) symbols
    that precede it in each row stream (None at the start of the streams).

    Returns ``windows`` (B,) int64 windows ending in the block; with
    ``stats``, ``hll`` (2^b,) int64 register maxima and ``cms`` (depth,
    width) int64 counts; with ``decontam``, ``hits`` (B,) int64 windows
    whose Bloom probes all hit, and ``probes``, the probes those windows
    need (a window stops at its first miss)."""
    st, dc = cfg.get("stats"), cfg.get("decontam")
    n, L = hashing(cfg)
    T, B, C = block.shape
    rows = np.ascontiguousarray(block.transpose(1, 0, 2).reshape(B, T * C))
    if before is not None:
        rows = np.concatenate([before, rows], axis=1)
    mask = discard_mask(n, L, discard)
    W = rows.shape[1] - n + 1
    dev = next(iter(params.values())).device
    out = {"windows": torch.full((B,), W, dtype=torch.int64, device=dev)}
    if st:
        b, depth, lw = st["hll_b"], st["cms_depth"], st["cms_log2_width"]
        rank_bits = (L - n + 1 if discard else L) - b
        regs = torch.zeros((1 << b,), dtype=torch.int64, device=dev)
        cms = torch.zeros((depth << lw,), dtype=torch.int64, device=dev)
    if dc:
        m = 1 << dc["log2_m"]
        hits = torch.zeros((B,), dtype=torch.int64, device=dev)
        probes = torch.zeros((), dtype=torch.int64, device=dev)
        i_k = torch.arange(dc["k"], device=dev, dtype=torch.int64)
    for s in range(0, B, ROWS):
        t = torch.from_numpy(rows[s : s + ROWS].astype(np.int64)).to(dev)
        if st:
            h = cyclic_windows(params["h1_stats"][t], n, L) & mask
            idx = (h & ((1 << b) - 1)).reshape(-1)
            rank = (ctz(h >> b).clamp(max=rank_bits) + 1).reshape(-1)
            regs.scatter_reduce_(0, idx, rank, "amax")
            for d in range(depth):
                mixed = (mulmod32(params["cms_a"][d], h)
                         + params["cms_b"][d]) & M32
                cms += torch.bincount(
                    ((mixed >> (32 - lw)) + (d << lw)).reshape(-1),
                    minlength=depth << lw)
        if dc:
            ha = cyclic_windows(params["h1_a"][t], n, L) & mask
            hb = (cyclic_windows(params["h1_b"][t], n, L) & mask) | 1
            p = ((ha[..., None] + i_k * hb[..., None]) & M32) & (m - 1)
            hit = (params["bits"][p >> 5] >> (p & 31)) & 1
            hits[s : s + ROWS] = hit.prod(-1).sum(-1)
            # probes a window needs: one, and one more after each leading hit
            lead = hit.cumprod(-1)[..., :-1].sum(-1)
            probes += (1 + lead).sum()
    if st:
        out["hll"], out["cms"] = regs, cms.view(depth, 1 << lw)
    if dc:
        out["hits"], out["probes"] = hits, int(probes)
    return out


def merge(state: Dict, part: Dict, times: int = 1) -> Dict:
    """``state`` with ``times`` copies of ``part`` added (registers by
    max)."""
    for key, v in part.items():
        if key == "hll":
            state[key] = torch.maximum(state[key], v)
        else:
            state[key] = state[key] + times * v
    return state


def tail(block: np.ndarray, n: int) -> np.ndarray:
    """The (B, n-1) last symbols of each row of a (T, B, C) block."""
    return np.ascontiguousarray(block[-1, :, block.shape[2] - (n - 1):])


def scan(pool: np.ndarray, fed: int, params: Dict[str, torch.Tensor],
         cfg: dict) -> Dict:
    """The state after ``fed`` blocks, block t being ``pool[t % P]``: the
    first block's part once, and each pool block's part, given the block
    before it in the cycle, as many times as it followed one. Returns
    ``contribution``'s keys summed (registers by max)."""
    n, _ = hashing(cfg)
    P = pool.shape[0]
    out = contribution(pool[0], None, params, cfg)
    for p in range(P):
        times = len(range(p if p else P, fed, P))   # blocks t >= 1, t % P == p
        if times:
            merge(out, contribution(pool[p], tail(pool[p - 1], n), params,
                                    cfg), times)
    return out


def fractions(hits: np.ndarray, windows: np.ndarray) -> np.ndarray:
    """Each row's share of windows whose probes all hit (0 for a row with
    no window)."""
    return np.where(windows > 0, hits / np.maximum(windows, 1), 0.0)


class ReferenceScan:
    """The scan a block at a time, with the symbols before each block
    carried from the last. With ``carry=False`` every block starts the
    streams afresh, so the windows that span two blocks go uncounted; with
    ``discard=False`` the sketches take all L bits of the window hashes.
    Either is a control."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict,
                 carry: bool = True, discard: bool = True):
        self.params, self.cfg = params, cfg
        self.carry, self.discard = carry, discard
        self.before = None
        self.state = None

    def update(self, block: np.ndarray) -> None:
        part = contribution(block, self.before if self.carry else None,
                            self.params, self.cfg, self.discard)
        self.before = tail(block, hashing(self.cfg)[0])
        self.state = part if self.state is None else merge(self.state, part)
