"""Probabilistic sketches built on the paper's hash families.

* :class:`HyperLogLog` — distinct-n-gram counting (needs trailing-zero
  independence, which the recursive families give at the pairwise level).
* :class:`BloomFilter` — train/eval decontamination membership, probed by
  double hashing over two independent family draws.
* :class:`MinHash` — document near-dedup signatures: ``sig_i = min_x (a_i *
  h(x) + b_i mod 2^32)``, each ``(a_i odd, b_i)`` a strongly universal
  remix, so the collision analysis inherits the base family's pairwise
  independence.
* :class:`CountMinSketch` — heavy-hitter n-gram counts.

States keep the JAX package's layouts: HLL registers (2^b,) int32, the
filter (2^log2_m / 32,) packed uint32 words, the CountMin table (depth,
2^log2_width) int32. Arithmetic runs on int64 lanes (:mod:`u32`);
parameter draws come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.core import u32


def trailing_zeros(v, L: int = 32) -> torch.Tensor:
    """ctz(v) capped at ``L`` (ctz(0) = L, paper §2 'zeros'), int32."""
    return u32.ctz(u32.lanes(v)).clamp(max=L).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class HyperLogLog:
    """Flajolet-style distinct counting from hash values: ``b`` index bits
    give m = 2^b registers; rank = trailing zeros of the remaining bits + 1.
    ``hash_bits`` is the producing family's usable width (e.g.
    ``Cyclic.out_bits`` after the Theorem-1 discard)."""

    b: int = 10
    hash_bits: int = 32

    @property
    def m(self) -> int:
        return 1 << self.b

    def init(self, device="cuda") -> torch.Tensor:
        return torch.zeros((self.m,), dtype=torch.int32, device=device)

    def _fold(self, regs, idx, rank) -> torch.Tensor:
        out = regs.to(torch.int64).clone()
        out.scatter_reduce_(0, idx, rank.to(torch.int64), "amax")
        return out.to(torch.int32)

    def update(self, regs: torch.Tensor, hashes) -> torch.Tensor:
        h = u32.lanes(hashes).reshape(-1)
        rank = trailing_zeros(h >> self.b, self.hash_bits - self.b) + 1
        return self._fold(regs, h & (self.m - 1), rank)

    def update_split(self, regs, h_idx, h_rank, rank_bits: int) -> torch.Tensor:
        """Register index from one family draw, rank from a second."""
        hi = u32.lanes(h_idx).reshape(-1)
        rank = trailing_zeros(u32.lanes(h_rank).reshape(-1), rank_bits) + 1
        return self._fold(regs, hi & (self.m - 1), rank)

    @staticmethod
    def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.maximum(a, b)

    def estimate(self, regs: torch.Tensor) -> torch.Tensor:
        """Float32 estimate (raw, or linear counting while registers are
        empty), as the JAX package computes it."""
        m = self.m
        alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))
        f32 = torch.float32
        raw = (torch.tensor(alpha * m * m, dtype=f32, device=regs.device)
               / torch.exp2(-regs.to(f32)).sum())
        zeros = (regs == 0).sum()
        linear = m * (torch.tensor(math.log(m), dtype=f32, device=regs.device)
                      - torch.log(zeros.clamp(min=1).to(f32)))
        use_linear = (raw <= 2.5 * m) & (zeros > 0)
        return torch.where(use_linear, linear, raw)


@dataclasses.dataclass(frozen=True)
class BloomFilter:
    """m-bit Bloom filter with k probes by double hashing over two
    independent hash streams: probe_i = h_a + i * (h_b | 1) mod m."""

    log2_m: int = 20
    k: int = 4

    @property
    def m(self) -> int:
        return 1 << self.log2_m

    def init(self, device="cuda") -> torch.Tensor:
        return torch.zeros((self.m // 32,), dtype=torch.int32,
                           device=device).view(torch.uint32)

    def _probes(self, h_a, h_b) -> torch.Tensor:
        ha, hb = u32.lanes(h_a), u32.lanes(h_b) | 1   # odd: invertible stride
        i = torch.arange(self.k, dtype=torch.int64, device=ha.device)
        return (ha[..., None] + i * hb[..., None]) & (self.m - 1)

    def add(self, bits: torch.Tensor, h_a, h_b) -> torch.Tensor:
        probes = self._probes(h_a, h_b).reshape(-1)
        return _scatter_or(bits, probes >> 5, probes & 31)

    def contains(self, bits: torch.Tensor, h_a, h_b) -> torch.Tensor:
        probes = self._probes(h_a, h_b)
        hit = (u32.lanes(bits)[probes >> 5] >> (probes & 31)) & 1
        return (hit == 1).all(dim=-1)

    def fill_fraction(self, bits: torch.Tensor) -> torch.Tensor:
        shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
        ones = (u32.lanes(bits)[:, None] >> shifts) & 1
        return ones.sum() / self.m


def _scatter_or(bits: torch.Tensor, word, bit) -> torch.Tensor:
    """Set bit ``bit[i]`` of word ``word[i]`` for every i, exactly: the bits
    go into a (words, 32) boolean plane (writing True twice is still True)
    that is folded back into packed words and ORed into ``bits``."""
    planes = torch.zeros((bits.shape[0], 32), dtype=torch.bool,
                         device=bits.device)
    planes[word.to(torch.int64), bit.to(torch.int64)] = True
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    merged = (planes.to(torch.int64) << shifts).sum(dim=-1)
    return (u32.lanes(bits) | merged).to(torch.uint32)


@dataclasses.dataclass(frozen=True)
class MinHash:
    """k-signature MinHash over a set of window hashes."""

    k: int = 64

    def init(self, gen: torch.Generator, device="cuda") -> Dict[str, torch.Tensor]:
        """Remix lanes from an explicit generator: ``a`` odd, ``b`` free."""
        a = torch.randint(0, 1 << 32, (self.k,), generator=gen,
                          dtype=torch.int64) | 1
        b = torch.randint(0, 1 << 32, (self.k,), generator=gen,
                          dtype=torch.int64)
        return {"a": a.to(torch.uint32).to(device),
                "b": b.to(torch.uint32).to(device)}

    def signature(self, params, window_hashes) -> torch.Tensor:
        """(..., W) window hashes -> (k,) uint32 minima over all of them."""
        h = u32.lanes(window_hashes).reshape(-1)
        a = u32.lanes(params["a"])[:, None]
        b = u32.lanes(params["b"])[:, None]
        mixed = (u32.mulmod32(a, h[None, :]) + b) & u32.MASK32
        return mixed.min(dim=-1).values.to(torch.uint32)

    @staticmethod
    def jaccard(sig_a, sig_b) -> torch.Tensor:
        return (torch.as_tensor(sig_a) == torch.as_tensor(sig_b)).float().mean()


@dataclasses.dataclass(frozen=True)
class CountMinSketch:
    """depth x 2^log2_width counts; row d's column is the top log2_width
    bits of ``a_d * h + b_d mod 2^32``."""

    depth: int = 4
    log2_width: int = 16

    @property
    def width(self) -> int:
        return 1 << self.log2_width

    def init(self, gen: torch.Generator, device="cuda") -> Dict[str, torch.Tensor]:
        a = torch.randint(0, 1 << 32, (self.depth,), generator=gen,
                          dtype=torch.int64) | 1
        b = torch.randint(0, 1 << 32, (self.depth,), generator=gen,
                          dtype=torch.int64)
        return {"a": a.to(torch.uint32).to(device),
                "b": b.to(torch.uint32).to(device),
                "table": torch.zeros((self.depth, self.width),
                                     dtype=torch.int32, device=device)}

    def _cols(self, params, hashes) -> torch.Tensor:
        """(depth, N) int64 columns of the flattened hashes."""
        h = u32.lanes(hashes).reshape(-1)
        a = u32.lanes(params["a"])[:, None]
        b = u32.lanes(params["b"])[:, None]
        mixed = (u32.mulmod32(a, h[None, :]) + b) & u32.MASK32
        return mixed >> (32 - self.log2_width)

    def add(self, params, hashes) -> Dict[str, torch.Tensor]:
        cols = self._cols(params, hashes)
        rows = torch.arange(self.depth, device=cols.device)[:, None]
        table = params["table"].clone()
        flat = (rows * self.width + cols).reshape(-1)
        table.view(-1).index_add_(0, flat, torch.ones_like(flat,
                                                           dtype=torch.int32))
        return {**params, "table": table}

    def query(self, params, hashes) -> torch.Tensor:
        cols = self._cols(params, hashes)
        rows = torch.arange(self.depth, device=cols.device)[:, None]
        return params["table"][rows, cols].min(dim=0).values
