"""MinHash over the paper's hash families.

The signature uses the pairwise-independent affine remix of one base hash:
``sig_i = min_x (a_i * h(x) + b_i mod 2^32)``, each ``(a_i odd, b_i)`` a
strongly universal remix, so the collision analysis inherits the base
family's pairwise independence. HyperLogLog, Bloom and Count-Min are not
ported yet (ROADMAP.md, Queue 1 item 2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import u32


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
