"""Decode-plane counter surface: what the serving plane is doing, cheaply.

All per-step accounting lives on the device inside the pool's carry
(uint32 (lo, hi) pairs with explicit carry), so recording costs no host
sync per decode step. This module is the read side: :func:`snapshot` pulls
the carry to the host once and derives the operator-facing rates, as the
reference's ``repro/serve/telemetry.py`` does:

* ``banned_rate``  — banned candidates per (step x vocab);
* ``bloom_fill``   — per-session filter occupancy; ``saturated`` counts
  sessions past 50% fill;
* ``canary_hits``  — candidate tokens that would have completed an n-gram
  of the training canary set;
* ``dispatches``   — pool operations issued (steps + primes + churn).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.serve import sessions as _sessions


def u64(lo, hi) -> np.ndarray:
    """Combine uint32 (lo, hi) counter pairs into host uint64 values."""
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(
        lo, np.uint64)


def bloom_fill(words) -> np.ndarray:
    """(..., m/32) packed filter words -> (...,) fill fraction in [0, 1]."""
    words = np.ascontiguousarray(
        words.cpu().numpy() if hasattr(words, "cpu") else words, np.uint32)
    bits = np.unpackbits(words.view(np.uint8), axis=-1)
    return bits.sum(axis=-1) / float(words.shape[-1] * 32)


def dispatch_count() -> int:
    """Pool operations issued in this context (steps+primes+churn)."""
    return _sessions.dispatch_count()


def snapshot(pool) -> Dict[str, float]:
    """One host pull of a :class:`~repro_torch.serve.sessions.SessionPool`'s
    telemetry. Rates are over ACTIVE sessions' lifetime decode steps."""
    st = {k: v.cpu().numpy() for k, v in pool.state.items()}
    active = st["active"] != 0
    steps = u64(st["steps"], 0)
    total_steps = int(steps[active].sum())
    banned = u64(st["banned_lo"], st["banned_hi"])
    canary = u64(st["canary_lo"], st["canary_hi"])
    fill = bloom_fill(st["bloom"])
    n_active = int(active.sum())
    cand = total_steps * pool.vocab
    return {
        "active_sessions": n_active,
        "decode_steps": total_steps,
        "banned_candidates": int(banned[active].sum()),
        "banned_rate": float(banned[active].sum() / cand) if cand else 0.0,
        "canary_hits": int(canary[active].sum()),
        "canary_rate": float(canary[active].sum() / cand) if cand else 0.0,
        "bloom_fill_mean": float(fill[active].mean()) if n_active else 0.0,
        "bloom_fill_max": float(fill[active].max()) if n_active else 0.0,
        "saturated_sessions": int((fill[active] > 0.5).sum()),
        "dispatches": dispatch_count(),
    }
