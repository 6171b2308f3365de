"""Exact and empirical independence checkers for n-gram hash families.

The paper's claims (Props. 1–3, Lemmas 1/3, Theorem 1) are statements about
probabilities over the random choice of the symbol hash ``h1``. For small
``L`` and a small active alphabet these probabilities can be computed
*exactly* by enumerating every possible ``h1`` table — ``(2^L)^slots``
assignments — and counting joint hash values. That is what this module does;
the tests then assert the paper's statements with zero statistical slack.

The enumerated tables go through the family as one leading batch dim (the
families gather along the table's last axis), in chunks of 2^16. The numpy
counting helpers are copies of the JAX package's.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import u32
from repro_torch.core.families import ThreeWise, _Family

Transform = Optional[Callable[[torch.Tensor], torch.Tensor]]

_CHUNK = 1 << 16


def all_tables(L: int, slots: int) -> np.ndarray:
    """Every possible assignment of ``slots`` i.i.d. uniform L-bit values.

    Returns (A, slots) uint32 with A = (2^L)^slots. Keep L*slots <= ~24.
    """
    base = 1 << L
    A = base ** slots
    if A > (1 << 26):
        raise ValueError(f"enumeration too large: {A} assignments")
    idx = np.arange(A, dtype=np.uint64)
    cols = [(idx // (base ** s)) % base for s in range(slots)]
    return np.stack(cols, axis=1).astype(np.uint32)


def _num_slots(family: _Family, sigma: int) -> int:
    return family.n * sigma if isinstance(family, ThreeWise) else sigma


def _table_shape(family: _Family, sigma: int) -> tuple:
    return (family.n, sigma) if isinstance(family, ThreeWise) else (sigma,)


def _hash_batch(family: _Family, tables: torch.Tensor, ngrams: torch.Tensor,
                transform: Transform) -> torch.Tensor:
    """(A, *table_shape) uint32 tables, (k, n) n-grams -> (A, k) hashes."""
    params = {"h1": tables}
    hs = torch.stack([family.hash_ngram(params, g) for g in ngrams], dim=-1)
    return hs if transform is None else transform(hs)


def _to_u32(hs: torch.Tensor) -> np.ndarray:
    return u32.lanes(hs).numpy().astype(np.uint32)


def enumerate_hashes(family: _Family, ngrams: Sequence[Sequence[int]],
                     sigma: int, transform: Transform = None) -> np.ndarray:
    """Hash every n-gram under every possible h1 assignment.

    Returns (A, k) uint32 — row a = hashes of the k n-grams under
    assignment a.
    """
    ngrams = np.asarray(ngrams, dtype=np.int64)
    assert ngrams.ndim == 2 and ngrams.shape[1] == family.n
    assert ngrams.max(initial=0) < sigma
    tables = all_tables(family.L, _num_slots(family, sigma))
    shape = _table_shape(family, sigma)
    grams = torch.from_numpy(ngrams)
    outs = []
    for s in range(0, tables.shape[0], _CHUNK):
        chunk = torch.from_numpy(tables[s : s + _CHUNK])
        outs.append(_to_u32(_hash_batch(
            family, chunk.reshape((-1,) + shape), grams, transform)))
    return np.concatenate(outs, axis=0)


def joint_counts(hashes: np.ndarray, bits: int) -> np.ndarray:
    """(A, k) hash matrix -> exact joint histogram of shape (2^bits,)*k."""
    A, k = hashes.shape
    combined = np.zeros(A, dtype=np.uint64)
    for j in range(k):
        combined = (combined << np.uint64(bits)) | hashes[:, j].astype(np.uint64)
    # bincount refuses uint64 (no safe cast to intp); the combined index is
    # bounded by the histogram size, which must be int64-allocatable anyway
    counts = np.bincount(combined.astype(np.int64), minlength=1 << (bits * k))
    return counts.reshape((1 << bits,) * k)


def is_uniform(family: _Family, ngram, sigma: int, transform: Transform = None,
               bits: Optional[int] = None) -> bool:
    """Exact check: P(h(x)=y) == 2^-bits for every y."""
    bits = bits if bits is not None else family.L
    hs = enumerate_hashes(family, [ngram], sigma, transform)
    counts = joint_counts(hs, bits)
    return bool((counts == hs.shape[0] // (1 << bits)).all())


def is_kwise_independent(family: _Family, ngrams, sigma: int,
                         transform: Transform = None,
                         bits: Optional[int] = None) -> bool:
    """Exact check of k-wise independence for the given distinct n-grams."""
    bits = bits if bits is not None else family.L
    k = len(ngrams)
    hs = enumerate_hashes(family, ngrams, sigma, transform)
    counts = joint_counts(hs, bits)
    expected, rem = divmod(hs.shape[0], 1 << (bits * k))
    if rem:  # probability 1/2^(k*bits) is not even representable -> fails
        return False
    return bool((counts == expected).all())


def collision_probability(family: _Family, x1, x2, sigma: int,
                          transform: Transform = None) -> float:
    """Exact P(h(x1) == h(x2)) — 2-universality requires <= 2^-bits."""
    hs = enumerate_hashes(family, [x1, x2], sigma, transform)
    return float((hs[:, 0] == hs[:, 1]).mean())


def trailing_zeros_np(v: np.ndarray, L: int) -> np.ndarray:
    """zeros(x) of the paper §2: number of trailing zeros, zeros(0) = L."""
    v = v.astype(np.uint64)
    isolated = v & (~v + np.uint64(1))
    out = np.zeros_like(v, dtype=np.int64)
    for b in range(L):
        out = np.where((isolated >> np.uint64(b)) & np.uint64(1) == 1, b, out)
    return np.where(v == 0, L, out)


def is_kwise_trailing_zero_independent(family: _Family, ngrams, sigma: int,
                                       transform: Transform = None,
                                       bits: Optional[int] = None) -> bool:
    """Exact check of the paper §2 definition:
    P(AND_i zeros(h(x_i)) >= j_i) == 2^-sum(j_i) for all j in [0, L]^k."""
    bits = bits if bits is not None else family.L
    hs = enumerate_hashes(family, ngrams, sigma, transform)
    A, k = hs.shape
    tz = trailing_zeros_np(hs, bits)  # (A, k)
    grids = np.meshgrid(*[np.arange(bits + 1)] * k, indexing="ij")
    for j_tuple in np.stack([g.ravel() for g in grids], axis=1):
        sat = np.ones(A, dtype=bool)
        for i, j in enumerate(j_tuple):
            sat &= tz[:, i] >= j
        if sat.sum() != A / (2.0 ** int(j_tuple.sum())):
            return False
    return True


# ---------------------------------------------------------------------------
# Empirical (sampled) checker for parameter regimes too large to enumerate
# ---------------------------------------------------------------------------

def empirical_joint_deviation(family: _Family, ngrams, sigma: int, *,
                              samples: int, gen: torch.Generator,
                              bits: Optional[int] = None,
                              transform: Transform = None) -> float:
    """Max |empirical P - 2^-k*bits| over the joint table, using ``samples``
    random h1 draws from ``gen`` (one batch of tables). For calibration of
    large-L configurations."""
    bits = bits if bits is not None else family.L
    k = len(ngrams)
    if bits * k > 32:
        raise ValueError("empirical checker needs bits*k <= 32")
    draws = torch.randint(0, 1 << 32, (samples,) + _table_shape(family, sigma),
                          generator=gen, dtype=torch.int64).to(torch.uint32)
    grams = torch.from_numpy(np.asarray(ngrams, dtype=np.int64))
    hs = _to_u32(_hash_batch(family, draws, grams, transform)).astype(np.uint64)
    combined = np.zeros(samples, dtype=np.uint64)
    for j in range(k):        # as uint32 lanes: the shift wraps at 32 bits
        combined = ((combined << np.uint64(bits)) | hs[:, j]) & np.uint64(
            u32.MASK32)
    counts = np.bincount(combined.astype(np.int64), minlength=1 << (bits * k))
    return float(np.abs(counts / samples - 2.0 ** (-bits * k)).max())
