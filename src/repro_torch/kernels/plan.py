"""Declarative plan objects for the hash->sketch data-plane.

A :class:`SketchPlan` names everything the engine needs to run one rolling-
hash device pass feeding any number of sketch epilogues:

* :class:`HashSpec` — which recursive family rolls over the stream
  (``cyclic`` or ``general``), the window ``n``, lane width ``L``, whether
  the Theorem-1 discard applies, and (for GENERAL) the irreducible modulus
  ``p``. The spec owns the derived quantities the legacy entry points used
  to recompute per call: :attr:`HashSpec.out_bits` (usable bits) and
  :attr:`HashSpec.hash_mask` (the low-bit keep applied inline).
* Sketch specs — :class:`MinHashSpec`, :class:`HLLSpec`, :class:`BloomSpec`,
  :class:`CountMinSpec` — pure shape/width declarations. Device operands
  (MinHash remix lanes, the packed Bloom filter, the CountMin row remix
  constants) are *runtime* inputs of
  :func:`repro_torch.kernels.api.run`, keyed by sketch name, so a plan
  stays a static, hashable key.

Every sketch additionally accepts an optional ``init`` operand — a carry-in
of its own running state (the shape/dtype/identity declared by
:meth:`~MinHashSpec.state_struct` on each spec). The executors *initialize
the sketch scratch from it* instead of resetting, folding the carry with the
sketch's own merge operator (MinHash per-row running min, HLL register max,
Bloom hit-count add, CountMin table add) — the seam the chunked streaming
executor (:mod:`repro_torch.kernels.stream`) is built on. ``state_kind``
tells the engine whether the state is per-batch-row (``"row"``: sharded with
the rows) or corpus-level (``"global"``: one array merged across
shards/chunks).

Plans are frozen dataclasses of ints/strings/tuples: hashable and
comparable, so one plan object can key whatever a caller caches per plan.

The only ``repro_torch.core`` dependency is host-side parameter
resolution (``gf2.find_irreducible_host`` for GENERAL's default modulus);
all hash *math* stays in ``kernels/ref.py`` and the CUDA kernel.

This module is a copy of the JAX package's ``repro/kernels/plan.py`` (which
imports no JAX), kept here so the port depends on nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple, Union

from repro_torch.core import gf2

FAMILIES = ("cyclic", "general")


@dataclasses.dataclass(frozen=True)
class HashSpec:
    """One recursive rolling-hash family draw over (..., S) h1-mapped values.

    ``discard=None`` means the family default: CYCLIC applies the Theorem-1
    (n-1)-bit discard (its raw bits are not uniform, Lemma 3), GENERAL keeps
    all L bits (pairwise independent as-is, Lemma 1). ``p=0`` auto-resolves
    the degree-L irreducible modulus for GENERAL and must stay 0 for CYCLIC
    (whose modulus is fixed at x^L + 1).
    """

    family: str = "cyclic"
    n: int = 8
    L: int = 32
    discard: Optional[bool] = None
    p: int = 0

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(
                f"unknown hash family {self.family!r}; expected one of {FAMILIES}")
        if not 1 <= self.L <= 32:
            raise ValueError(f"L must be in [1, 32], got {self.L}")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.L < self.n:
            raise ValueError(
                f"{self.family.upper()} requires L >= n (paper Table 1); "
                f"got n={self.n}, L={self.L}")
        if self.family == "cyclic":
            if self.p:
                raise ValueError("CYCLIC's modulus is fixed (x^L + 1); p must be 0")
            if self.discard is None:
                object.__setattr__(self, "discard", True)
        else:
            if self.discard:
                raise ValueError(
                    "the Theorem-1 discard applies to CYCLIC only; "
                    "GENERAL is pairwise independent on all L bits")
            object.__setattr__(self, "discard", False)
            p = self.p or gf2.find_irreducible_host(self.L)
            if p.bit_length() - 1 != self.L:
                raise ValueError(
                    f"p must have degree exactly L={self.L}, got {bin(self.p)}")
            object.__setattr__(self, "p", p)

    @property
    def out_bits(self) -> int:
        """Usable (pairwise-independent) bits after the discard, if any."""
        return self.L - self.n + 1 if self.discard else self.L

    @property
    def hash_mask(self) -> int:
        """Low-bit keep mask applied inline to every window hash."""
        return (1 << self.out_bits) - 1


@dataclasses.dataclass(frozen=True)
class MinHashSpec:
    """k-lane MinHash signature; needs runtime operands ``a``/``b`` (k,).
    Optional ``init`` carry: (B, k) uint32 running minima (identity: the
    0xFFFFFFFF sentinel)."""

    k: int = 64

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"MinHash k must be >= 1, got {self.k}")

    operand_names: Tuple[str, ...] = dataclasses.field(
        default=("a", "b"), init=False, repr=False, compare=False)

    state_kind = "row"

    def state_struct(self, batch: int):
        """(shape, dtype name, identity fill) of the carry/``init`` state."""
        return (batch, self.k), "uint32", 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HLLSpec:
    """2^b-register HyperLogLog; ``rank_bits=None`` defaults to the usable
    bits left after index extraction (``HashSpec.out_bits - b``)."""

    b: int = 12
    rank_bits: Optional[int] = None

    def __post_init__(self):
        if self.b < 1:
            raise ValueError(f"HLL b must be >= 1, got {self.b}")

    operand_names: Tuple[str, ...] = dataclasses.field(
        default=(), init=False, repr=False, compare=False)

    state_kind = "global"

    def state_struct(self, batch: int):
        """(shape, dtype name, identity fill) of the carry/``init`` state."""
        return (1 << self.b,), "int32", 0

    def resolve_rank_bits(self, hash_spec: HashSpec) -> int:
        if self.rank_bits is not None:
            return self.rank_bits
        rb = hash_spec.out_bits - self.b
        if rb < 1:
            raise ValueError(
                f"HLL b={self.b} leaves no rank bits: the hash provides only "
                f"{hash_spec.out_bits} usable bits (Theorem-1 discard)")
        return rb


@dataclasses.dataclass(frozen=True)
class BloomSpec:
    """k double-hashed probes against a packed 2^log2_m-bit filter; needs the
    runtime operand ``bits`` (2^log2_m / 32,) and a second hash stream
    (``h1v_b``) for the probe stride."""

    k: int = 4
    log2_m: int = 20

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"Bloom k must be >= 1, got {self.k}")
        if not 5 <= self.log2_m <= 32:
            raise ValueError(f"Bloom log2_m must be in [5, 32], got {self.log2_m}")

    operand_names: Tuple[str, ...] = dataclasses.field(
        default=("bits",), init=False, repr=False, compare=False)

    state_kind = "row"

    def state_struct(self, batch: int):
        """(shape, dtype name, identity fill) of the carry/``init`` state."""
        return (batch,), "int32", 0

    @property
    def n_words(self) -> int:
        return 1 << (self.log2_m - 5)


@dataclasses.dataclass(frozen=True)
class CountMinSpec:
    """depth x 2^log2_width CountMin histogram; needs runtime operands
    ``a``/``b`` (depth,) — the per-row affine remix constants (odd ``a``).

    Counts are additive: the engine returns the *batch partial table*
    (depth, width) int32, which merges into running state by ``+`` and
    combines across data shards with one ``psum`` (the CMS merge operator),
    exactly as HLL registers combine with one ``pmax``.

    ``in_kernel_max_log2_width`` records the in-kernel vs scatter-add
    threshold on the plan itself (static, part of the jit trace key, so the
    ref and Pallas executors agree on the decision): tables up to
    2^threshold wide are accumulated as depth-major one-hot partial sums in
    VMEM scratch inside the fused grid; wider tables (the production 2^16)
    fall back to an XLA scatter-add over kernel-emitted window hashes
    inside the same single-jit graph.
    """

    depth: int = 4
    log2_width: int = 16
    in_kernel_max_log2_width: int = 12

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"CountMin depth must be >= 1, got {self.depth}")
        if not 1 <= self.log2_width <= 30:
            raise ValueError(
                f"CountMin log2_width must be in [1, 30], got {self.log2_width}")
        if self.in_kernel_max_log2_width < 0:
            raise ValueError("in_kernel_max_log2_width must be >= 0")

    operand_names: Tuple[str, ...] = dataclasses.field(
        default=("a", "b"), init=False, repr=False, compare=False)

    state_kind = "global"

    def state_struct(self, batch: int):
        """(shape, dtype name, identity fill) of the carry/``init`` state."""
        return (self.depth, self.width), "int32", 0

    @property
    def width(self) -> int:
        return 1 << self.log2_width

    @property
    def use_in_kernel(self) -> bool:
        """True when the Pallas path histograms in VMEM scratch; False when
        it emits window hashes for the XLA scatter-add epilogue."""
        return self.log2_width <= self.in_kernel_max_log2_width


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """The decode-time n-gram plane: per-session no-repeat Bloom probing
    plus an optional shared decontam-canary filter, fused into the logits
    tile pass (:func:`repro_torch.kernels.api.decode`).

    The recursive CYCLIC structure prices every candidate continuation at
    O(1) bitwise ops — ``h_cand = rotl(h_prefix, 1) XOR h1[v]`` for all v
    simultaneously — so one spec describes hashing the *entire vocabulary*
    per decode step. Probe derivation applies the paper's dependent-bit
    discard (Theorem 2: only ``L - n + 1`` consecutive bits of a CYCLIC
    window hash are pairwise independent): probes draw from
    ``h & hash_mask``, never from the n-1 dependent high bits.

    ``n > L`` is accepted but **degraded**: rotation amounts alias mod L, so
    windows whose symbols sit L positions apart collide structurally and no
    discard width is left (``out_bits`` falls back to the full L with zero
    pairwise guarantee). The recursion itself stays exact — see
    ``serve.engine.NoRepeatNgram`` — so callers opting in still get
    no-false-negative banning, just an unbounded false-positive excess.

    Like the sketch specs this is a pure static declaration (hashable, a
    jit trace key); the runtime arrays (h1 table, per-session filter words,
    the shared canary filter) are arguments of ``api.decode``.
    """

    n: int = 4
    L: int = 32
    log2_m: int = 14          # per-session no-repeat Bloom bits
    k: int = 2                # double-hashed probes per candidate
    canary_log2_m: int = 0    # shared decontam canary filter; 0 = disabled
    canary_k: int = 4

    def __post_init__(self):
        if self.n < 2:
            raise ValueError(f"decode n must be >= 2 (an n-gram ban needs "
                             f"at least a bigram), got {self.n}")
        if not 1 <= self.L <= 32:
            raise ValueError(f"L must be in [1, 32], got {self.L}")
        if not 5 <= self.log2_m <= 24:
            raise ValueError(
                f"log2_m must be in [5, 24] (per-session filter), got "
                f"{self.log2_m}")
        if not 1 <= self.k <= 8:
            raise ValueError(f"k must be in [1, 8], got {self.k}")
        if self.canary_log2_m and not 5 <= self.canary_log2_m <= 30:
            raise ValueError(f"canary_log2_m must be 0 (disabled) or in "
                             f"[5, 30], got {self.canary_log2_m}")
        if not 1 <= self.canary_k <= 8:
            raise ValueError(f"canary_k must be in [1, 8], got {self.canary_k}")

    @property
    def degraded(self) -> bool:
        """True when n > L: rotations alias mod L and no pairwise bits
        remain — the ban is still exact on true repeats, the FP bound is not."""
        return self.n > self.L

    @property
    def out_bits(self) -> int:
        """Usable (pairwise-independent) bits probes may draw from."""
        return self.L if self.degraded else self.L - self.n + 1

    @property
    def hash_mask(self) -> int:
        """Low-bit keep mask applied to every candidate hash before probe
        derivation (the Theorem-2 discard; full width when degraded)."""
        return (1 << self.out_bits) - 1

    @property
    def m(self) -> int:
        return 1 << self.log2_m

    @property
    def n_words(self) -> int:
        """Packed uint32 words per session filter."""
        return 1 << (self.log2_m - 5)

    @property
    def has_canary(self) -> bool:
        return self.canary_log2_m > 0

    @property
    def canary_words(self) -> int:
        return 1 << (self.canary_log2_m - 5) if self.has_canary else 0


SketchSpec = Union[MinHashSpec, HLLSpec, BloomSpec, CountMinSpec]
_SPEC_TYPES = (MinHashSpec, HLLSpec, BloomSpec, CountMinSpec)


@dataclasses.dataclass(frozen=True)
class SketchPlan:
    """A hash family + named sketches, all fed by one rolling-hash pass.

    ``sketches`` accepts a mapping ``{name: spec}`` or a sequence of
    ``(name, spec)`` pairs; it is normalized to an ordered tuple so the plan
    stays hashable (jit trace key) and the engine's operand/output layout is
    deterministic.
    """

    hash: HashSpec
    sketches: Tuple[Tuple[str, SketchSpec], ...]

    def __post_init__(self):
        if not isinstance(self.hash, HashSpec):
            raise TypeError(f"plan.hash must be a HashSpec, got {type(self.hash)}")
        items = self.sketches
        if isinstance(items, Mapping):
            items = tuple(items.items())
        else:
            items = tuple((name, spec) for name, spec in items)
        if not items:
            raise ValueError("a SketchPlan needs at least one sketch")
        names = [name for name, _ in items]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate sketch names in plan: {names}")
        for name, spec in items:
            if not isinstance(name, str) or not name:
                raise ValueError(f"sketch name must be a non-empty str, got {name!r}")
            if not isinstance(spec, _SPEC_TYPES):
                raise TypeError(
                    f"sketch {name!r}: expected one of "
                    f"{[t.__name__ for t in _SPEC_TYPES]}, got {type(spec)}")
            if isinstance(spec, HLLSpec):
                spec.resolve_rank_bits(self.hash)   # raises if inconsistent
        object.__setattr__(self, "sketches", items)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.sketches)

    @property
    def needs_second_stream(self) -> bool:
        """Bloom's double hashing draws a second independent family stream."""
        return any(isinstance(s, BloomSpec) for _, s in self.sketches)
