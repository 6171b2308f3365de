"""Fixed-capacity session pool: the decode plane's per-session state.

Serving means many concurrent sequences, each carrying the tiny sketch
state the paper's recursive CYCLIC family needs at decode time:

* ``prefix`` — the rolling hash of the last n-1 sampled tokens,
* ``ring``   — the h1 values of those tokens (to expire the oldest term
  recursively: ``prefix' = (rotl(prefix,1) ^ h1[new]) ^ rotl(h1[old],
  (n-1) mod L)``),
* ``bloom``  — the packed no-repeat Bloom filter of n-grams generated so
  far,

plus saturating warm-up counters and telemetry accumulators. The pool holds
this state for ``capacity`` session slots as one dict of (C, ...) tensors,
as the reference's ``repro/serve/sessions.py`` does. A decode step runs
the decode kernel (:func:`repro_torch.kernels.api.decode`: hash, probe,
mask), then top-k/temperature sampling and the state advance. Where the
reference donates its carry to a jitted step, the port updates the carry
tensors in place. Churn (``admit``/``evict``/``reset``) is a masked update
of the same tensors.

Every uint32 leaf is held as a uint32 tensor (what the kernel reads);
arithmetic on them runs on int64 lanes (:mod:`repro_torch.core.u32`), and
gathers and scatters on their int32 views, which PyTorch implements on
every backend. Sampling draws from an explicit ``torch.Generator`` with
Gumbel-max, as ``jax.random.categorical`` does; the draws are not
threefry's.

Under a data mesh (``mesh`` / ``data_shards``,
:mod:`repro_torch.kernels.shard`) the step and the prompt charge run row
by row over the shards (``shard.rowwise``): each shard's rows of the
carry, the logits and the sampling noise go to its device, the h1 table
and the canary filter are copied to each device, and the rows come back to
the pool's device, written into the pool's own state tensors, so the carry
keeps its storage at any shard count. The step is per row, so no combine
is needed. The sampling noise for all C rows is drawn once on the pool's
device before the split, so a sampled step gives the same tokens at any
shard count.
"""
from __future__ import annotations

import contextvars
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.contracts import kernel_contract
from repro_torch.core import u32
from repro_torch.kernels import api, shard
from repro_torch.kernels import ref as _kref
from repro_torch.kernels.plan import DecodeSpec

# pool operations issued in this context (decode steps, prompt primes and
# churn ops each count one, as the reference counts its jitted dispatches),
# so telemetry reports the same counts as the reference's. Context-local:
# pools served from different asyncio tasks or threads each see their own
_dispatches = contextvars.ContextVar("repro_torch.serve.sessions._dispatches",
                                     default=0)

# leaf -> dtype; every leaf is (C, ...) row state
_LEAVES = {"prefix": torch.uint32, "ring": torch.uint32, "pos": torch.int32,
           "bloom": torch.uint32, "count": torch.int32,
           "active": torch.int32, "steps": torch.uint32,
           "banned_lo": torch.uint32, "banned_hi": torch.uint32,
           "canary_lo": torch.uint32, "canary_hi": torch.uint32}


def dispatch_count() -> int:
    """Session-pool operations issued in this context."""
    return _dispatches.get()


def _dispatched(n: int = 1) -> None:
    _dispatches.set(_dispatches.get() + n)


def _write_back(state: Dict[str, torch.Tensor],
                new: Dict[str, torch.Tensor]) -> None:
    """Copy the leaves of ``new`` that are not already ``state``'s own
    tensors into them, in place (uint32 through the int32 view)."""
    for k, dst in state.items():
        src = new[k]
        if src.data_ptr() == dst.data_ptr():
            continue
        if dst.dtype == torch.uint32:
            dst, src = dst.view(torch.int32), src.view(torch.int32)
        dst.copy_(src)


def _store(dst: torch.Tensor, lanes: torch.Tensor) -> None:
    """Write int64 lanes (uint32 values, or int32 values) into ``dst`` in
    place, in its own dtype."""
    if dst.dtype == torch.uint32:
        dst.view(torch.int32).copy_(lanes.to(torch.uint32).view(torch.int32))
    else:
        dst.copy_(lanes.to(dst.dtype))


def init_state(spec: DecodeSpec, capacity: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    """The pool's carry: every leaf is (C, ...) row state. ``count`` is the
    symbols consumed, saturating at n (only >= n-1 / >= n are read); steps
    and the banned/canary totals are uint32 (lo, hi) pairs with explicit
    carry, the stats-plane idiom."""
    shapes = {"ring": (capacity, spec.n - 1),
              "bloom": (capacity, spec.n_words)}
    return {k: (api.full_u32(shapes.get(k, (capacity,)), 0, device)
                if dt == torch.uint32 else
                torch.zeros(shapes.get(k, (capacity,)), dtype=dt,
                            device=device))
            for k, dt in _LEAVES.items()}


def _bloom_add_rows(words: torch.Tensor, h, k: int, log2_m: int,
                    rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Set the k probe bits of one masked hash per row, in place: ``words``
    (C, m/32) uint32, ``h`` (C,); ``rows`` (C,) bool limits the insert to
    some rows. Returns ``words``.

    Probe derivation is that of ``ref.bloom_probe_hits`` — double hashing
    with the odd stride — so membership is exact for inserted keys. Each
    probe sets one word a row: a gather, an OR and a scatter, in probe
    order, so two probes into one word both land."""
    h = u32.lanes(h)
    stride = u32.mulmod32(h, _kref.BLOOM_STRIDE) | 1
    m_mask = (1 << log2_m) - 1
    w32 = words.view(torch.int32)
    idx = torch.arange(words.shape[0], device=words.device)
    for i in range(k):
        probe = ((h + i * stride) & u32.MASK32) & m_mask
        word = probe >> 5
        cur = u32.lanes(w32[idx, word])
        new = cur | (torch.ones_like(cur) << (probe & 31))
        if rows is not None:
            new = torch.where(rows, new, cur)
        w32[idx, word] = new.to(torch.uint32).view(torch.int32)
    return words


def _advance_rows(spec: DecodeSpec, state: Dict, h1v, live) -> Dict:
    """Consume one symbol per live row, in place: roll the prefix, record
    the completed n-gram in the Bloom filter, expire the oldest term.

    ``h1v`` (C,) holds the symbols' h1 values, already masked to L bits;
    ``live`` (C,) bool gates which rows consume (inactive slots and ragged
    prompt tails pass through untouched). The expiry rotation is ``(n-1)
    mod L`` — mod the hash width — which is exact for every n because rotl
    is L-periodic (n > L degrades the pairwise guarantee, never the
    recursion; see ``DecodeSpec.degraded``)."""
    n, L = spec.n, spec.L
    h1v = u32.lanes(h1v)
    C = h1v.shape[0]
    idx = torch.arange(C, device=h1v.device)
    new_hash = u32.rotl_const(u32.lanes(state["prefix"]), 1, L) ^ h1v
    count = state["count"].to(torch.int64)
    count1 = torch.clamp(count + 1, max=n)
    full = count1 >= n
    # a full window means new_hash is a complete n-gram hash: record it
    # (Theorem-2 discard applied — the filter only ever sees masked bits,
    # matching the probe side of the decode kernel bit for bit)
    _bloom_add_rows(state["bloom"], new_hash & spec.hash_mask, spec.k,
                    spec.log2_m, rows=full & live)
    # expire the oldest symbol from the rolling prefix (recursive update)
    pos = state["pos"].to(torch.int64)
    ring32 = state["ring"].view(torch.int32)
    oldest = u32.lanes(ring32[idx, pos])
    expired = new_hash ^ u32.rotl_const(oldest, (n - 1) % L, L)
    prefix1 = torch.where(full, expired, new_hash)
    ring32[idx, pos] = torch.where(live, h1v, oldest).to(
        torch.uint32).view(torch.int32)
    _store(state["prefix"], torch.where(live, prefix1,
                                        u32.lanes(state["prefix"])))
    _store(state["pos"], torch.where(live, (pos + 1) % (n - 1), pos))
    _store(state["count"], torch.where(live, count1, count))
    return state


def _accum_u64(lo, hi, inc):
    """(lo, hi) uint32 pair += inc, with carry (the stats-plane idiom), on
    int64 lanes."""
    lo, hi = u32.lanes(lo), u32.lanes(hi)
    lo1 = (lo + inc) & u32.MASK32
    return lo1, (hi + (lo1 < lo).to(torch.int64)) & u32.MASK32


def _popcount_rows(packed) -> torch.Tensor:
    """(C, W) uint32 packed mask -> (C,) int64 set-bit counts (mod 2^32, as
    the reference's uint32 sum). PyTorch has no popcount on the CPU, so
    each word is counted by the SWAR bit-slicing reduction."""
    v = u32.lanes(packed)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & u32.MASK32) >> 24
    return v.sum(dim=-1) & u32.MASK32


def draw_noise(shape, temperature: float, gen: Optional[torch.Generator],
               device) -> Optional[torch.Tensor]:
    """The uniforms a sampled step's Gumbel-max reads: ``shape`` float32
    draws from ``gen`` on ``device``; None at temperature 0."""
    if temperature == 0.0:
        return None
    return torch.rand(shape, generator=gen, device=device)


def sample(masked: torch.Tensor, temperature: float, top_k: int,
           gen: Optional[torch.Generator],
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, V) float32 logits -> (C,) int64 tokens: keep the top-k (every
    logit below the k-th largest becomes -1e30), then argmax (the first
    maximum, as ``jnp.argmax``) at temperature 0, else Gumbel-max over
    ``logits / temperature`` with the uniforms ``noise`` (default: drawn
    from ``gen``)."""
    if top_k:
        kth = torch.topk(masked, top_k, dim=-1).values[:, -1:]
        masked = masked.masked_fill(masked < kth, _kref.NEG_LOGIT)
    if temperature == 0.0:
        return torch.argmax(masked, dim=-1)
    u = (noise if noise is not None
         else draw_noise(masked.shape, temperature, gen, masked.device))
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(masked / temperature + gumbel, dim=-1)


def _step_core(spec: DecodeSpec, ref_path: bool, temperature: float,
               top_k: int, state, logits, noise, h1, canary_bits):
    """The whole decode step, purely per row: decode kernel -> sample ->
    advance -> telemetry. Updates ``state`` in place; returns ((C,) int64
    tokens, ``state``). ``noise``: the sampling uniforms (C, V), or None
    at temperature 0."""
    live = state["active"] != 0
    ready = (state["count"] >= spec.n - 1) & live
    out = api.decode(spec, logits, state["prefix"], ready, state["bloom"],
                     h1, canary_bits=canary_bits,
                     impl="ref" if ref_path else "kernel")
    token = sample(out["logits"], temperature, top_k, None, noise)
    _advance_rows(spec, state, h1.view(torch.int32)[token], live)
    zero = torch.zeros((), dtype=torch.int64, device=live.device)
    inc = torch.where(live, _popcount_rows(out["banned"]), zero)
    lo, hi = _accum_u64(state["banned_lo"], state["banned_hi"], inc)
    _store(state["banned_lo"], lo)
    _store(state["banned_hi"], hi)
    if spec.has_canary:
        cinc = torch.where(live, _popcount_rows(out["canary"]), zero)
        lo, hi = _accum_u64(state["canary_lo"], state["canary_hi"], cinc)
        _store(state["canary_lo"], lo)
        _store(state["canary_hi"], hi)
    _store(state["steps"], (u32.lanes(state["steps"])
                            + live.to(torch.int64)) & u32.MASK32)
    return token, state


def _prime_core(spec: DecodeSpec, state, tokens, lengths, h1) -> Dict:
    """Charge prompt symbols into the carry: a loop over the T prompt
    positions (the reference's ``lax.scan``), each a masked
    :func:`_advance_rows` (rows past their own length idle). Updates
    ``state`` in place and returns it."""
    h1v = h1.view(torch.int32)[tokens]                     # (C, T)
    active = state["active"] != 0
    for t in range(tokens.shape[1]):
        _advance_rows(spec, state, h1v[:, t], active & (t < lengths))
    return state


def _churn(op: str, state, mask) -> None:
    """Masked churn, in place: ``evict`` deactivates the rows; ``reset``
    zeroes every leaf of them and (re)activates them."""
    if op == "evict":
        state["active"].masked_fill_(mask, 0)
        return
    for v in state.values():
        v.view(torch.int32 if v.dtype == torch.uint32 else v.dtype)[
            mask] = 0
    state["active"].masked_fill_(mask, 1)


class SessionPool:
    """Fixed-capacity pool of decode-plane sessions.

    Args:
      spec: :class:`~repro_torch.kernels.plan.DecodeSpec`.
      capacity: number of session slots C.
      h1: (V,) uint32 symbol hash table (one family draw); masked to L
        bits once here, so the recursion and the kernel agree bit for bit.
      canary_bits: shared decontam canary filter iff ``spec.has_canary``.
      impl: ``"auto"`` (the decode kernel on CUDA, its plain version on the
        CPU), ``"kernel"`` or ``"ref"``.
      device: where the state lives (default: h1's device if it is a
        tensor, else ``cuda``; under a mesh, the mesh's first device).
      mesh / data_shards: run the step and the prompt charge row by row
        over a 1-D data mesh (an explicit mesh wins; ``data_shards`` makes
        one of ``device``'s kind). The capacity must divide the shard
        count: the carry is split by rows without padding.
    """

    def __init__(self, spec: DecodeSpec, capacity: int, h1, *,
                 canary_bits=None, impl: str = "auto", device=None,
                 mesh=None, data_shards: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.spec = spec
        self.capacity = int(capacity)
        self.device = api.resolve_device(h1, device)
        self.mesh = shard.resolve(mesh, data_shards, self.device)
        if self.mesh is not None:
            if self.capacity % self.mesh.size:
                raise ValueError(
                    f"capacity={capacity} must divide the data mesh "
                    f"({self.mesh.size} shards): the session carry is "
                    f"row-sharded without padding")
            self.device = self.mesh.home
        self._ref_path = api.use_ref(impl, self.device)
        self._set_h1(h1)
        if spec.has_canary:
            if canary_bits is None:
                raise ValueError("spec has a canary filter: pass canary_bits")
            self.canary_bits = api.as_u32(canary_bits,
                                          self.device).contiguous()
        else:
            if canary_bits is not None:
                raise ValueError("canary_bits given but spec.canary_log2_m "
                                 "== 0")
            self.canary_bits = None
        self.state = init_state(spec, self.capacity, self.device)
        self._free = list(range(self.capacity - 1, -1, -1))  # pop() -> slot 0 first
        self._t = 0
        # the sampler's default stream when step() is given no generator
        self._gen = torch.Generator(device=self.device).manual_seed(0)

    def _set_h1(self, h1) -> None:
        h1 = api.as_u32(h1, self.device)
        if h1.dim() != 1:
            raise ValueError(f"h1 must be (V,), got shape {tuple(h1.shape)}")
        self.h1 = u32.keep_low(h1, self.spec.L).contiguous()
        self.vocab = int(h1.shape[0])

    # -- churn ------------------------------------------------------------
    def _mask(self, slots) -> torch.Tensor:
        mask = np.zeros((self.capacity,), dtype=bool)
        mask[np.asarray(slots, dtype=np.int64)] = True
        return torch.from_numpy(mask).to(self.device)

    def admit(self, count: int = 1) -> np.ndarray:
        """Allocate ``count`` free slots, zero their state, mark active.
        Returns the slot ids (the caller's session handles)."""
        if count > len(self._free):
            raise ValueError(f"admit({count}): only {len(self._free)} free "
                             f"slot(s) of {self.capacity}")
        slots = np.array([self._free.pop() for _ in range(count)],
                         dtype=np.int64)
        _dispatched()
        _churn("reset", self.state, self._mask(slots))
        return slots

    def evict(self, slots: Sequence[int]) -> None:
        """Deactivate sessions and return their slots to the free list.
        State (telemetry included) survives until the slot is re-admitted."""
        slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        _dispatched()
        _churn("evict", self.state, self._mask(slots))
        self._free.extend(int(s) for s in slots)

    def reset(self, slots: Sequence[int]) -> None:
        """Zero the state of live sessions in place (fresh conversation,
        same slot)."""
        slots = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        _dispatched()
        _churn("reset", self.state, self._mask(slots))

    # -- the decode plane -------------------------------------------------
    def prime(self, tokens, lengths=None) -> None:
        """Charge prompt tokens into the pool: ``tokens`` (C, T) integers,
        optional per-row ``lengths`` for ragged prompts (rows advance only
        their own first ``lengths[i]`` symbols)."""
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int64)
        if tokens.dim() != 2 or tokens.shape[0] != self.capacity:
            raise ValueError(f"tokens must be ({self.capacity}, T), got "
                             f"shape {tuple(tokens.shape)}")
        T = int(tokens.shape[1])
        if lengths is None:
            lengths = torch.full((self.capacity,), T, dtype=torch.int64,
                                 device=self.device)
        else:
            lengths = torch.as_tensor(lengths, device=self.device).to(
                torch.int64)
            if tuple(lengths.shape) != (self.capacity,):
                raise ValueError(f"lengths shape {tuple(lengths.shape)} != "
                                 f"({self.capacity},)")
        _dispatched()
        core = lambda st, tok, ln, h1: _prime_core(self.spec, st, tok, ln, h1)
        if self.mesh is not None:
            core = shard.rowwise(core, self.mesh, n_row=3)
        _write_back(self.state, core(self.state, tokens, lengths, self.h1))

    @kernel_contract(kernel="decode", launches=1, dispatches=1,
                     merges="none", donated=("state",))
    def step(self, logits, *, generator: Optional[torch.Generator] = None,
             temperature: float = 1.0, top_k: int = 0,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step for every active session.

        ``logits`` (C, V) raw logits (pad-token masking is the caller's
        job); returns (C,) int32 sampled tokens (inactive rows emit a token
        too — callers index by their slot ids). The decode kernel, top-k /
        temperature sampling, the Bloom/ring advance and the telemetry
        accumulation all run on the pool's device(s) with no host sync.
        ``generator`` (on the pool's device) supplies the sampling noise;
        without one the pool's own stream, seeded 0, does. ``noise``: the
        (C, V) uniforms themselves, drawn by the caller (the engine draws
        its batch's rows and pads them to the capacity)."""
        logits = torch.as_tensor(logits, device=self.device)
        if tuple(logits.shape) != (self.capacity, self.vocab):
            raise ValueError(f"logits shape {tuple(logits.shape)} != "
                             f"({self.capacity}, {self.vocab})")
        temperature = float(temperature)
        if noise is None:
            # every row's uniforms drawn here, before any split by rows
            noise = draw_noise(logits.shape, temperature,
                               generator if generator is not None
                               else self._gen, self.device)
        _dispatched()
        core = lambda st, lg, nz, h1, cb: _step_core(
            self.spec, self._ref_path, temperature, int(top_k), st, lg, nz,
            h1, cb)
        if self.mesh is not None:
            core = shard.rowwise(core, self.mesh, n_row=3)
        token, state = core(self.state, logits, noise, self.h1,
                            self.canary_bits)
        _write_back(self.state, state)
        self._t += 1
        return token.to(torch.int32)

    # -- durability --------------------------------------------------------

    def export_state(self) -> Dict:
        """Snapshot the pool: the (C, ...) carry PLUS the hash draw it was
        accumulated under (h1 table, canary filter) and the host-side slot
        allocator and clock, as host numpy arrays in the reference's
        dtypes. The Bloom rows and ring tails are functions of the h1 draw,
        so params travel with state."""
        params = {"h1": self.h1.cpu().numpy()}
        if self.canary_bits is not None:
            params["canary_bits"] = self.canary_bits.cpu().numpy()
        return {"params": params,
                "carry": {k: v.cpu().numpy() for k, v in self.state.items()},
                "free": np.asarray(self._free, np.int64),
                "t": np.int64(self._t)}

    def import_state(self, tree: Dict) -> None:
        """Adopt a snapshot (params first, then the carry accumulated under
        them): the port's own ``export_state`` or the reference's through
        :func:`repro_torch.convert.session_state_from_jax`. The capacity and
        spec of THIS pool must match."""
        params = tree["params"]
        h1 = api.as_u32(params["h1"], self.device)
        if int(h1.shape[0]) != self.vocab:
            raise ValueError(f"snapshot h1 has vocab {h1.shape[0]}, pool "
                             f"expects {self.vocab}")
        self._set_h1(h1)
        if self.spec.has_canary:
            if "canary_bits" not in params:
                raise ValueError("spec has a canary filter but the snapshot "
                                 "carries no canary_bits")
            self.canary_bits = api.as_u32(params["canary_bits"],
                                          self.device).contiguous()
        carry = tree["carry"]
        if int(np.shape(carry["active"])[0]) != self.capacity:
            raise ValueError(
                f"snapshot capacity {np.shape(carry['active'])[0]} != pool "
                f"capacity {self.capacity} (session slots are identity, "
                f"not layout — restore into an equal-capacity pool)")
        state = {}
        for k, dt in _LEAVES.items():
            v = carry[k]
            state[k] = (api.as_u32(v, self.device) if dt == torch.uint32
                        else api.as_i32(v, self.device)).clone()
        self.state = state
        self._free = [int(s) for s in np.asarray(tree["free"], np.int64)]
        self._t = int(tree["t"])

    # -- introspection ----------------------------------------------------
    @property
    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self.state["active"].cpu().numpy())

    @property
    def free_count(self) -> int:
        return len(self._free)
