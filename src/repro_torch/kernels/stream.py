"""Chunked streaming executor: fixed ``(B, C)`` chunks with a carried state.

The paper's recursive families make n-gram hashing a streaming operation —
O(1) work per symbol with constant state. :func:`update` drives the plan
engine over fixed ``(B, C)`` chunks with an explicit **carry**, so any
stream length — ragged corpora, documents longer than a device buffer,
unbounded token feeds — flows through one executor shape.

How a chunk becomes windows, exactly once:

* The carry holds each row's last ``n-1`` consumed h1 values (``tail``). A
  chunk is hashed as ``cat([tail, chunk])`` — shape ``(B, n-1+C)`` — so the
  ``C`` windows of that array are precisely the windows *ending at* this
  chunk's symbols; a boundary-spanning window is hashed in exactly one
  chunk.
* At the very start of a stream the tail is zero-filled history that no
  window may span: the per-row ``w_start = max(0, n-1 - seen)`` lower mask
  bound excludes those leading windows, where ``seen`` saturates at ``n-1``.
* Every sketch's state rides the carry through its ``init`` operand and is
  folded with its own merge operator inside the kernel (MinHash per-row
  running min, HLL register max, CountMin table add, Bloom hit-count add),
  so a chunked run is bit-identical to one-shot
  :func:`repro_torch.kernels.api.run`.
* A plan with a Bloom sketch hashes a second family draw too; its tail
  rides the carry as ``tail_b`` and every call takes its chunk as
  ``chunk_b``.

Rows advance independently: per-chunk ``lengths`` mark how many of a row's
chunk symbols are real, a finished row submits 0, and an idle row's tail is
preserved verbatim.

The JAX package folds a block of chunks into one ``lax.scan`` dispatch.
Here :func:`update_many` is a Python loop over the block's chunks, one
kernel launch per chunk, with the loop's own carry donated from the second
chunk on (the kernel folds into it in place); all launches are
asynchronous, so the host runs ahead of the card. :func:`feed` overlaps
the next block's host->device copy (pinned memory, ``non_blocking``) with
the current block's kernels. There is no mesh: multi-device streaming,
``export_state``, ``import_state`` and ``run_stream`` are not ported yet
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import api
from repro_torch.kernels.plan import SketchPlan


def _cat_u32(parts, dim: int) -> torch.Tensor:
    """``torch.cat`` of uint32 tensors through their int32 view."""
    return torch.cat([p.view(torch.int32) for p in parts],
                     dim=dim).view(torch.uint32)


def state_batch(plan: SketchPlan, state: Dict) -> int:
    """The batch size a stream state was built for."""
    return state["seen"].shape[0]


def init_state(plan: SketchPlan, batch: int, *, carry: Optional[Dict] = None,
               device="cuda") -> Dict:
    """Fresh carry for ``batch`` parallel streams under ``plan`` on
    ``device``: ``tail`` (B, n-1) uint32 last-consumed h1 values (plus
    ``tail_b`` for a Bloom plan's second stream), ``seen`` (B,) int32
    consumed-symbol count saturating at ``n-1``, and ``sketch`` — one
    tensor per sketch in its ``state_struct`` shape and dtype, at the
    sketch's identity or seeded from ``carry[name]``."""
    if not isinstance(plan, SketchPlan):
        raise TypeError(f"plan must be a SketchPlan, got {type(plan)}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    carry = carry or {}
    unknown = set(carry) - set(plan.names)
    if unknown:
        raise ValueError(f"carry for sketches not in plan: {sorted(unknown)}")
    n = plan.hash.n
    state = {"tail": api.full_u32((batch, n - 1), 0, device),
             "seen": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if plan.needs_second_stream:
        state["tail_b"] = api.full_u32((batch, n - 1), 0, device)
    sketch = {}
    for name, spec in plan.sketches:
        shape, dtype_name, fill = spec.state_struct(batch)
        if name in carry:
            got = api.as_state(carry[name], dtype_name, device)
            if tuple(got.shape) != shape:
                raise ValueError(f"carry[{name!r}] shape {tuple(got.shape)} "
                                 f"!= state shape {shape}")
            sketch[name] = got.contiguous()
        elif dtype_name == "uint32":
            sketch[name] = api.full_u32(shape, fill, device)
        else:
            sketch[name] = torch.full(shape, fill, dtype=torch.int32,
                                      device=device)
    state["sketch"] = sketch
    return state


def _update_body(plan, ref_path, state, chunk, chunk_b, lengths, operands,
                 donate=False):
    """One chunk through the plan engine, carry in / carry out. With
    ``donate`` the kernel folds into the carry's sketch tensors in place:
    only for a carry that nothing but the caller's loop holds."""
    n = plan.hash.n
    seen = state["seen"]
    v = lengths.clamp(0, chunk.shape[1])
    cat = lambda tail, c: _cat_u32([tail, c], 1) if n > 1 else c
    x = cat(state["tail"], chunk)
    xb = cat(state["tail_b"], chunk_b) if "tail_b" in state else None
    # window j of x ends at chunk symbol j: valid iff that symbol is real
    # (j < v) and the window's history is (j >= n-1 - seen, i.e. it does not
    # reach into the zero-filled pre-stream tail)
    ws = (n - 1 - seen).clamp(min=0)
    ops = {name: dict(operands.get(name, {}), init=state["sketch"][name])
           for name, _ in plan.sketches}
    out = api.execute(plan, x, xb, v, ops, ref_path, w_start=ws,
                      donate=donate)

    # tail refresh: the last n-1 *consumed* symbols end at the row's fill
    # level, so gather columns [v, v + n-1) of x — for an idle row (v = 0)
    # that is exactly the old tail, preserved verbatim
    new = {"tail": state["tail"], "seen": (seen + v).clamp(max=n - 1)}
    if "tail_b" in state:
        new["tail_b"] = state["tail_b"]
    if n > 1:
        cols = (v[:, None].to(torch.int64)
                + torch.arange(n - 1, device=v.device)[None, :])
        tail = lambda t: torch.gather(t.view(torch.int32), 1,
                                      cols).view(torch.uint32)
        new["tail"] = tail(x)
        if xb is not None:
            new["tail_b"] = tail(xb)
    new["sketch"] = {name: out[name] for name, _ in plan.sketches}
    return new


def _chunk_b(plan, chunk_b, shape, device):
    """The second stream's chunk(s), required iff the plan has a Bloom
    sketch, in the first stream's shape."""
    if not api.needs_second_stream(plan, chunk_b, "chunk_b"):
        return None
    chunk_b = api.as_u32(chunk_b, device).contiguous()
    if tuple(chunk_b.shape) != tuple(shape):
        raise ValueError(f"chunk_b shape {tuple(chunk_b.shape)} != chunk "
                         f"shape {tuple(shape)}")
    return chunk_b


def _block(plan, state, chunks, lengths, operands, impl, fn):
    """Validate a (T, B, C) chunk block against the carry; returns the
    lengths as (T, B) int32 on the state's device, the checked operands and
    the dispatch flag."""
    dev = state["seen"].device
    ref_path = api.use_ref(impl, dev)
    T, B, C = chunks.shape
    if T < 1:
        raise ValueError(f"need at least one chunk, got T={T}")
    if B != state_batch(plan, state):
        raise ValueError(f"chunk rows {B} != stream state rows "
                         f"{state_batch(plan, state)}")
    for name in (operands or {}):
        if "init" in (operands[name] or {}):
            raise ValueError(
                f"sketch {name!r}: do not pass 'init' to stream.{fn} — the "
                f"stream carry supplies every sketch's state")
    operands = api._check_operands(plan, operands, None, dev)
    if lengths is None:
        return (torch.full((T, B), C, dtype=torch.int32, device=dev),
                operands, ref_path)
    # out-of-range lengths silently corrupt the carry: a negative one drives
    # `seen` backwards and re-gathers the tail at wrong columns
    api.check_row_counts(lengths, "lengths", upper=C)
    return api.as_i32(lengths, dev), operands, ref_path


def update(plan: SketchPlan, state: Dict, chunk, *, chunk_b=None,
           lengths=None, operands=None, impl: str = "auto") -> Dict:
    """Fold one ``(B, C)`` h1 chunk into the stream carry; returns the new
    carry (same shapes and dtypes). One kernel launch on CUDA.

    Args:
      plan: the :class:`SketchPlan` the state was initialised for.
      state: carry from :func:`init_state` or a previous :func:`update`.
      chunk: (B, C) h1-mapped values, any C >= 1.
      chunk_b: (B, C) second family draw's chunk, required iff the plan has
        a :class:`BloomSpec`.
      lengths: (B,) count of *real* symbols per row in this chunk (default:
        all C). Rows advance independently; finished or idle rows submit 0
        and their carry rides through untouched.
      operands: the per-sketch runtime operands of ``api.run`` WITHOUT
        ``init``; the carry supplies every sketch's state.
    """
    dev = state["seen"].device
    chunk = api.as_u32(chunk, dev).contiguous()
    if chunk.dim() != 2:
        raise ValueError(f"chunk must be (B, C), got shape "
                         f"{tuple(chunk.shape)}")
    chunk_b = _chunk_b(plan, chunk_b, chunk.shape, dev)
    if lengths is not None:
        lengths = (lengths if isinstance(lengths, torch.Tensor)
                   else np.asarray(lengths)).reshape(-1)
        if tuple(lengths.shape) != (chunk.shape[0],):
            raise ValueError(f"lengths shape {tuple(lengths.shape)} != "
                             f"batch ({chunk.shape[0]},)")
        # checked here too, so an error names the row as (B,) counts do
        api.check_row_counts(lengths, "lengths", upper=chunk.shape[1])
        lengths = lengths[None]
    lengths, operands, ref_path = _block(plan, state, chunk[None], lengths,
                                         operands, impl, "update")
    return _update_body(plan, ref_path, state, chunk, chunk_b, lengths[0],
                        operands)


def update_many(plan: SketchPlan, state: Dict, chunks, *, chunk_b=None,
                lengths=None, operands=None, impl: str = "auto") -> Dict:
    """Fold a ``(T, B, C)`` block of T chunks into the carry: exactly T
    successive :func:`update` calls (bit-identical carry out), validated
    once for the block, one kernel launch per chunk on CUDA.

    The carry of chunks 1..T-1 is the loop's own, so its sketch tensors are
    donated to the kernel (folded in place, no fill a launch), as the JAX
    package donates its steady-state carry. Chunk 0 reads the caller's
    ``state``, which is never donated and stays unchanged.

    Args mirror :func:`update` with a leading chunk axis:
      chunks: (T, B, C) h1 chunk stack, folded in order.
      chunk_b: (T, B, C) second family draw, iff the plan has a BloomSpec.
      lengths: (T, B) real-symbol counts per chunk (default: all C). A
        finished row submits 0 from some chunk on, so ragged streams pad
        with zero-length chunks.
    """
    dev = state["seen"].device
    chunks = api.as_u32(chunks, dev)
    if chunks.dim() != 3:
        raise ValueError(f"chunks must be (T, B, C), got shape "
                         f"{tuple(chunks.shape)}")
    chunk_b = _chunk_b(plan, chunk_b, chunks.shape, dev)
    if lengths is not None:
        if not isinstance(lengths, torch.Tensor):
            lengths = np.asarray(lengths)
        if tuple(lengths.shape) != tuple(chunks.shape[:2]):
            raise ValueError(f"lengths shape {tuple(lengths.shape)} != chunk "
                             f"stack {tuple(chunks.shape[:2])}")
    lengths, operands, ref_path = _block(plan, state, chunks, lengths,
                                         operands, impl, "update_many")
    for t in range(chunks.shape[0]):
        state = _update_body(plan, ref_path, state, chunks[t].contiguous(),
                             None if chunk_b is None
                             else chunk_b[t].contiguous(),
                             lengths[t], operands, donate=t > 0)
    return state


def _to_device(a, dev: torch.device):
    """Host block -> ``dev``. On CUDA the copy is staged in pinned memory and
    issued ``non_blocking``, so it overlaps the kernels already queued."""
    dev = torch.device(dev)
    if isinstance(a, torch.Tensor) and a.device.type != "cpu":
        return a.to(dev)
    t = torch.as_tensor(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def feed(plan: SketchPlan, blocks, state: Dict, *, operands=None,
         impl: str = "auto") -> Dict:
    """Drive :func:`update_many` over a host iterator of chunk blocks, with
    the host->device copy double-buffered: the kernels of block t are queued
    asynchronously, so block t+1 is pulled from the iterator and its copy
    enqueued while block t still computes on the card.

    ``blocks`` yields either a ``(T, B, C)`` chunk stack or a tuple
    ``(chunks, lengths)`` / ``(chunks, lengths, chunk_b)`` with ``lengths``
    (T, B). Lengths stay on the host, where :func:`update_many` checks them
    without waiting for the card.
    """
    dev = state["seen"].device

    def _put(blk):
        if blk is None:
            return None
        blk = tuple(blk) if isinstance(blk, (tuple, list)) else (blk,)
        chunks, lens, chunk_b = blk + (None,) * (3 - len(blk))
        return (_to_device(chunks, dev), lens,
                None if chunk_b is None else _to_device(chunk_b, dev))

    it = iter(blocks)
    cur = _put(next(it, None))
    while cur is not None:
        chunks, lens, chunk_b = cur
        state = update_many(plan, state, chunks, chunk_b=chunk_b,
                            lengths=lens, operands=operands, impl=impl)
        cur = _put(next(it, None))   # H2D overlaps the queued kernels
    return state


def finalize(plan: SketchPlan, state: Dict) -> Dict[str, torch.Tensor]:
    """Extract every sketch's result from a stream carry — the same
    outputs one-shot ``api.run`` would have produced over the concatenated
    stream (a Bloom sketch's counts per row)."""
    return {name: state["sketch"][name] for name, _ in plan.sketches}
