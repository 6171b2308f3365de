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

Executors. The JAX package folds a block of chunks into one ``lax.scan``
dispatch; here a block is either

* the **eager loop** — one plan launch per chunk issued from Python, the
  loop's own carry donated from the second chunk on (the kernel folds into
  it in place); or
* one **CUDA-graph replay** (:class:`_BlockGraph`) — the same loop captured
  once for a fixed ``(T, B, C)`` block shape, its operands and its chunk
  and carry buffers at fixed addresses, and replayed as one dispatch: the
  caller's carry and chunks are copied into the graph's static inputs and
  the carry out is copied out, so neither the caller's state nor a
  returned state is ever overwritten by a later replay.

:func:`update_many` replays the graph on CUDA (the card measurement that
chose it is in PERF.md) and runs the eager loop through the plain versions
on the CPU. :func:`run_stream` takes ``executor="host"`` (one
:func:`update` per chunk), ``"grid"`` (one :func:`update` over the whole
stream: the plan kernel's own tile loop is the chunk loop) or ``"scan"``
(the graph replay). :func:`dispatch_count` counts the dispatches of all of
them. :func:`feed` overlaps the next block's host->device copy (pinned
memory, ``non_blocking``) with the current block's kernels.
:func:`staged_bytes` counts the bytes of host arrays sent to a stream's
device, :func:`graph_captures` the graphs captured; a profiler that
records sees the spans ``stream.update_many`` and ``stream.stage``
(:mod:`repro_torch.trace`).

:func:`export_state` / :func:`import_state` move a carry to host numpy
trees and back, in the JAX package's layout, so a stream checkpointed by
either package resumes in the other.

Under a 1-D data mesh (``mesh`` / ``data_shards``,
:mod:`repro_torch.kernels.shard`) the carry is row-sharded: ``init_state``
pads the batch to a multiple of the shard count d (pad rows never submit
symbols) and the state holds each shard's rows, an ordinary carry, on its
device: ``{"mesh": mesh, "shards": [carry, ...]}``. Every update runs each
shard's rows on its own device (on CUDA, :func:`update_many` replays a
graph captured for that shard). A global sketch (HLL, CountMin) keeps a
per-shard partial — the first shard's from the caller's carry, the others'
from the sketch's identity — merged with the sketch's own operator at
:func:`finalize` and :func:`export_state`, which is bit-identical to
merging after every chunk because max and integer addition re-bracket
exactly. The export is mesh-independent, so a stream saved at one shard
count resumes at any other (:func:`import_state`). :func:`dispatch_count`
counts a sharded call as the same call without a mesh.
"""
from __future__ import annotations

import collections
import contextvars
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.analysis.contracts import kernel_contract
from repro_torch.kernels import api, shard
from repro_torch.kernels import sketch_fused as _sf
from repro_torch.kernels.plan import SketchPlan

_EXECUTORS = ("scan", "grid", "host")

# dispatches issued by this module's executors: one per update (one plan
# launch), one per graph replay (a whole block) and one per "grid" stream.
# Context-local, as the JAX package's counter: concurrent streams each see
# only their own
_dispatches = contextvars.ContextVar("repro_torch.kernels.stream._dispatches",
                                     default=0)


def dispatch_count() -> int:
    """Chunk-executor dispatches issued in this context."""
    return _dispatches.get()


def _dispatched(n: int = 1) -> None:
    _dispatches.set(_dispatches.get() + n)


# bytes of host arrays sent to a device by _to_device, and captures of
# _BlockGraph; context-local and monotonic, as the dispatch count
_staged = contextvars.ContextVar("repro_torch.kernels.stream._staged",
                                 default=0)
_captures = contextvars.ContextVar("repro_torch.kernels.stream._captures",
                                   default=0)


def staged_bytes() -> int:
    """Bytes of host arrays sent to a stream's device in this context (on
    the CPU too, where nothing is copied)."""
    return _staged.get()


def graph_captures() -> int:
    """CUDA graphs of a block shape captured in this context: in a warmed-up
    run of fixed shapes it stays put."""
    return _captures.get()


def _resolve_mesh(mesh, data_shards, device):
    mesh = shard.resolve(mesh, data_shards, device)
    if mesh is not None:
        shard.check_1d(mesh, "streaming")
    return mesh


def _sharded(state: Dict) -> bool:
    return "shards" in state


def _home(state: Dict) -> torch.device:
    """Where a carry's updates take their inputs: its device, or its
    mesh's first device."""
    return state["mesh"].home if _sharded(state) else state["seen"].device


def _check_mesh(state: Dict, mesh, data_shards) -> None:
    """A ``mesh``/``data_shards`` given to an update must be the one the
    carry was laid out on (:func:`import_state` re-lays it out)."""
    want = _resolve_mesh(mesh, data_shards, _home(state))
    if want is not None and want != state.get("mesh"):
        raise ValueError(f"the stream state is laid out on "
                         f"{state.get('mesh')}, not on {want}: export it "
                         f"and import_state it onto that mesh")


def _cat_u32(parts, dim: int) -> torch.Tensor:
    """``torch.cat`` of uint32 tensors through their int32 view."""
    return torch.cat([p.view(torch.int32) for p in parts],
                     dim=dim).view(torch.uint32)


def state_batch(plan: SketchPlan, state: Dict) -> int:
    """The (shard-padded) batch size a stream state was built for."""
    if _sharded(state):
        return sum(s["seen"].shape[0] for s in state["shards"])
    return state["seen"].shape[0]


def _split_state(plan: SketchPlan, state: Dict, mesh) -> Dict:
    """A carry -> the same carry row-sharded over ``mesh``: its rows padded
    to a multiple of d (tails and counts 0, row sketches at their
    identity) and split, each block on its shard's device; a global
    sketch's state on the first shard, its identity on the others."""
    d = mesh.size
    B = state["seen"].shape[0]
    pad = -B % d
    rows = (B + pad) // d
    full = {k: shard.pad_rows(state[k], pad)
            for k in ("tail", "tail_b", "seen") if k in state}
    sk = {name: shard.pad_rows(state["sketch"][name], pad,
                               spec.state_struct(0)[2])
          for name, spec in plan.sketches if spec.state_kind == "row"}
    shards = []
    for i, dev in enumerate(mesh.devices):
        block = slice(i * rows, (i + 1) * rows)
        s = {k: shard.to_device(v[block], dev).contiguous()
             for k, v in full.items()}
        s["sketch"] = {}
        for name, spec in plan.sketches:
            if spec.state_kind == "row":
                got = shard.to_device(sk[name][block], dev).contiguous()
            elif i == 0:
                got = shard.to_device(state["sketch"][name], dev)
            else:
                got = shard.to_device(torch.full_like(
                    state["sketch"][name], spec.state_struct(0)[2]), dev)
            s["sketch"][name] = got
        shards.append(s)
    return {"mesh": mesh, "shards": shards}


def _join_state(plan: SketchPlan, state: Dict) -> Dict:
    """A row-sharded carry -> one carry of all its (padded) rows on the
    mesh's first device, the global sketches' partials merged."""
    home, parts = state["mesh"].home, state["shards"]
    out = {k: shard.cat_rows([s[k] for s in parts], home)
           for k in ("tail", "tail_b", "seen") if k in parts[0]}
    out["sketch"] = shard.merge_outputs(plan, [s["sketch"] for s in parts],
                                        home)
    return out


def init_state(plan: SketchPlan, batch: int, *, carry: Optional[Dict] = None,
               device="cuda", mesh=None,
               data_shards: Optional[int] = None) -> Dict:
    """Fresh carry for ``batch`` parallel streams under ``plan`` on
    ``device``: ``tail`` (B, n-1) uint32 last-consumed h1 values (plus
    ``tail_b`` for a Bloom plan's second stream), ``seen`` (B,) int32
    consumed-symbol count saturating at ``n-1``, and ``sketch`` — one
    tensor per sketch in its ``state_struct`` shape and dtype, at the
    sketch's identity or seeded from ``carry[name]``.

    With ``mesh`` / ``data_shards`` (a mesh of ``device``'s kind) the batch
    is padded up to a multiple of the shard count and row-sharded over the
    mesh (the module docstring); :func:`finalize` and :func:`export_state`
    slice the padding off with their ``batch``."""
    if not isinstance(plan, SketchPlan):
        raise TypeError(f"plan must be a SketchPlan, got {type(plan)}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    mesh = _resolve_mesh(mesh, data_shards, device)
    if mesh is not None:
        device = mesh.home
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
    return state if mesh is None else _split_state(plan, state, mesh)


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
    lengths as (T, B) int32 on the state's (first) device, the checked
    operands and the dispatch flag. A row-sharded carry takes B up to its
    padded rows (the rest idle); another carry exactly its rows."""
    dev = _home(state)
    ref_path = api.use_ref(impl, dev)
    T, B, C = chunks.shape
    if T < 1:
        raise ValueError(f"need at least one chunk, got T={T}")
    Bp = state_batch(plan, state)
    if _sharded(state) and B > Bp:
        raise ValueError(f"chunk rows {B} > stream state rows {Bp}")
    if not _sharded(state) and B != Bp:
        raise ValueError(f"chunk rows {B} != stream state rows {Bp}")
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
    if isinstance(lengths, torch.Tensor):
        return lengths.to(dev).to(torch.int32), operands, ref_path
    # host counts go over through pinned memory, without waiting for the
    # kernels already queued
    return (_to_device(np.ascontiguousarray(lengths, np.int32), dev),
            operands, ref_path)


def _per_shard(state: Dict, chunks, chunk_b, lengths, operands, fn) -> Dict:
    """A row-sharded carry's update: the (T, B, C) block (B up to the
    padded rows, padded here with idle rows) split by rows, and
    ``fn(i, carry, chunks, chunk_b, lengths, operands)`` run for each shard
    i on its own device with its rows and its copy of the operands."""
    mesh, parts = state["mesh"], state["shards"]
    rows = parts[0]["seen"].shape[0]
    pad = rows * mesh.size - chunks.shape[1]
    if pad:
        widen = lambda t: shard.pad_rows(t.transpose(0, 1), pad).transpose(
            0, 1)
        chunks, lengths = widen(chunks), widen(lengths)
        chunk_b = None if chunk_b is None else widen(chunk_b)
    out = []
    for i, (dev, carry) in enumerate(zip(mesh.devices, parts)):
        block = slice(i * rows, (i + 1) * rows)

        def put(t):
            return None if t is None else shard.to_device(t[:, block], dev)

        ops = {name: {k: shard.replicate(v, dev) for k, v in o.items()}
               for name, o in operands.items()}
        with shard.on_device(dev):
            out.append(fn(i, carry, put(chunks), put(chunk_b), put(lengths),
                          ops))
    return {"mesh": mesh, "shards": out}


def update(plan: SketchPlan, state: Dict, chunk, *, chunk_b=None,
           lengths=None, operands=None, impl: str = "auto", mesh=None,
           data_shards: Optional[int] = None) -> Dict:
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
      mesh / data_shards: optional; the mesh the carry was laid out on
        (a row-sharded carry updates on its own mesh either way).
    """
    _check_mesh(state, mesh, data_shards)
    dev = _home(state)
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
    _dispatched()
    if _sharded(state):
        return _per_shard(
            state, chunk[None], None if chunk_b is None else chunk_b[None],
            lengths, operands,
            lambda i, st, c, cb, ln, ops: _update_body(
                plan, ref_path, st, c[0].contiguous(),
                None if cb is None else cb[0].contiguous(), ln[0], ops))
    return _update_body(plan, ref_path, state, chunk, chunk_b, lengths[0],
                        operands)


def update_many(plan: SketchPlan, state: Dict, chunks, *, chunk_b=None,
                lengths=None, operands=None, impl: str = "auto", mesh=None,
                data_shards: Optional[int] = None) -> Dict:
    """Fold a ``(T, B, C)`` block of T chunks into the carry: exactly T
    successive :func:`update` calls (bit-identical carry out), validated
    once for the block.

    On CUDA the block is one replay of the CUDA graph captured for its
    ``(T, B, C)`` shape (:class:`_BlockGraph`): one dispatch, T plan
    launches. With ``impl="ref"`` or on the CPU it is the eager loop of
    plain versions. Either way the caller's ``state`` stays unchanged and
    the returned state is the caller's own (no later call writes it). A
    row-sharded carry runs each shard's rows on its device: on CUDA one
    replay of the graph captured for that shard, d replays a block, counted
    as one dispatch as without a mesh.

    Args mirror :func:`update` with a leading chunk axis:
      chunks: (T, B, C) h1 chunk stack, folded in order.
      chunk_b: (T, B, C) second family draw, iff the plan has a BloomSpec.
      lengths: (T, B) real-symbol counts per chunk (default: all C). A
        finished row submits 0 from some chunk on, so ragged streams pad
        with zero-length chunks. Checked on the host (a CUDA tensor is
        read back once), never inside a capture.
      mesh / data_shards: as :func:`update`.
    """
    with trace.span("stream.update_many"):
        _check_mesh(state, mesh, data_shards)
        dev = _home(state)
        chunks = api.as_u32(chunks, dev)
        if chunks.dim() != 3:
            raise ValueError(f"chunks must be (T, B, C), got shape "
                             f"{tuple(chunks.shape)}")
        chunk_b = _chunk_b(plan, chunk_b, chunks.shape, dev)
        if lengths is not None:
            if not isinstance(lengths, torch.Tensor):
                lengths = np.asarray(lengths)
            if tuple(lengths.shape) != tuple(chunks.shape[:2]):
                raise ValueError(f"lengths shape {tuple(lengths.shape)} != "
                                 f"chunk stack {tuple(chunks.shape[:2])}")
        lengths, operands, ref_path = _block(plan, state, chunks, lengths,
                                             operands, impl, "update_many")
        # the eager loop issues one update a chunk, the graph one replay
        _dispatched(chunks.shape[0] if ref_path else 1)
        if _sharded(state):
            return _per_shard(
                state, chunks, chunk_b, lengths, operands,
                lambda i, st, c, cb, ln, ops: (
                    _eager_block(plan, st, c, cb, ln, ops, ref_path)
                    if ref_path else
                    _graph_block(plan, st, c, cb, ln, ops, shard_index=i)))
        if ref_path:
            return _eager_block(plan, state, chunks, chunk_b, lengths,
                                operands, ref_path)
        return _graph_block(plan, state, chunks, chunk_b, lengths, operands)


def _eager_block(plan, state, chunks, chunk_b, lengths, operands,
                 ref_path: bool) -> Dict:
    """The block as a Python loop: one :func:`update` body (one plan launch
    on the kernel path) per chunk, the loop's own carry donated from the
    second chunk on. Inputs already validated."""
    for t in range(chunks.shape[0]):
        state = _update_body(plan, ref_path, state, chunks[t].contiguous(),
                             None if chunk_b is None
                             else chunk_b[t].contiguous(),
                             lengths[t], operands, donate=t > 0)
    return state


def _flat(state: Dict) -> list:
    """A carry's tensors in a fixed order: tail(s), seen, then the
    sketches in plan order."""
    return ([state[k] for k in ("tail", "tail_b", "seen") if k in state]
            + list(state["sketch"].values()))


def _unflat(like: Dict, flat) -> Dict:
    """Inverse of :func:`_flat` against a carry of the same layout."""
    flat = list(flat)
    out = {k: flat.pop(0) for k in ("tail", "tail_b", "seen") if k in like}
    out["sketch"] = {name: flat.pop(0) for name in like["sketch"]}
    return out


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for 32-bit tensors, uint32 through its int32 view."""
    dst.view(torch.int32).copy_(src.view(torch.int32))


def _clone(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32).clone().view(t.dtype)


class _BlockGraph:
    """One CUDA-graph capture of the eager loop over a fixed ``(T, B, C)``
    block, for one plan and one set of operand tensors.

    The capture reads its carry in, chunks and lengths from static buffers
    and leaves the carry out in static tensors; :meth:`replay` copies the
    caller's inputs in, replays, and returns copies of the carry out. The
    operands are read at the addresses they had at capture time, so the
    cache key holds their ``data_ptr`` values and the entry holds the tensors
    themselves (an address cannot be reused while its graph lives):
    re-bound parameters get a new capture, never the old draw.

    The plan kernel's wrapper counts its launches when it issues them;
    during the capture it issues none, so the counts it took then are
    taken back and added again at every replay, with one dispatch.
    """

    def __init__(self, plan, state, chunks, chunk_b, lengths, operands):
        self.plan = plan
        self.operands = operands          # held: their addresses are baked in
        self.state_in = [_clone(t) for t in _flat(state)]
        self.like = _unflat(state, self.state_in)
        self.chunks = _clone(chunks.contiguous())
        self.chunk_b = None if chunk_b is None else _clone(chunk_b.contiguous())
        self.lengths = lengths.clone()
        dev = chunks.device
        # warm-up on a side stream: the library is built and loaded, its
        # residency cached and the allocator primed before the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = _sf.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        # captured on the block's own card: torch.cuda.graph's default
        # capture stream is made once, on the card current at the first
        # capture, and a second card's launches would miss it
        with torch.cuda.graph(self.graph, stream=side):
            self.state_out = _flat(self._body())
        after = _sf.launch_counts()
        self.counts = {k: after[k] - before[k] for k in after}
        _sf.add_launch_counts(self.counts, -1)

    def _body(self) -> Dict:
        state = _unflat(self.like, self.state_in)
        for t in range(self.chunks.shape[0]):
            state = _update_body(
                self.plan, False, state, self.chunks[t],
                None if self.chunk_b is None else self.chunk_b[t],
                self.lengths[t], self.operands, donate=t > 0)
        return state

    def replay(self, state, chunks, chunk_b, lengths) -> Dict:
        for dst, src in zip(self.state_in, _flat(state)):
            _copy_into(dst, src)
        _copy_into(self.chunks, chunks)
        if chunk_b is not None:
            _copy_into(self.chunk_b, chunk_b)
        self.lengths.copy_(lengths)
        self.graph.replay()
        _sf.add_launch_counts(self.counts)
        return _unflat(self.like, [_clone(t) for t in self.state_out])


# captures by (plan, device, shard, block shape, second stream, operand
# addresses); the least recently replayed goes first past _GRAPHS_KEPT
_GRAPHS_KEPT = 64
_graphs: "collections.OrderedDict[tuple, _BlockGraph]" = \
    collections.OrderedDict()


def _graph_key(plan, chunks, chunk_b, operands, shard_index=None) -> tuple:
    ptrs = tuple((name, op, t.data_ptr())
                 for name in sorted(operands)
                 for op, t in sorted(operands[name].items()))
    return (plan, str(chunks.device), shard_index, tuple(chunks.shape),
            chunk_b is not None, ptrs)


def _graph_block(plan, state, chunks, chunk_b, lengths, operands,
                 shard_index: Optional[int] = None) -> Dict:
    """The block as one replay of its cached :class:`_BlockGraph` (captured
    on first use). Inputs already validated on the host. ``shard_index``:
    the mesh shard the carry is — a graph belongs to one device, and two
    virtual shards on one device each need their own buffers."""
    key = _graph_key(plan, chunks, chunk_b, operands, shard_index)
    graph = _graphs.get(key)
    if graph is None:
        graph = _BlockGraph(plan, state, chunks, chunk_b, lengths, operands)
        _captures.set(_captures.get() + 1)
        _graphs[key] = graph
        while len(_graphs) > _GRAPHS_KEPT:
            _graphs.popitem(last=False)
    _graphs.move_to_end(key)
    return graph.replay(state, chunks, chunk_b, lengths)


def _to_device(a, dev: torch.device):
    """Host block -> ``dev``. On CUDA the copy is staged in pinned memory and
    issued ``non_blocking``, so it overlaps the kernels already queued."""
    dev = torch.device(dev)
    if isinstance(a, torch.Tensor) and a.device.type != "cpu":
        return a.to(dev)
    with trace.span("stream.stage"):
        t = torch.as_tensor(a)
        _staged.set(_staged.get() + t.nbytes)
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)


def feed(plan: SketchPlan, blocks, state: Dict, *, operands=None,
         impl: str = "auto", mesh=None,
         data_shards: Optional[int] = None) -> Dict:
    """Drive :func:`update_many` over a host iterator of chunk blocks, with
    the host->device copy double-buffered: the kernels of block t are queued
    asynchronously, so block t+1 is pulled from the iterator and its copy
    enqueued while block t still computes on the card.

    ``blocks`` yields either a ``(T, B, C)`` chunk stack or a tuple
    ``(chunks, lengths)`` / ``(chunks, lengths, chunk_b)`` with ``lengths``
    (T, B). Lengths stay on the host, where :func:`update_many` checks them
    without waiting for the card. A row-sharded carry takes its blocks on
    its mesh's first device, where :func:`update_many` splits them.
    """
    _check_mesh(state, mesh, data_shards)
    dev = _home(state)

    def _on(a):
        # a block already on the stream's device (the CPU's too) is not
        # staged again
        return (a if isinstance(a, torch.Tensor) and a.device == dev
                else _to_device(a, dev))

    def _put(blk):
        if blk is None:
            return None
        blk = tuple(blk) if isinstance(blk, (tuple, list)) else (blk,)
        chunks, lens, chunk_b = blk + (None,) * (3 - len(blk))
        return _on(chunks), lens, None if chunk_b is None else _on(chunk_b)

    it = iter(blocks)
    cur = _put(next(it, None))
    while cur is not None:
        chunks, lens, chunk_b = cur
        state = update_many(plan, state, chunks, chunk_b=chunk_b,
                            lengths=lens, operands=operands, impl=impl)
        cur = _put(next(it, None))   # H2D overlaps the queued kernels
    return state


def finalize(plan: SketchPlan, state: Dict,
             batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Extract every sketch's result from a stream carry — the same
    outputs one-shot ``api.run`` would have produced over the concatenated
    stream (a Bloom sketch's counts per row). A row-sharded carry's rows
    are gathered and its global partials merged on its mesh's first
    device; ``batch`` slices the shard padding off the per-row outputs."""
    if _sharded(state):
        state = _join_state(plan, state)
    return {name: (state["sketch"][name] if batch is None
                   or spec.state_kind == "global"
                   else state["sketch"][name][:batch])
            for name, spec in plan.sketches}


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def export_state(plan: SketchPlan, state: Dict,
                 batch: Optional[int] = None) -> Dict:
    """Snapshot a stream carry as a host numpy tree in the JAX package's
    layout: ``tail`` (B, n-1) uint32 (and ``tail_b``), ``seen`` (B,) int32
    and ``sketch`` ``{name: state}``. ``batch`` keeps the first ``batch``
    rows of the per-row leaves (global sketch states pass whole). Every
    leaf is a host copy, safe to hand to a writer thread while the live
    carry keeps changing. Mesh-independent: a row-sharded carry exports
    its gathered rows and merged partials, so the tree restores onto any
    shard count."""
    if _sharded(state):
        state = _join_state(plan, state)
    if batch is None:
        batch = state_batch(plan, state)
    out = {k: _host(state[k][:batch]).copy()
           for k in ("tail", "tail_b", "seen") if k in state}
    out["sketch"] = {
        name: _host(state["sketch"][name][:batch] if spec.state_kind == "row"
                    else state["sketch"][name]).copy()
        for name, spec in plan.sketches}
    return out


def import_state(plan: SketchPlan, tree: Dict, *, device="cuda", mesh=None,
                 data_shards: Optional[int] = None) -> Dict:
    """Rebuild a live carry on ``device`` from an :func:`export_state`
    tree (this package's or the JAX package's), checked against ``plan``:
    the tail's width, ``tail_b`` present exactly when the plan has a Bloom
    sketch, every sketch present in its state shape. With ``mesh`` /
    ``data_shards`` the carry is re-padded and row-sharded for the
    *target* mesh, whatever mesh it was saved from (elastic restore)."""
    if not isinstance(plan, SketchPlan):
        raise TypeError(f"plan must be a SketchPlan, got {type(plan)}")
    mesh = _resolve_mesh(mesh, data_shards, device)
    if mesh is not None:
        device = mesh.home
    n = plan.hash.n
    seen = _host(tree["seen"])
    batch = int(seen.shape[0])
    tail = _host(tree["tail"])
    if tail.shape != (batch, n - 1):
        raise ValueError(f"tail shape {tail.shape} != ({batch}, {n - 1}) — "
                         f"was this state exported under a different plan?")
    state = {"tail": api.as_u32(tail, device).contiguous(),
             "seen": api.as_i32(seen, device).contiguous()}
    if plan.needs_second_stream:
        if "tail_b" not in tree:
            raise ValueError("plan contains a BloomSpec but the exported "
                             "state has no tail_b — family mismatch")
        state["tail_b"] = api.as_u32(_host(tree["tail_b"]),
                                     device).contiguous()
    elif "tail_b" in tree:
        raise ValueError("exported state has tail_b but the plan has no "
                         "BloomSpec — family mismatch")
    missing = set(plan.names) - set(tree["sketch"])
    if missing:
        raise ValueError(f"exported state lacks sketches {sorted(missing)}")
    sketch = {}
    for name, spec in plan.sketches:
        shape, dtype_name, _ = spec.state_struct(batch)
        got = _host(tree["sketch"][name])
        if got.shape != shape:
            raise ValueError(f"sketch {name!r} state shape {got.shape} != "
                             f"{shape}")
        sketch[name] = api.as_state(got, dtype_name, device).contiguous()
    state["sketch"] = sketch
    return state if mesh is None else _split_state(plan, state, mesh)


def _symbol_budget(n_windows, B: int, S: int, n: int) -> np.ndarray:
    """``api.run``'s n_windows (valid windows a row) -> (B,) int64 symbols
    a row consumes on the host: nw valid windows take nw + n - 1 leading
    symbols."""
    W = max(0, S - n + 1)
    if n_windows is None:
        nw = np.full((B,), W, np.int64)
    else:
        api.check_row_counts(n_windows, "n_windows")
        nw = _host(n_windows).astype(np.int64).reshape(-1)
        if nw.shape != (B,):
            raise ValueError(f"n_windows shape {nw.shape} != batch ({B},)")
        nw = np.minimum(nw, W)
    return np.where(nw > 0, nw + n - 1, 0)


@kernel_contract(variant="scan", kernel="plan", launches=1,
                 dispatches="block", merges="global-sketch-merge",
                 donated=("state",))
@kernel_contract(variant="grid", kernel="plan", launches=1, dispatches=1,
                 merges="global-sketch-merge")
@kernel_contract(variant="host", kernel="plan", launches=1,
                 dispatches="chunk", merges="global-sketch-merge")
def run_stream(plan: SketchPlan, h1v, *, chunk_s: int, h1v_b=None,
               n_windows=None, operands=None, impl: str = "auto",
               executor: str = "scan", n_chunks: Optional[int] = None,
               device=None, mesh=None,
               data_shards: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Chunked drop-in for :func:`repro_torch.kernels.api.run`: the same
    arguments (plus ``chunk_s``) and bit-identical outputs, the stream
    consumed in ``chunk_s``-symbol steps with the cross-chunk carry.

    ``executor``:

    * ``"scan"`` (default) — the whole stream as one ``(n_chunks, B,
      chunk_s)`` block: on CUDA one replay of the block's CUDA graph (one
      dispatch), elsewhere the same chunk loop through the plain versions.
      ``n_chunks`` >= ``ceil(S / chunk_s)`` pins the chunk count (shorter
      streams pad with zero-length chunks), so streams of other lengths
      share one capture.
    * ``"grid"`` — one :func:`update` over the whole stream: on CUDA one
      plan launch, whose tile loop over (row, segment) keeps every
      sketch's accumulator resident for the launch. ``chunk_s`` is not
      used.
    * ``"host"`` — a host loop of one-chunk :func:`update` calls, the
      ragged last chunk padded to ``chunk_s``.

    ``device``: as ``api.run`` (``h1v``'s device for a tensor, else
    ``cuda``). ``mesh`` / ``data_shards``: the stream row-sharded over a
    1-D data mesh (a mesh of ``device``'s kind), every executor on each
    shard's rows; the outputs on the mesh's first device.
    """
    if executor not in _EXECUTORS:
        raise ValueError(f"unknown executor={executor!r}; expected one of "
                         f"{_EXECUTORS}")
    if chunk_s < 1:
        raise ValueError(f"chunk_s must be >= 1, got {chunk_s}")
    if not isinstance(plan, SketchPlan):
        raise TypeError(f"plan must be a SketchPlan, got {type(plan)}")
    for name in (operands or {}):
        if "init" in (operands[name] or {}):
            raise ValueError(
                f"sketch {name!r}: do not pass 'init' to run_stream — the "
                f"stream carry supplies every sketch's state")
    n = plan.hash.n
    dev = api.resolve_device(h1v, device)
    mesh = _resolve_mesh(mesh, data_shards, dev)
    if mesh is not None:
        dev = mesh.home
    api.use_ref(impl, dev)                    # validates impl up front
    x, lead = api.flatten(api.as_u32(h1v, dev))
    B, S = x.shape
    xb = None
    if api.needs_second_stream(plan, h1v_b, "h1v_b"):
        xb, _ = api.flatten(api.as_u32(h1v_b, dev))
        if tuple(xb.shape) != (B, S):
            raise ValueError(f"h1v_b shape {tuple(xb.shape)} != h1v shape "
                             f"{(B, S)}")
    sym = _symbol_budget(n_windows, B, S, n)
    nc = max(1, -(-S // chunk_s))
    if n_chunks is not None:
        if n_chunks < nc:
            raise ValueError(f"n_chunks={n_chunks} < ceil(S/chunk_s)={nc}")
        nc = n_chunks
    state = init_state(plan, B, device=dev, mesh=mesh)

    if executor == "grid":
        state = update(plan, state, x, chunk_b=xb,
                       lengths=sym.astype(np.int32), operands=operands,
                       impl=impl)
    else:
        width = nc * chunk_s
        if width > S:            # the ragged tail (and pinned chunks) padded
            x = api._pad_cols(x, width)
            xb = None if xb is None else api._pad_cols(xb, width)
        lens = np.clip(sym[None, :] - np.arange(nc)[:, None] * chunk_s, 0,
                       chunk_s).astype(np.int32)
        if executor == "host":
            for c in range(nc):
                cols = slice(c * chunk_s, (c + 1) * chunk_s)
                state = update(plan, state, x[:, cols],
                               chunk_b=None if xb is None else xb[:, cols],
                               lengths=lens[c], operands=operands, impl=impl)
        else:
            tile = lambda t: (t.view(torch.int32).reshape(B, nc, chunk_s)
                              .transpose(0, 1).contiguous()
                              .view(torch.uint32))
            state = update_many(plan, state, tile(x),
                                chunk_b=None if xb is None else tile(xb),
                                lengths=lens, operands=operands, impl=impl)
    return api.shape_outputs(plan, finalize(plan, state, batch=B), lead)
