"""Sharded tensors over a :class:`~repro_torch.launch.mesh.ModelMesh` and
the collectives between the mesh's positions.

A :class:`Sharded` tensor holds a global shape, a spec
(:class:`~repro_torch.nn.sharding.PartitionSpec`) and one tensor for each
distinct shard, on the device of the first position (row-major) that
holds it: replicas share it (a replica on another device is copied there
at each read, a broadcast). A position's program reads the slice of a
leaf it needs with :meth:`Sharded.local`, which gathers whatever the spec
splits and the program does not (FSDP's all-gather over ``data``).

Collectives are copies (``.to(device)``, a no-op between virtual shards of
one device) and sums in a fixed rank order, so every rank gets the same
bits; autograd gives their backward (the gather's is a sum into each shard:
a reduce-scatter). Each is counted by kind and bytes in a process-wide
counter (:func:`collective_count`; not context-local, because autograd
runs a card's backward, and the recompute of a checkpointed layer, on a
thread of its own): for each receiving position, the bytes of the pieces
that come from other positions; a backward transfer counts under the
dual kind (an all-gather's under ``reduce_scatter``). A second counter
(:func:`collective_operands`) keeps an SPMD program's convention, which
the dry run's census reads: for each position that takes part in a call,
one call and the bytes of its operand at issue.

Row-parallel partial products are reduced in float32 and rounded to the
activation dtype once, after the sum (:data:`REDUCE_DTYPE`), as one
device's product rounds its float32 accumulator once.
"""
from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.nn.sharding import PartitionSpec, mesh_sizes

Coord = Tuple[int, ...]
Pos = Tuple[int, ...]

REDUCE_DTYPE = torch.float32

_counts: Dict[str, List[int]] = {}           # {kind: [calls, bytes]}
_operands: Dict[str, List[int]] = {}         # {kind: [calls, bytes]}
_lock = threading.Lock()
_DUAL = {"all_gather": "reduce_scatter", "all_reduce": "all_reduce",
         "reduce_scatter": "all_gather"}


def collective_count() -> Dict[str, Dict[str, int]]:
    """``{kind: {"calls", "bytes"}}`` issued since the last reset."""
    with _lock:
        return {k: {"calls": c, "bytes": b} for k, (c, b) in _counts.items()}


def collective_operands() -> Dict[str, Dict[str, int]]:
    """``{kind: {"calls", "bytes"}}`` since the last reset, summed over the
    mesh's positions in the per-device convention of an SPMD program: each
    position that takes part in a call counts one call and its operand's
    bytes at issue (an all-gather's local piece, an all-reduce's whole
    local tensor, a reduce-scatter's whole local input). A collective's
    backward counts under the dual kind, its operand the gradient of the
    forward's output at that position."""
    with _lock:
        return {k: {"calls": c, "bytes": b}
                for k, (c, b) in _operands.items()}


def reset_collectives() -> None:
    with _lock:
        _counts.clear()
        _operands.clear()


def _count(kind: str, nbytes: int, calls: int = 1) -> None:
    with _lock:
        entry = _counts.setdefault(kind, [0, 0])
        entry[0] += calls
        entry[1] += int(nbytes)


def _operand(kind: str, nbytes: int, calls: int = 1) -> None:
    with _lock:
        entry = _operands.setdefault(kind, [0, 0])
        entry[0] += calls
        entry[1] += int(nbytes)


def _operand_backward(out: torch.Tensor, kind: str, share: int = 1) -> None:
    """Count the backward of a collective whose output ``out`` is read by
    ``share`` positions: the dual kind, one call a position, the
    gradient's bytes a position."""
    if out.requires_grad:
        dual = _DUAL[kind]
        out.register_hook(lambda g: _operand(dual, _nbytes(g) * share, share))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _recv(t: torch.Tensor, device, kind: Optional[str]) -> torch.Tensor:
    """``t`` on ``device``; a transfer between positions (``kind`` not
    None) is counted, and so is its backward."""
    out = t.to(device)
    if kind is not None:
        _count(kind, _nbytes(t), calls=0)
        if out.requires_grad:
            dual = _DUAL[kind]
            out.register_hook(lambda g: _count(dual, _nbytes(g)))
    return out


# -- geometry -----------------------------------------------------------------

def _axes_size(sizes, axes) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def block_index(mesh, pos: Pos, axes: Sequence[str]) -> int:
    """The block a position falls in when a dimension is split over
    ``axes`` (major first)."""
    sizes = mesh_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + mesh.index(pos, a)
    return idx


def coord_of(mesh, pos: Pos, spec: PartitionSpec, ndim: int) -> Coord:
    return tuple(block_index(mesh, pos, spec.axes(d)) for d in range(ndim))


def nblocks(mesh, spec: PartitionSpec, ndim: int) -> Tuple[int, ...]:
    sizes = mesh_sizes(mesh)
    return tuple(_axes_size(sizes, spec.axes(d)) for d in range(ndim))


def box_of(shape, nb, coord) -> Tuple[Tuple[int, int], ...]:
    out = []
    for n, k, c in zip(shape, nb, coord):
        w = n // k
        out.append((c * w, (c + 1) * w))
    return tuple(out)


class Sharded:
    """A tensor of global ``shape`` laid out by ``spec`` over ``mesh``:
    ``shards[coord]``, one a distinct block coordinate."""

    def __init__(self, shape, spec: PartitionSpec, mesh,
                 shards: Dict[Coord, torch.Tensor]):
        self.shape = tuple(shape)
        self.spec = PartitionSpec(*(tuple(spec) + (None,) * (
            len(self.shape) - len(spec))))
        self.mesh = mesh
        self.nb = nblocks(mesh, self.spec, len(self.shape))
        for n, k in zip(self.shape, self.nb):
            if n % k:
                raise ValueError(f"{self.spec} does not divide {self.shape}")
        self.shards = shards
        self._owner: Dict[Coord, Pos] = {}
        for pos in mesh.positions():
            self._owner.setdefault(self.coord(pos), pos)

    # geometry
    def coord(self, pos: Pos) -> Coord:
        return coord_of(self.mesh, pos, self.spec, len(self.shape))

    def box(self, coord: Coord):
        return box_of(self.shape, self.nb, coord)

    def owner(self, coord: Coord) -> Pos:
        return self._owner[coord]

    @property
    def dtype(self):
        return next(iter(self.shards.values())).dtype

    @classmethod
    def build(cls, shape, spec, mesh, make: Callable[[Coord, tuple, Pos],
                                                      torch.Tensor]):
        """Each distinct shard from ``make(coord, box, owner position)``."""
        out = cls(shape, spec, mesh, {})
        for coord, pos in out._owner.items():
            out.shards[coord] = make(coord, out.box(coord), pos)
        return out

    @classmethod
    def from_full(cls, t: torch.Tensor, spec, mesh, param: bool = False):
        """Slices of ``t``, each copied to its owner's device."""
        def make(coord, box, pos):
            s = t[tuple(slice(a, b) for a, b in box)].detach().to(
                mesh.device(pos), copy=True).contiguous()
            return torch.nn.Parameter(s) if param else s
        return cls.build(tuple(t.shape), spec, mesh, make)

    def like(self, make: Callable[[torch.Tensor], torch.Tensor]) -> "Sharded":
        """A Sharded of the same layout with ``make(shard)`` a shard."""
        return Sharded(self.shape, self.spec, self.mesh,
                       {c: make(t) for c, t in self.shards.items()})

    # reading
    def assemble(self, ranges, device, at: Optional[Pos] = None
                 ) -> torch.Tensor:
        """The global box ``ranges`` ((start, stop) a dimension) on
        ``device``, from the shards that overlap it; pieces from shards
        other than position ``at``'s own (or on another device) are
        counted as an all-gather's."""
        own = self.coord(at) if at is not None else None
        per_dim = []
        for d, ((lo, hi), n, k) in enumerate(zip(ranges, self.shape,
                                                 self.nb)):
            w = n // k
            blocks = []
            for b in range(lo // w, -(-hi // w)):
                s, e = max(lo, b * w), min(hi, (b + 1) * w)
                if e > s:
                    blocks.append((b, slice(s - b * w, e - b * w)))
            per_dim.append(blocks)
        grid = np.empty(tuple(len(b) for b in per_dim), dtype=object)
        crossed = False
        for idx in itertools.product(*(range(len(b)) for b in per_dim)):
            coord = tuple(per_dim[d][i][0] for d, i in enumerate(idx))
            sl = tuple(per_dim[d][i][1] for d, i in enumerate(idx))
            piece = self.shards[coord][sl]
            mine = coord == own and piece.device == torch.device(device)
            crossed = crossed or not mine
            grid[idx] = _recv(piece, device, None if mine else "all_gather")
        pieces = grid.size
        for d in reversed(range(grid.ndim)):
            if grid.shape[d] == 1:
                grid = grid.take(0, axis=d)
                continue
            out = np.empty(grid.shape[:d] + grid.shape[d + 1:], dtype=object)
            for idx in itertools.product(*(range(n) for n in out.shape)):
                parts = [grid[idx[:d] + (j,) + idx[d:]]
                         for j in range(grid.shape[d])]
                out[idx] = torch.cat(parts, dim=d)
            grid = out
        out = grid.item() if isinstance(grid, np.ndarray) else grid
        if at is not None and crossed:  # a position's gather: its piece
            _operand("all_gather", _nbytes(out) // pieces)
            _operand_backward(out, "all_gather")
        return out

    def local(self, pos: Pos, split: Optional[Dict[int, Sequence[str]]] = None
              ) -> torch.Tensor:
        """What position ``pos``'s program reads: dimension d cut to the
        position's block over ``split[d]``'s mesh axes, every other
        dimension whole. Counted once a call when it gathers."""
        split = split or {}
        sizes = mesh_sizes(self.mesh)
        ranges = []
        for d, n in enumerate(self.shape):
            axes = split.get(d)
            if axes:
                axes = (axes,) if isinstance(axes, str) else tuple(axes)
                k = _axes_size(sizes, axes)
                w = n // k
                i = block_index(self.mesh, pos, axes)
                ranges.append((i * w, (i + 1) * w))
            else:
                ranges.append((0, n))
        dev = self.mesh.device(pos)
        own = self.shards[self.coord(pos)]
        if tuple(ranges) == self.box(self.coord(pos)) and own.device == dev:
            return own
        _count("all_gather", 0)
        return self.assemble(ranges, dev, at=pos)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's home)."""
        dev = device if device is not None else self.mesh.home
        return self.assemble([(0, n) for n in self.shape], dev)

    def copy_from(self, full: torch.Tensor) -> None:
        """Write the slices of the global ``full`` into the shards, in
        place."""
        with torch.no_grad():
            for coord, t in self.shards.items():
                box = self.box(coord)
                t.copy_(full[tuple(slice(a, b) for a, b in box)])


# -- collectives over activations ---------------------------------------------

def groups(mesh, axes: Sequence[str]) -> List[List[Pos]]:
    """The positions in groups that differ only on ``axes``, each group in
    rank order over ``axes`` (major first)."""
    axes = tuple(a for a in axes if a in mesh.axis_names)
    out: Dict[tuple, List[Pos]] = {}
    for pos in mesh.positions():
        key = tuple(i for a, i in zip(mesh.axis_names, pos) if a not in axes)
        out.setdefault(key, []).append(pos)
    for g in out.values():
        g.sort(key=lambda p: block_index(mesh, p, axes))
    return list(out.values())


def _collect(vals: Dict[Pos, torch.Tensor], mesh, axes, kind: str,
             combine: Callable[[List[torch.Tensor]], torch.Tensor]
             ) -> Dict[Pos, torch.Tensor]:
    """For each group over ``axes``: on each distinct device of the group,
    ``combine`` of every member's tensor moved there (in rank order);
    every member on that device gets that result."""
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes or _axes_size(mesh_sizes(mesh), axes) == 1:
        return dict(vals)
    out: Dict[Pos, torch.Tensor] = {}
    for group in groups(mesh, axes):
        _count(kind, 0)
        by_dev: Dict[torch.device, torch.Tensor] = {}
        share: Dict[torch.device, int] = {}
        for pos in group:
            dev = mesh.device(pos)
            _operand(kind, _nbytes(vals[pos]))
            if dev not in by_dev:
                by_dev[dev] = combine([
                    _recv(vals[p], dev, None if p == pos else kind)
                    for p in group])
            else:               # the transfers this position would take
                for p in group:
                    if p != pos:
                        _count(kind, _nbytes(vals[p]), calls=0)
            share[dev] = share.get(dev, 0) + 1
            out[pos] = by_dev[dev]
        for dev, t in by_dev.items():
            _operand_backward(t, kind, share[dev])
    return out


def _sum(ts: List[torch.Tensor]) -> torch.Tensor:
    acc = ts[0]
    for t in ts[1:]:
        acc = acc + t
    return acc


def all_reduce(vals: Dict[Pos, torch.Tensor], mesh, axes
               ) -> Dict[Pos, torch.Tensor]:
    """Sum over the positions that differ only on ``axes``, in rank
    order."""
    if isinstance(axes, str):
        axes = (axes,)
    return _collect(vals, mesh, axes, "all_reduce", _sum)


def all_gather(vals: Dict[Pos, torch.Tensor], mesh, axes, dim: int,
               stack: bool = False) -> Dict[Pos, torch.Tensor]:
    """Concatenate (or stack, on a new leading dimension ``dim``) over
    the positions that differ only on ``axes``, in rank order."""
    if isinstance(axes, str):
        axes = (axes,)
    axes_in = tuple(a for a in axes if a in mesh.axis_names)
    if stack and (not axes_in or
                  _axes_size(mesh_sizes(mesh), axes_in) == 1):
        return {p: t.unsqueeze(dim) for p, t in vals.items()}
    cat = (lambda ts: torch.stack(ts, dim)) if stack else \
        (lambda ts: torch.cat(ts, dim))
    return _collect(vals, mesh, axes, "all_gather", cat)


def reduce_scatter(vals: Dict[Pos, torch.Tensor], mesh, axes,
                   dim: int) -> Dict[Pos, torch.Tensor]:
    """Sum over the positions that differ only on ``axes``, each keeping
    its rank's block of dimension ``dim``: only the block is moved."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    k = _axes_size(mesh_sizes(mesh), axes) if axes else 1
    if k == 1:
        return dict(vals)
    out = {}
    for group in groups(mesh, axes):
        _count("reduce_scatter", 0)
        for pos in group:
            i = block_index(mesh, pos, axes)
            dev = mesh.device(pos)
            _operand("reduce_scatter", _nbytes(vals[pos]))
            parts = []
            for p in group:
                t = vals[p]
                w = t.shape[dim] // k
                blk = t.narrow(dim, i * w, w)
                parts.append(_recv(blk, dev,
                                   None if p == pos else "reduce_scatter"))
            out[pos] = _sum(parts)
            _operand_backward(out[pos], "reduce_scatter")
    return out


def gather_home(mesh, vals: Dict[Pos, torch.Tensor], axes, dim: int = 0
                ) -> torch.Tensor:
    """The distinct blocks over ``axes`` (each its first position's)
    concatenated on dimension ``dim`` on the mesh's home device (one
    result, not one a position)."""
    axes = tuple(a for a in axes if a in mesh.axis_names)
    seen: Dict[int, torch.Tensor] = {}
    for pos in mesh.positions():
        seen.setdefault(block_index(mesh, pos, axes), vals[pos])
    parts = [seen[i] for i in sorted(seen)]
    if len(parts) > 1:           # each block's holder sends its piece
        for t in parts:
            _operand("all_gather", _nbytes(t))
    home = mesh.home
    moved = [_recv(t, home, None if i == 0 else "all_gather")
             for i, t in enumerate(parts)]
    if len(moved) > 1:
        _count("all_gather", 0)
    return torch.cat(moved, dim) if len(moved) > 1 else moved[0]


class Scope:
    """The :class:`Sharded` leaves of a model by the port's parameter
    names, seen under a prefix (``blocks.3.u0.``)."""

    def __init__(self, leaves: Dict[str, Sharded], prefix: str = ""):
        self.leaves, self.prefix = leaves, prefix

    def __getitem__(self, name: str) -> Sharded:
        return self.leaves[self.prefix + name]

    def __contains__(self, name: str) -> bool:
        return self.prefix + name in self.leaves

    def sub(self, prefix: str) -> "Scope":
        return Scope(self.leaves, self.prefix + prefix)

    def split(self, name: str, dim: int, axis: str = "model") -> bool:
        """Whether the leaf's dimension ``dim`` is split over ``axis``."""
        return self[name].spec.axes(dim) == (axis,)

    def local(self, name: str, pos: Pos, split=None) -> torch.Tensor:
        return self[name].local(pos, split)

    def linear(self, name: str, pos: Pos, split=None, n_in: int = 1):
        """A linear's ``w`` (and ``b``, whose dimensions are ``w``'s past
        the ``n_in`` input ones) as a position reads them."""
        from types import SimpleNamespace
        split = split or {}
        b = None
        if f"{name}.b" in self:
            b = self.local(f"{name}.b", pos,
                           {d - n_in: a for d, a in split.items()
                            if d >= n_in})
        return SimpleNamespace(w=self.local(f"{name}.w", pos, split), b=b)

    def norm(self, name: str, pos: Pos):
        from types import SimpleNamespace
        return SimpleNamespace(scale=self.local(f"{name}.scale", pos))
