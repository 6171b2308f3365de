"""Multi-device execution of a :class:`~repro_torch.kernels.plan.SketchPlan`:
one controller, row shards on a 1-D ``data`` mesh.

The sketches of the plan engine are mergeable reductions: a MinHash
signature row and a Bloom hit count depend only on their own document's
windows, an HLL register file merges by elementwise max and a CountMin
table by addition. So the whole hash->sketch data plane splits over
documents with a small combine, and :func:`run_sharded` is
:func:`repro_torch.kernels.api.run` over row blocks:

* one Python process holds a :class:`DataMesh`, an ordered tuple of
  devices; the (B, S) batch (and the second Bloom stream) is padded to a
  multiple of the shard count d and split into d contiguous row blocks —
  the JAX package's ``shard_map`` over ``P("data")`` splits the same way;
* each block's plan runs on its own device, inside ``torch.cuda.device``
  of that device, on its current stream; the sketch operands (MinHash
  remix lanes, the packed Bloom filter, the CountMin row constants) are
  copied once to each distinct device and cached;
* the outputs are merged on the mesh's first device: row sketches
  (MinHash, Bloom) concatenated in shard order, HLL registers folded by
  ``torch.maximum``, CountMin tables by int32 addition, which wraps as the
  reference's ``psum`` does.

Bit-identical at any shard count: padding rows have ``n_windows = 0``, the
masking the kernels already honour, so they give sentinel signatures and
zero counts (sliced off) and no register update; max and integer addition
re-bracket exactly. A "global" ``init`` carry (HLL, CountMin) is held out
of the per-shard pass and folded in once afterwards, so a CountMin carry is
never added d times; "row" carries (MinHash, Bloom) travel with their rows.

A mesh may list one device more than once: its shards then run one after
another on that device (virtual shards, as the JAX package's tests get 8
virtual CPU devices). On the CPU, :func:`data_mesh` gives d virtual shards
of the one CPU device. No collective library is used: the merged arrays
are small (an HLL file of 2^b int32, a CountMin table of a few MiB), and a
copy to the first device does the merge.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis.contracts import kernel_contract
from repro_torch.kernels import api
from repro_torch.kernels.plan import CountMinSpec, HLLSpec, SketchPlan

AXIS = "data"

# the sketch's own merge operator: across shards, and to fold a held-out
# "global" carry into the merged output exactly once (int32 addition wraps,
# as the reference's int32 psum)
_GLOBAL_MERGE = {HLLSpec: torch.maximum, CountMinSpec: torch.add}

# merges of global sketches' per-shard partials issued in this context, by
# operator name ("maximum", "add"): d - 1 a sketch each time d shards'
# outputs are merged (the reference's one pmax or psum). Context-local, as
# the stream's dispatch counter
_merges = contextvars.ContextVar("repro_torch.kernels.shard._merges",
                                 default=())


def merge_count() -> Dict[str, int]:
    """Cross-shard merges issued in this context, by operator name."""
    return dict(_merges.get())


def _merged(op: str) -> None:
    counts = merge_count()
    counts[op] = counts.get(op, 0) + 1
    _merges.set(tuple(counts.items()))


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """An ordered tuple of devices on one axis named ``data``: hashable, so
    it can key caches. A device may appear more than once (virtual shards
    on one card). A CUDA device without an index is taken as ``cuda:0``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (AXIS,)

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        devs = tuple(torch.device("cuda", 0)
                     if d.type == "cuda" and d.index is None else d
                     for d in devs)
        if not devs:
            raise ValueError("a DataMesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a DataMesh's devices must be of one type, got "
                             f"{[str(d) for d in devs]}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def size(self) -> int:
        """The shard count d."""
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """The first device, where inputs are split and outputs merged."""
        return self.devices[0]


@functools.lru_cache(maxsize=None)
def _cached_mesh(devices: tuple) -> DataMesh:
    return DataMesh(devices)


def data_mesh(data_shards: Optional[int] = None, device="cuda") -> DataMesh:
    """A 1-D mesh of ``data_shards`` shards (default: all devices).

    On CUDA the first ``data_shards`` of ``torch.cuda.device_count()`` cards;
    past the count, or at 0, it raises. On the CPU ``data_shards`` virtual
    shards of the one CPU device (default 1). Cached per device tuple, so
    ``data_mesh(d) is data_mesh(d)``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        d = count if data_shards is None else int(data_shards)
        if not 1 <= d <= count:
            raise ValueError(f"data_shards={data_shards} not in [1, {count}] "
                             f"(CUDA devices: {count})")
        return _cached_mesh(tuple(torch.device("cuda", i) for i in range(d)))
    if dev.type == "cpu":
        d = 1 if data_shards is None else int(data_shards)
        if d < 1:
            raise ValueError(f"data_shards={data_shards} must be >= 1")
        return _cached_mesh((dev,) * d)
    raise ValueError(f"no data mesh for device {dev}")


def resolve(mesh: Optional[DataMesh], data_shards: Optional[int],
            device) -> Optional[DataMesh]:
    """The mesh a ``mesh``/``data_shards`` knob pair asks for on ``device``'s
    kind: an explicit mesh wins; None when neither is given."""
    if mesh is None and data_shards is None:
        return None
    return mesh if mesh is not None else data_mesh(data_shards, device)


def check_1d(mesh: DataMesh, what: str) -> None:
    if len(mesh.axis_names) != 1:
        raise ValueError(f"{what} needs a 1-D data mesh, got axes "
                         f"{mesh.axis_names}")


def on_device(dev: torch.device):
    """The context a shard's work runs in: ``torch.cuda.device(dev)`` on a
    card, nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev`` (itself when it is there); uint32 through its int32
    view, which every backend copies."""
    if t.device == dev:
        return t
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(dev).view(torch.uint32)
    return t.to(dev)


# replicated operands by (tensor, its version, device); the least recently
# used goes first past _REPLICAS_KEPT. The entry holds the source tensor, so
# its address is not reused while the copy is cached
_REPLICAS_KEPT = 64
_replicas: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()


def replicate(t: Optional[torch.Tensor], dev: torch.device):
    """A replicated operand on ``dev``: the tensor itself on its own device,
    else one copy a (tensor, version, device), cached — so a CUDA graph
    captured on ``dev`` reads one address for it call after call."""
    if t is None or t.device == dev:
        return t
    key = (t.data_ptr(), t._version, tuple(t.shape), t.dtype, str(dev))
    hit = _replicas.get(key)
    if hit is None or hit[0] is not t:
        hit = (t, to_device(t, dev))
        _replicas[key] = hit
        while len(_replicas) > _REPLICAS_KEPT:
            _replicas.popitem(last=False)
    _replicas.move_to_end(key)
    return hit[1]


def pad_rows(t: torch.Tensor, pad: int, fill: int = 0) -> torch.Tensor:
    """``t`` with ``pad`` rows of ``fill`` appended (uint32 through its int32
    view)."""
    if not pad:
        return t
    u32 = t.dtype == torch.uint32
    v = t.view(torch.int32) if u32 else t
    if u32 and fill >= 1 << 31:
        fill -= 1 << 32
    rows = torch.full((pad,) + tuple(v.shape[1:]), fill, dtype=v.dtype,
                      device=v.device)
    out = torch.cat([v, rows], dim=0)
    return out.view(torch.uint32) if u32 else out


def cat_rows(parts, dev: torch.device) -> torch.Tensor:
    """Row blocks -> one tensor on ``dev``, in order (uint32 through its
    int32 view)."""
    parts = [to_device(p, dev) for p in parts]
    if len(parts) == 1:
        return parts[0]
    if parts[0].dtype == torch.uint32:
        return torch.cat([p.view(torch.int32) for p in parts]).view(
            torch.uint32)
    return torch.cat(parts)


def merge_outputs(plan: SketchPlan, parts, dev: torch.device,
                  carry: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Per-shard plan outputs -> the merged outputs on ``dev``: row sketches
    concatenated in shard order, global ones folded with their own merge
    operator in shard order, then with ``carry[name]`` when given."""
    out = {}
    for name, spec in plan.sketches:
        if spec.state_kind == "row":
            out[name] = cat_rows([p[name] for p in parts], dev)
            continue
        merge = _GLOBAL_MERGE[type(spec)]
        acc = to_device(parts[0][name], dev)
        for p in parts[1:]:
            acc = merge(acc, to_device(p[name], dev))
            _merged(merge.__name__)
        if carry and name in carry:
            acc = merge(acc, to_device(carry[name], dev))
        out[name] = acc
    return out


def sharded_execute(plan: SketchPlan, mesh: DataMesh, ref_path: bool, x, xb,
                    nw, ws, operands) -> Dict[str, torch.Tensor]:
    """The validated, padded (Bp, S) batch (Bp % d == 0) through the plan
    on each shard's device; the merged outputs on the mesh's first device.

    A "global" ``init`` carry (HLL, CountMin) is held out of the per-shard
    pass and folded into the merged output once; a "row" carry (MinHash,
    Bloom) is split with its rows."""
    carry, ops = {}, {}
    for name, spec in plan.sketches:
        o = dict(operands.get(name) or {})
        if spec.state_kind == "global" and "init" in o:
            carry[name] = o.pop("init")
        ops[name] = o
    rows = x.shape[0] // mesh.size
    parts = []
    for i, dev in enumerate(mesh.devices):
        block = slice(i * rows, (i + 1) * rows)

        def put(t):
            return None if t is None else to_device(t[block], dev)

        ops_i = {name: {k: put(v) if k == "init" else replicate(v, dev)
                        for k, v in o.items()}
                 for name, o in ops.items()}
        with on_device(dev):
            parts.append(api.execute(plan, put(x), put(xb), put(nw), ops_i,
                                     ref_path, w_start=put(ws)))
    return merge_outputs(plan, parts, mesh.home, carry)


@kernel_contract(kernel="plan", launches=1, dispatches=0,
                 merges="global-sketch-merge")
def run_sharded(plan: SketchPlan, h1v, *, h1v_b=None, n_windows=None,
                operands=None, impl: str = "auto", w_start=None,
                mesh: Optional[DataMesh] = None,
                data_shards: Optional[int] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """Multi-device :func:`repro_torch.kernels.api.run`: the same arguments
    and outputs (on the mesh's first device), bit-identical at any shard
    count.

    Extra knobs:
      mesh: an explicit 1-D :class:`DataMesh` whose shards split the batch
        by rows. Takes precedence over ``data_shards``.
      data_shards: shortcut for ``data_mesh(data_shards)`` on the kind of
        ``device`` (default: ``h1v``'s device for a tensor, else ``cuda``);
        None means every device.

    The batch is padded to a multiple of the shard count with
    ``n_windows = 0`` rows, which no sketch reduction counts, and the
    padding is sliced off on return.
    """
    if mesh is None:
        mesh = data_mesh(data_shards, api.resolve_device(h1v, device))
    check_1d(mesh, "run_sharded")
    x, xb, nw, ws, operands, lead, ref_path = api.validate(
        plan, h1v, h1v_b, n_windows, operands, impl, w_start, mesh.home)
    B = x.shape[0]
    pad = -B % mesh.size
    if pad:
        x = pad_rows(x, pad)
        xb = None if xb is None else pad_rows(xb, pad)
        nw = pad_rows(nw, pad)
        ws = None if ws is None else pad_rows(ws, pad)
        operands = {name: dict(v) for name, v in operands.items()}
        for name, spec in plan.sketches:
            if spec.state_kind == "row" and "init" in operands[name]:
                operands[name]["init"] = pad_rows(operands[name]["init"], pad)
    out = sharded_execute(plan, mesh, ref_path, x, xb, nw, ws, operands)
    out = {name: out[name] if spec.state_kind == "global" else out[name][:B]
           for name, spec in plan.sketches}
    return api.shape_outputs(plan, out, lead)


def _tree_map(fn, tree):
    """``fn`` on every tensor leaf of a tree of dicts, lists and tuples;
    other leaves (None, numbers) pass through."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _tree_cat(trees, dev: torch.device):
    """Per-shard output trees of one structure -> one tree, every tensor
    leaf concatenated by rows on ``dev``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_cat([t[k] for t in trees], dev) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_cat([t[i] for t in trees], dev)
                           for i in range(len(first)))
    return cat_rows(trees, dev) if isinstance(first, torch.Tensor) else first


@kernel_contract(merges="none")
def rowwise(fn, mesh: DataMesh, n_row: int):
    """Wrap a purely per-row function to run over the mesh's shards.

    ``fn(*args)`` must treat every leading tensor axis as independent rows:
    the first ``n_row`` arguments (each may be a tree of tensors) are split
    into d row blocks, one to each shard's device; the remaining arguments
    go whole to every shard (tensors copied once to each distinct device
    and cached); every output leaf is concatenated by rows on the mesh's
    first device. No combine is needed: the serving plane's session pool is
    pure row state. Row counts must divide the shard count; callers own
    padding.
    """
    check_1d(mesh, "rowwise")
    d = mesh.size

    def wrapped(*args):
        if len(args) <= n_row:
            raise ValueError(f"rowwise(fn, n_row={n_row}) called with only "
                             f"{len(args)} argument(s)")
        outs = []
        for i, dev in enumerate(mesh.devices):

            def split(t):
                if t.shape[0] % d:
                    raise ValueError(f"rowwise: {t.shape[0]} rows do not "
                                     f"split into {d} shards")
                rows = t.shape[0] // d
                return to_device(t[i * rows:(i + 1) * rows], dev)

            shard_args = ([_tree_map(split, a) for a in args[:n_row]]
                          + [_tree_map(lambda t: replicate(t, dev), a)
                             for a in args[n_row:]])
            with on_device(dev):
                outs.append(fn(*shard_args))
        return _tree_cat(outs, mesh.home)

    return wrapped


def run_auto(plan: SketchPlan, h1v, *, mesh: Optional[DataMesh] = None,
             data_shards: Optional[int] = None,
             **kw) -> Dict[str, torch.Tensor]:
    """``api.run`` unless a mesh or a shard count is given — the one dispatch
    the data-plane services (dedup, stats, decontam) thread their
    ``mesh``/``data_shards`` knobs through."""
    if mesh is None and data_shards is None:
        return api.run(plan, h1v, **kw)
    return run_sharded(plan, h1v, mesh=mesh, data_shards=data_shards, **kw)
