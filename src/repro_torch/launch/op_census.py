"""The dry run's census of one step: its matrix-product FLOPs, the bytes
its ops move, its collectives and the peak of the memory it makes, counted
while the step runs: on ``meta`` tensors (shapes without data, nothing
computed) or on a card.

The counterpart of the JAX package's ``repro/launch/hlo_analysis.py``,
which reads these off a compiled program's HLO text. The port has no HLO:
:func:`census` runs the step under a ``TorchDispatchMode`` that sees every
aten op it dispatches, the backward's included, and the reference's
functions here (:func:`dot_flops`, :func:`collective_bytes`,
:func:`count_collectives`) read a census record in its place, per device.

* dot FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  matrix products (mm, addmm, bmm, baddbmm), 2 * numel(result) * K each,
  the reference's convention; convolutions and elementwise work are not
  counted, as the reference counts only ``dot`` ops.
* bytes (computed): the bytes of every tensor input and output of each
  aten op that is not a view, not a bare allocation and not a copy from
  the host. This is the eager program's traffic, each op reading its
  inputs from and writing its outputs to device memory; it is not XLA's
  fused ``bytes accessed``. The same step counts the same on ``meta``,
  on the CPU and on a card.
* collectives: ``nn.collectives.collective_operands()``, an SPMD
  program's convention: operand bytes at issue and one call for each call
  a position takes part in.
* peak bytes (an estimate of the step's temporary memory): the storages
  the step's ops make, each counted from the op that makes it until it is
  freed; the step's arguments are not among them.

The reference's ``async_collective_pairs`` has no counterpart: the port
issues no asynchronous halves of a collective.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.nn import collectives

aten = torch.ops.aten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the port's collective kinds under the reference's HLO names
_KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter": "reduce-scatter"}
MATMULS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
# ops that move no bytes: views, and allocations that write nothing
_NO_TRAFFIC = {aten.view, aten.reshape, aten.expand, aten.as_strided,
               aten.t, aten.transpose, aten.permute, aten.select, aten.slice,
               aten.squeeze, aten.unsqueeze, aten.alias, aten.detach,
               aten._unsafe_view, aten.empty, aten.empty_like,
               aten.empty_strided, aten.new_empty}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _written(func, args, kwargs) -> list:
    """The tensors an op writes in place (its schema's mutable
    arguments)."""
    if not func._schema.is_mutable:
        return []
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        out += [t for t in pytree.tree_leaves(v)
                if isinstance(t, torch.Tensor)]
    return out


class _Traffic(TorchDispatchMode):
    """Bytes of every op that is not a view, and the live bytes of the
    storages the ops make (each freed storage taken off by a finalizer,
    from whatever thread frees it)."""

    def __init__(self):
        super().__init__()
        self.bytes = self.ops = self.live = self.peak = 0
        self.by_op: Dict[str, int] = {}
        self._live: Dict[int, int] = {}
        self._lock = threading.Lock()

    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        written = _written(func, args, kwargs)
        versions = [t._version for t in written]
        out = func(*args, **kwargs)
        # a foreach op that writes in place, dispatched to a Python mode,
        # leaves its tensors' version counters as they were: move them as
        # the op does outside the census
        for t, v in zip(written, versions):
            if t._version == v:
                torch.autograd.graph.increment_version(t)
        if func.overloadpacket in _NO_TRAFFIC or func.is_view:
            return out
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if any(t.device.type == "cpu" for t in ins) and any(
                t.device.type != "cpu" for t in outs):
            return out          # a copy from the host, not device traffic
        have = {t.untyped_storage()._cdata for t in ins}
        moved = sum(_nbytes(t) for t in ins + outs)
        name = str(func.overloadpacket)
        with self._lock:
            self.ops += 1
            self.bytes += moved
            self.by_op[name] = self.by_op.get(name, 0) + moved
            for t in outs:
                st = t.untyped_storage()
                key = st._cdata
                if key in have or key in self._live:
                    continue
                self._live[key] = st.nbytes()
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key)
        return out


def census(fn: Callable, *args, positions: int = 1, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the census; ``positions`` is
    the number of mesh positions whose local programs the call runs (1
    without a mesh). Resets the process-wide collective counter. Returns
    (fn's result, the census record: totals over every position)."""
    collectives.reset_collectives()
    flops = FlopCounterMode(display=False)
    traffic = _Traffic()
    t0 = time.perf_counter()
    with flops, traffic:
        out = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    by_op = flops.get_flop_counts().get("Global", {})
    coll = collectives.collective_operands()
    rec = {
        "positions": positions,
        "dot_flops": sum(int(by_op.get(op, 0)) for op in MATMULS),
        "bytes": traffic.bytes,
        "peak_bytes": traffic.peak,
        "ops": traffic.ops,
        "bytes_by_op": dict(sorted(traffic.by_op.items(),
                                   key=lambda kv: -kv[1])),
        "collectives": {_KINDS[k]: dict(v) for k, v in coll.items()},
        "census_s": seconds,
    }
    return out, rec


def dot_flops(rec: Dict) -> float:
    """Matrix-product FLOPs a device (the mesh's positions averaged)."""
    return rec["dot_flops"] / rec["positions"]


def bytes_accessed(rec: Dict) -> float:
    """Computed bytes a device: every non-view op's inputs and outputs."""
    return rec["bytes"] / rec["positions"]


def temp_bytes(rec: Dict) -> float:
    """The estimate of a device's temporary memory: the peak of the
    storages the step made, over the positions."""
    return rec["peak_bytes"] / rec["positions"]


def collective_bytes(rec: Dict) -> Dict[str, float]:
    """Operand bytes a device by collective kind (plus 'total')."""
    out = {k: rec["collectives"].get(k, {}).get("bytes", 0) /
           rec["positions"] for k in COLLECTIVES}
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def count_collectives(rec: Dict) -> Dict[str, float]:
    """Collectives a device takes part in, by kind."""
    return {k: rec["collectives"].get(k, {}).get("calls", 0) /
            rec["positions"] for k in COLLECTIVES}
