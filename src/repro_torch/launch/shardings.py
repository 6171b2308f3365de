"""Placement trees and abstract (no-allocation) state and caches for the
launcher, as the JAX package's ``repro/launch/shardings.py``.

Shapes come from the port's own modules built on ``torch.device("meta")``
(nothing is allocated, kimi-k2 included); each leaf's logical axes from
``nn.sharding.axes_of``. A :class:`Placement` is the port's
``NamedSharding``: a mesh and a spec, which slices a whole tensor into its
shards (:meth:`Placement.shard`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.nn.sharding import (PartitionSpec, adafactor_axes, axes_of,
                                     kv_cache_axes, spec_for)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf's layout: ``spec`` over ``mesh``."""
    mesh: Any
    spec: PartitionSpec

    def shard(self, t: torch.Tensor, param: bool = False):
        """``t``'s slices on their positions' devices, a Sharded."""
        from repro_torch.nn.collectives import Sharded
        return Sharded.from_full(t, self.spec, self.mesh, param=param)


def shapes_and_axes_params(cfg: ModelConfig):
    """({name: meta tensor}, {name: logical axes}) of the LM's parameters,
    in ``LM.named_parameters()`` order."""
    from repro_torch.nn.lm import LM
    with torch.no_grad():
        model = LM(torch.Generator(), cfg, "meta")
    shapes = {n: p for n, p in model.named_parameters()}
    return shapes, {n: axes_of(n) for n in shapes}


def shapes_and_axes_state(cfg: ModelConfig, schedule=None):
    """The train state on meta tensors and its axes tree: ``{"params",
    "opt", "step"}``; the optimizer state's axes follow its parameter's
    (Adafactor's row and column statistics drop an axis)."""
    from repro_torch.train.optim import make_optimizer
    shapes, axes = shapes_and_axes_params(cfg)
    opt = make_optimizer(cfg.optimizer, schedule).init(shapes)
    if cfg.optimizer == "adamw":
        opt_axes = {"mu": dict(axes), "nu": dict(axes)}
    else:
        opt_axes = {n: adafactor_axes(axes[n], "vr" in st)
                    for n, st in opt.items()}
    state = {"params": shapes, "opt": opt,
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    return state, {"params": axes, "opt": opt_axes, "step": ()}


def cache_axes(cfg: ModelConfig, mesh):
    """Logical axes of one repeat's caches, ``lm.init_caches``' unit
    members (the reference's, its ``stack`` axis dropped)."""
    from repro_torch.nn.attention import KVCache
    from repro_torch.nn.mamba2 import MambaCache
    kv_ax = kv_cache_axes(cfg, mesh)
    out = {}
    for u, spec in enumerate(cfg.unit):
        if spec.kind == "attn":
            out[f"u{u}"] = KVCache(k=kv_ax, v=kv_ax, length=())
        else:
            out[f"u{u}"] = MambaCache(conv=("batch", None, "inner"),
                                      state=("batch", "ssm_heads", None,
                                             None),
                                      length=())
    return out


def _map(fn, tree, axes):
    if isinstance(tree, torch.Tensor):
        return fn(tree, axes)
    if isinstance(tree, dict):
        return {k: _map(fn, v, axes[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, getattr(axes, f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, a) for v, a in zip(tree, axes))
    return None                         # a Python scalar (a cache length)


def tree_shardings(shapes, axes, mesh):
    """A tree of tensors (meta or not) and its axes tree -> a tree of
    :class:`Placement`."""
    return _map(lambda t, ax: Placement(mesh, spec_for(tuple(t.shape), ax,
                                                       mesh)),
                shapes, axes)


def batch_sharding(mesh, shape: Tuple[int, ...], axes) -> Placement:
    return Placement(mesh, spec_for(shape, axes, mesh))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    """Meta stand-ins and placements for every model input of an (arch x
    shape) cell. Nothing is allocated."""
    from repro_torch.nn import lm
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": meta((B, S), torch.int32)}
        shards = {"tokens": batch_sharding(mesh, (B, S), ("batch", "seq"))}
        if cfg.prefix_len:
            batch["prefix"] = meta((B, cfg.prefix_len, cfg.d_model),
                                   torch.bfloat16)
            shards["prefix"] = batch_sharding(
                mesh, (B, cfg.prefix_len, cfg.d_model),
                ("batch", "seq", "embed_act"))
        out["batch"], out["batch_sharding"] = batch, shards
    else:
        out["token"] = meta((B, 1), torch.int32)
        out["token_sharding"] = batch_sharding(mesh, (B, 1), ("batch", "seq"))
        caches = lm.init_caches(cfg, B, S, device="meta")
        cax = cache_axes(cfg, mesh)
        out["caches"] = caches
        out["cache_sharding"] = [tree_shardings(unit, cax, mesh)
                                 for unit in caches]
    return out
