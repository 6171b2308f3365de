"""Logical-axis sharding, as in the JAX package's ``repro/nn/sharding.py``:
each parameter's dimensions carry logical names, and ``RULES`` maps the
names to mesh axes.

* a mesh axis is only assigned where it divides the dimension (else the
  largest dividing prefix of a combined axis, else the next candidate,
  ultimately replication);
* a mesh axis is never used twice within one spec, so fallback chains
  compose: with one kv head (MQA) ``head_dim`` takes ``model`` in place of
  ``kv_heads``.

The layout is Megatron's with FSDP: batch over (pod, data), ``embed`` over
``data`` (gathered before use; the optimizer state inherits the specs),
heads, mlp, experts, inner, ssm_heads and vocab over ``model``.

The reference reads the axes off ``P_`` leaves that its ``*_init``
functions build; the port's parameters are plain modules, so
:func:`axes_of` gives each of their names its axes (the reference's
``stack`` axis dropped: the port holds one module a layer). A mesh here is
anything with ``axis_names`` and ``shape`` (``launch.mesh.ModelMesh``).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

RULES: dict = {
    "batch": (("pod", "data"),),
    "seq": (),
    "embed": ("data",),
    "embed_act": (),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "capacity": (("data", "pod"), ("data",)),
    "inner": ("model",),
    "ssm_heads": ("model",),
    "ssm_state": (),
    "conv": (),
    "stack": (),
    "kv_seq_model": ("model",),     # kv_cache_axes' sequence fallback
    None: (),
}


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), a mesh axis name, or a
    tuple of names (the dimension split over their product, the first
    axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes of dimension ``dim``, major first."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e if isinstance(e, tuple) else (e,))


def mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def _pick(dim: Optional[int], name, sizes: Dict[str, int], used: set,
          rules: dict):
    for cand in rules.get(name, ()):
        group = cand if isinstance(cand, tuple) else (cand,)
        group = tuple(a for a in group if a in sizes and a not in used)
        if not group:
            continue
        if dim is not None:
            prod = 1
            for a in group:
                prod *= sizes[a]
            # the largest prefix that divides
            while group and (prod == 0 or dim % prod != 0):
                prod //= sizes[group[-1]]
                group = group[:-1]
            if not group:
                continue
        return group if len(group) > 1 else group[0]
    return None


def _resolve(shape, axes, mesh, rules) -> PartitionSpec:
    sizes = mesh_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        picked = _pick(dim, name, sizes, used, rules)
        out.append(picked)
        if picked is not None:
            used.update(picked if isinstance(picked, tuple) else (picked,))
    return PartitionSpec(*out)


def logical_to_spec(axes: Sequence[Optional[str]], mesh,
                    rules: dict = RULES) -> PartitionSpec:
    """Logical names -> a spec, divisibility not checked."""
    return _resolve([None] * len(axes), axes, mesh, rules)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
             rules: dict = RULES) -> PartitionSpec:
    """Logical names -> a spec with only mesh axes that divide their
    dimension (the reference's ``spec_for``)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in rank")
    return _resolve(shape, axes, mesh, rules)


def kv_cache_axes(cfg, mesh) -> Tuple[Optional[str], ...]:
    """(batch, seq, kv_heads, head_dim) cache: the kv heads over ``model``
    where they divide, else the *sequence* (decode then combines the
    shards' partial softmax)."""
    model = mesh_sizes(mesh).get("model", 1)
    if cfg.n_kv_heads and cfg.n_kv_heads % model == 0:
        return ("batch", None, "kv_heads", None)
    return ("batch", "kv_seq_model", None, None)


def shard_shape(shape: Sequence[int], spec: PartitionSpec, mesh):
    """The shape of one shard of a ``shape`` tensor under ``spec``."""
    sizes = mesh_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        k = 1
        for a in spec.axes(d):
            k *= sizes[a]
        out.append(n // k)
    return tuple(out)


def constrain(x, axes: Sequence[Optional[str]], global_shape, mesh=None,
              rules: dict = RULES):
    """The reference's ``with_sharding_constraint``, as a check: a local
    tensor ``x`` must have the shard shape that ``spec_for(global_shape,
    axes)`` gives. Returns ``x``; moves nothing. Without a mesh, ``x``
    must have the global shape."""
    want = (tuple(global_shape) if mesh is None else
            shard_shape(global_shape, spec_for(global_shape, axes, mesh,
                                               rules), mesh))
    if tuple(x.shape) != want:
        raise ValueError(f"local shape {tuple(x.shape)} != {want}, the "
                         f"shard of {tuple(global_shape)} over {tuple(axes)}")
    return x


# -- the port's parameter names -> logical axes -------------------------------

_LINEAR = {
    # attention (reference attention.py:38-53)
    "attn.wq.w": ("embed", "heads", "head_dim"),
    "attn.wq.b": ("heads", "head_dim"),
    "attn.wk.w": ("embed", "kv_heads", "head_dim"),
    "attn.wk.b": ("kv_heads", "head_dim"),
    "attn.wv.w": ("embed", "kv_heads", "head_dim"),
    "attn.wv.b": ("kv_heads", "head_dim"),
    "attn.wo.w": ("heads", "head_dim", "embed"),
    # dense MLP (blocks.py:20-30)
    "ffn.w_in.w": ("embed", "mlp"),
    "ffn.w_gate.w": ("embed", "mlp"),
    "ffn.w_out.w": ("mlp", "embed"),
    # MoE (moe.py:28-44)
    "ffn.router.w": ("embed", "experts"),
    "ffn.w_in": ("experts", "embed", "expert_mlp"),
    "ffn.w_gate": ("experts", "embed", "expert_mlp"),
    "ffn.w_out": ("experts", "expert_mlp", "embed"),
    # Mamba-2 (mamba2.py:31-54)
    "mamba.wz.w": ("embed", "inner"),
    "mamba.wx.w": ("embed", "inner"),
    "mamba.wB.w": ("embed", None),
    "mamba.wC.w": ("embed", None),
    "mamba.wdt.w": ("embed", "ssm_heads"),
    "mamba.out.w": ("inner", "embed"),
    "mamba.conv_w": ("conv", "inner"),
    "mamba.conv_b": ("inner",),
    "mamba.A_log": ("ssm_heads",),
    "mamba.dt_bias": ("ssm_heads",),
    "mamba.D": ("ssm_heads",),
}
_TOP = {"embed.table": ("vocab", "embed"),            # layers.py:58-60
        "unembed.table": ("vocab", "embed"),
        "final_norm.scale": ("embed_act",)}           # layers.py:35
_BLOCK = re.compile(r"blocks\.\d+\.u\d+\.(.+)")


def axes_of(name: str) -> Tuple[Optional[str], ...]:
    """The logical axes of one of ``LM.named_parameters()``'s names."""
    if name in _TOP:
        return _TOP[name]
    m = _BLOCK.fullmatch(name)
    if m is not None:
        rest = m[1]
        if rest.endswith(".scale"):         # every RMSNorm's scale
            return ("embed_act",)
        if rest in _LINEAR:
            return _LINEAR[rest]
    raise KeyError(f"no logical axes for parameter {name!r}")


def adafactor_axes(axes, factored: bool) -> Dict[str, tuple]:
    """The state axes of an Adafactor leaf, as the reference's
    ``optim.py:106-110``: the factored row and column statistics drop the
    last and the second-to-last axis."""
    axes = tuple(axes)
    if factored:
        return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
    return {"v": axes}
