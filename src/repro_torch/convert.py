"""Carry sampled parameters from the JAX package into the port.

The h1 symbol tables and the sketch parameters (MinHash remix lanes,
CountMin row constants, the Bloom filter) decide every bit of a result.
The port draws its own from ``torch.Generator``s, which do not give JAX's
threefry bits; parity with the reference therefore carries the reference's
draw across, as a checkpoint would. Each function takes host numpy arrays
that the reference exports and returns the port's tensors:

* :func:`params_from_jax` — the deduper's ``export_state()["params"]``,
  for :meth:`repro_torch.data.dedup.MinHashDeduper.import_params`;
* :func:`stats_params_from_jax` — ``NgramStats.export_params()``, for
  :meth:`repro_torch.data.stats.NgramStats.rebind_params`;
* :func:`decontam_params_from_jax` — the ``params`` of
  ``Decontaminator.export_stream``, for
  :meth:`repro_torch.data.decontam.Decontaminator.rebind_params`;
* :func:`lm_params_from_jax` — the value tree of ``lm.init``, for the
  ``load_state_dict`` of :class:`repro_torch.nn.lm.LM`;
* :func:`train_state_from_jax` — a ``{"params", "opt", "step"}`` train
  state (``train.step.init_state``'s, or a checkpoint of it), for
  :func:`repro_torch.train.step.load_state`; :func:`train_state_to_mesh`
  lays it out over a model mesh;
* :func:`session_state_from_jax` / :func:`session_state_to_jax` — a
  ``SessionPool.export_state()`` tree, into the port's
  :meth:`repro_torch.serve.sessions.SessionPool.import_state` and back;
* :func:`norepeat_params_from_jax` — ``NoRepeatNgram.params``, for
  :meth:`repro_torch.serve.engine.NoRepeatNgram.rebind_params`;
* :func:`family_params_from_jax` — a family's ``init`` params (``{"h1":
  (sigma,)}``, THREEWISE's ``(n, sigma)``), for every form of
  :mod:`repro_torch.core.families`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_LAYOUT = {"fam": ("h1",), "mh": ("a", "b")}


def params_from_jax(tree: Dict, device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"fam": {"h1": (vocab,)}, "mh": {"a": (k,), "b": (k,)}}`` uint32
    numpy arrays (THREEWISE's ``h1`` is ``(n, vocab)``) -> the same tree
    of uint32 tensors on ``device``."""
    out = {}
    for group, names in _LAYOUT.items():
        if set(tree.get(group, {})) != set(names):
            raise ValueError(f"params[{group!r}] must hold exactly "
                             f"{list(names)}, got {sorted(tree.get(group, {}))}")
        out[group] = {}
        for name in names:
            arr = np.asarray(tree[group][name])
            # THREEWISE's table is (n, vocab): one row per position
            ndims = (1, 2) if (group, name) == ("fam", "h1") else (1,)
            if arr.dtype != np.uint32 or arr.ndim not in ndims:
                raise ValueError(f"params[{group!r}][{name!r}] must be a "
                                 f"{'-D or '.join(map(str, ndims))}-D "
                                 f"uint32 array, got {arr.dtype} {arr.shape}")
            # a copy: exported arrays may be read-only views
            out[group][name] = torch.from_numpy(arr.copy()).to(device)
    if out["mh"]["a"].shape != out["mh"]["b"].shape:
        raise ValueError("MinHash lanes a and b differ in length")
    return out


def _tensor(arr, dtype, ndim: int, what: str, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype != dtype or arr.ndim != ndim:
        raise ValueError(f"{what} must be a {ndim}-D {np.dtype(dtype)} "
                         f"array, got {arr.dtype} {arr.shape}")
    return torch.from_numpy(arr.copy()).to(device)


def stats_params_from_jax(tree: Dict, device="cuda") -> Dict:
    """The reference's ``NgramStats.export_params()`` — ``{"fam": {"h1"},
    "cms": {"a", "b", "table"}}`` numpy arrays — -> the same tree of
    tensors on ``device``, which
    :meth:`repro_torch.data.stats.NgramStats.rebind_params` accepts."""
    cms = tree["cms"]
    if set(cms) != {"a", "b", "table"}:
        raise ValueError(f"params['cms'] must hold a, b and table, got "
                         f"{sorted(cms)}")
    return {"fam": {"h1": _tensor(tree["fam"]["h1"], np.uint32, 1,
                                  "params['fam']['h1']", device)},
            "cms": {"a": _tensor(cms["a"], np.uint32, 1, "cms a", device),
                    "b": _tensor(cms["b"], np.uint32, 1, "cms b", device),
                    "table": _tensor(cms["table"], np.int32, 2, "cms table",
                                     device)}}


def decontam_params_from_jax(tree: Dict, device="cuda") -> Dict:
    """The ``params`` of the reference's ``Decontaminator.export_stream``
    — ``{"pa": {"h1"}, "pb": {"h1"}, "bits"}`` numpy arrays — -> the same
    tree of tensors on ``device``, which
    :meth:`repro_torch.data.decontam.Decontaminator.rebind_params`
    accepts."""
    return {"pa": {"h1": _tensor(tree["pa"]["h1"], np.uint32, 1, "pa h1",
                                 device)},
            "pb": {"h1": _tensor(tree["pb"]["h1"], np.uint32, 1, "pb h1",
                                 device)},
            "bits": _tensor(tree["bits"], np.uint32, 1, "bits", device)}


def _from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """A copy of ``arr`` on ``device``; a bfloat16 array (``ml_dtypes``,
    which ``torch.from_numpy`` refuses) goes across as its bits."""
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr).view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def lm_params_from_jax(values: Dict, device="cuda") -> Dict[str, torch.Tensor]:
    """The value tree of the reference's ``lm.init`` (leaves as arrays) ->
    a state dict for :class:`repro_torch.nn.lm.LM`. Nested keys join with
    dots; each ``blocks`` leaf is stacked over the repeats on its leading
    axis and splits into one entry a layer (``blocks.<r>.u0.attn.wq.w``).
    Einsum layouts stay as they are: ``(d, h, q)`` and ``(h, q, d)``; so
    do the MoE's and Mamba's bare arrays (``ffn.w_in`` (E, d, F),
    ``mamba.conv_w``, ``mamba.A_log``). bfloat16 leaves stay bfloat16."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                walk(sub, path + (str(key),))
            return
        arr = np.asarray(tree)
        if path[0] == "blocks":
            for r in range(arr.shape[0]):
                out[".".join(("blocks", str(r)) + path[1:])] = _from_numpy(
                    arr[r], device)
        else:
            out[".".join(path)] = _from_numpy(arr, device)

    walk(values, ())
    return out


def train_state_from_jax(state: Dict, device="cuda") -> Dict:
    """The reference's train state — ``{"params", "opt", "step"}`` with
    host arrays as leaves, each ``blocks`` leaf stacked over the layers —
    -> the port's: ``{"params": a state dict, "opt": ..., "step": 0-d
    int32 host tensor}``. The parameters go through
    :func:`lm_params_from_jax` and so does the optimizer state, split over
    the stacked axis the same way: AdamW's ``{"mu", "nu"}`` become one
    tensor a parameter name each, Adafactor's per-leaf ``{"vr", "vc"}``
    or ``{"v"}`` one such dict a parameter name."""
    opt = state["opt"]
    if set(opt) == {"mu", "nu"}:
        port_opt = {k: lm_params_from_jax(opt[k], device) for k in opt}
    else:
        port_opt: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, t in lm_params_from_jax(opt, device).items():
            param, key = name.rsplit(".", 1)
            port_opt.setdefault(param, {})[key] = t
    return {"params": lm_params_from_jax(state["params"], device),
            "opt": port_opt,
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32)}


def train_state_to_mesh(state: Dict, cfg, mesh, schedule=None) -> Dict:
    """The reference's train state -> a port train state laid out over a
    ``launch.mesh.ModelMesh``: each leaf goes through the host and is
    sliced into its shards, each on its position's device (the
    optimizer state after its parameter's spec, Adafactor's statistics
    after theirs)."""
    from repro_torch.nn import lm
    from repro_torch.train.optim import make_optimizer
    from repro_torch.train.step import load_state
    carried = train_state_from_jax(state, device="cpu")
    params = lm.shard(carried["params"], cfg, mesh)
    out = {"params": params,
           "opt": make_optimizer(cfg.optimizer, schedule).init(params.leaves),
           "step": torch.zeros((), dtype=torch.int32)}
    load_state(out, carried)
    return out


_CARRY = {"prefix": np.uint32, "ring": np.uint32, "pos": np.int32,
          "bloom": np.uint32, "count": np.int32, "active": np.int32,
          "steps": np.uint32, "banned_lo": np.uint32, "banned_hi": np.uint32,
          "canary_lo": np.uint32, "canary_hi": np.uint32}


def _session_tree(tree: Dict, leaf) -> Dict:
    carry = tree["carry"]
    if set(carry) != set(_CARRY):
        raise ValueError(f"carry must hold exactly {sorted(_CARRY)}, got "
                         f"{sorted(carry)}")
    params = tree["params"]
    if not {"h1"} <= set(params) <= {"h1", "canary_bits"}:
        raise ValueError(f"params must hold h1 (and canary_bits), got "
                         f"{sorted(params)}")
    return {"params": {k: leaf(v, np.uint32, 1, f"params[{k!r}]")
                       for k, v in params.items()},
            "carry": {k: leaf(v, _CARRY[k], np.ndim(v), f"carry[{k!r}]")
                      for k, v in carry.items()},
            "free": np.asarray(tree["free"], np.int64).copy(),
            "t": np.int64(tree["t"])}


def session_state_from_jax(tree: Dict, device="cuda") -> Dict:
    """The reference's ``SessionPool.export_state()`` tree (``params``,
    ``carry``, ``free``, ``t``; host arrays) -> the same tree with tensors
    on ``device``, which the port's ``SessionPool.import_state`` takes."""
    leaf = lambda v, dt, nd, what: _tensor(v, dt, nd, what, device)
    return _session_tree(tree, leaf)


def session_state_to_jax(tree: Dict) -> Dict:
    """The port's ``SessionPool.export_state()`` tree -> host numpy arrays
    in the reference's dtypes, which its ``SessionPool.import_state``
    takes."""
    def leaf(v, dt, nd, what):
        arr = (v.cpu().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v))
        if arr.dtype != dt or arr.ndim != nd:
            raise ValueError(f"{what} must be a {nd}-D {np.dtype(dt)} "
                             f"array, got {arr.dtype} {arr.shape}")
        return arr.copy()
    return _session_tree(tree, leaf)


def norepeat_params_from_jax(params: Dict, device="cuda") -> Dict:
    """The reference's ``NoRepeatNgram.params`` — ``{"h1": (padded
    vocab,)}`` uint32 — -> the same with a tensor on ``device``, for
    :meth:`repro_torch.serve.engine.NoRepeatNgram.rebind_params`."""
    return {"h1": _tensor(params["h1"], np.uint32, 1, "params['h1']",
                          device)}


def family_params_from_jax(params: Dict, device="cuda") -> Dict:
    """A family's ``{"h1": (sigma,)}`` params (THREEWISE: ``(n, sigma)``,
    one row per position), uint32 numpy arrays -> ``{"h1": uint32
    tensor}`` on ``device``."""
    if set(params) != {"h1"}:
        raise ValueError(f"family params must hold exactly ['h1'], got "
                         f"{sorted(params)}")
    h1 = np.asarray(params["h1"])
    if h1.dtype != np.uint32 or h1.ndim not in (1, 2):
        raise ValueError(f"params['h1'] must be a 1-D or 2-D uint32 array, "
                         f"got {h1.dtype} {h1.shape}")
    return {"h1": torch.from_numpy(h1.copy()).to(device)}
