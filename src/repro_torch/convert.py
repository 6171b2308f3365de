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
  :meth:`repro_torch.data.decontam.Decontaminator.rebind_params`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_LAYOUT = {"fam": ("h1",), "mh": ("a", "b")}


def params_from_jax(tree: Dict, device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"fam": {"h1": (vocab,)}, "mh": {"a": (k,), "b": (k,)}}`` uint32
    numpy arrays -> the same tree of uint32 tensors on ``device``."""
    out = {}
    for group, names in _LAYOUT.items():
        if set(tree.get(group, {})) != set(names):
            raise ValueError(f"params[{group!r}] must hold exactly "
                             f"{list(names)}, got {sorted(tree.get(group, {}))}")
        out[group] = {}
        for name in names:
            arr = np.asarray(tree[group][name])
            if arr.dtype != np.uint32 or arr.ndim != 1:
                raise ValueError(f"params[{group!r}][{name!r}] must be a 1-D "
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
