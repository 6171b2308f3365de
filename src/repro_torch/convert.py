"""Carry sampled parameters from the JAX package into the port.

The h1 symbol table and the MinHash remix lanes decide every bit of a
signature. The port draws its own from ``torch.Generator``s, which do not
give JAX's threefry bits; parity with the reference therefore carries the
reference's draw across, as a checkpoint would. :func:`params_from_jax`
takes the reference deduper's ``export_state()["params"]`` — host numpy
arrays — and returns the port's tensors, which
:meth:`repro_torch.data.dedup.MinHashDeduper.import_params` accepts.
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
