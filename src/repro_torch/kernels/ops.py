"""Public entry points of the plain rolling-hash kernels.

* ``impl="auto"``   — the CUDA kernel on a CUDA tensor, the plain version on
  a CPU tensor;
* ``impl="kernel"`` — force the kernel (raises on the CPU);
* ``impl="ref"``    — force the plain version.

All entry points accept (..., S) inputs (tensors or arrays; an array goes
to ``device``, default ``cuda``); leading dims are flattened to a batch and
restored on return. Validation (impl names, the ``S >= n`` window check)
is :func:`repro_torch.kernels.api.prepare`'s, as for the plan engine. The
kernels pick their own form, so there are no mode or tile knobs.

Not ported yet: ``cyclic_fused`` (the h1 lookup fused into the CYCLIC
kernel) and the deprecated single-sketch shims (ROADMAP.md, Queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import api
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.cyclic import cyclic_rolling
from repro_torch.kernels.general import general_rolling


def cyclic(h1v, *, n: int, L: int = 32, impl: str = "auto",
           device=None) -> torch.Tensor:
    """Rolling CYCLIC hash of h1-mapped values. (..., S) -> (..., S-n+1)
    uint32, masked to L bits, no discard."""
    x, lead, ref_path = api.prepare(h1v, n=n, impl=impl, device=device)
    out = (_ref.cyclic_ref(x, n, L).to(torch.uint32) if ref_path
           else cyclic_rolling(x, n=n, L=L))
    return out.reshape(lead + (out.shape[-1],))


def general(h1v, *, n: int, p: int, L: int = 32, impl: str = "auto",
            device=None) -> torch.Tensor:
    """Rolling GENERAL hash mod irreducible p (WITH its top bit).
    (..., S) -> (..., S-n+1) uint32."""
    x, lead, ref_path = api.prepare(h1v, n=n, impl=impl, device=device)
    out = (_ref.general_ref(x, n, p, L).to(torch.uint32) if ref_path
           else general_rolling(x, n=n, p=p, L=L))
    return out.reshape(lead + (out.shape[-1],))
