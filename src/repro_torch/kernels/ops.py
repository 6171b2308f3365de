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

``cyclic_fused`` is the paper's byte path: int32 byte tokens and a
256-entry h1 table, the lookup fused into the CYCLIC kernel. Its tokens are
values (an int32 -1 is -1), not the uint32 bit patterns the other entry
points take.

Not ported yet: the deprecated single-sketch shims ``cyclic_minhash``,
``cyclic_hll`` and ``cyclic_bloom`` (ROADMAP.md, Queue 1 item 3).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import api
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.cyclic import cyclic_rolling
from repro_torch.kernels.general import general_rolling
from repro_torch.kernels.sketch_fused import cyclic_rolling_fused


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


def cyclic_fused(tokens, table, *, n: int, L: int = 32, impl: str = "auto",
                 device=None) -> torch.Tensor:
    """Fused byte -> fingerprint: h1 table lookup + rolling CYCLIC hash.
    tokens (..., S) int32 values, table (256,) uint32 -> (..., S-n+1)
    uint32, masked to L bits, no discard."""
    dev = api.resolve_device(tokens, device)
    ref_path = api.use_ref(impl, dev)
    x, lead = api.flatten(api.as_i32(tokens, dev))
    if x.shape[-1] < n:
        raise ValueError(f"sequence length {x.shape[-1]} < window n={n}")
    tab = api.as_u32(table, dev)
    out = (_ref.cyclic_fused_ref(x, tab, n, L).to(torch.uint32) if ref_path
           else cyclic_rolling_fused(x.contiguous(), tab.contiguous(), n=n,
                                     L=L))
    return out.reshape(lead + (out.shape[-1],))
