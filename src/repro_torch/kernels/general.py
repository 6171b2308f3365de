"""The plain GENERAL window-hash kernel's wrapper, on the card through
``csrc/rolling.cu`` (entry point ``general_rolling``).

Replaces the JAX package's Pallas kernel
``repro/kernels/general.py::general_rolling``: (B, S) uint32 symbols ->
(B, S-n+1) uint32 window hashes ``XOR_t x[j+t] * x^(n-1-t) mod p`` in
GF(2)[x] of degree L. The kernel rolls each thread through a run of
windows with the paper's Algorithm 3 update.

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.general_ref`. On a CUDA tensor it launches
the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.cyclic import check_input

# kernel launches made by this wrapper; the smoke run resets and reads it
LAUNCHES = 0


def general_rolling(x: torch.Tensor, *, n: int, p: int,
                    L: int = 32) -> torch.Tensor:
    """(B, S) uint32 -> (B, S-n+1) uint32 GENERAL window hashes mod the
    degree-L polynomial ``p`` (given WITH its top bit)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return _ref.general_ref(x, n, p, L).to(torch.uint32)
    check_input(x, n, L)
    if p.bit_length() - 1 != L:
        raise ValueError(f"p must have degree exactly L={L}, got {bin(p)}")
    B, S = x.shape
    out = torch.empty((B, S - n + 1), dtype=torch.uint32, device=x.device)
    fn = _build.load("rolling").general_rolling
    if fn.argtypes is None:
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        fn.argtypes = [vp, i, i, i, i, u, u, vp, vp]
        fn.restype = ctypes.c_int
    c_out = _ref._xpows_host(n, p, L)[n]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), B, S, n, L, p & ((1 << L) - 1), c_out,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"general_rolling launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
