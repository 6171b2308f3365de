"""The plain CYCLIC window-hash kernel's wrapper, on the card through
``csrc/rolling.cu`` (entry point ``cyclic_rolling``).

Replaces the JAX package's Pallas kernel
``repro/kernels/cyclic.py::cyclic_rolling``: (B, S) uint32 symbols ->
(B, S-n+1) uint32 window hashes ``XOR_t rotl_L(x[j+t], n-1-t)``, with no
discard. The kernel rolls each thread through a run of windows with the
paper's Algorithm 4 update; it picks its own form, so there is no mode or
tile knob.

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.cyclic_ref`. On a CUDA tensor it launches
the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# kernel launches made by this wrapper; the smoke run resets and reads it
LAUNCHES = 0


def check_input(x: torch.Tensor, n: int, L: int) -> None:
    """What the rolling kernels take: (B, S >= n) contiguous uint32 on a
    CUDA device, n >= 1, 1 <= L <= 32 (n > L included, as the plain
    version takes)."""
    if not x.is_cuda:
        raise ValueError(f"the rolling kernels run on CUDA or CPU tensors, "
                         f"got {x.device}")
    if x.dtype != torch.uint32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, S) uint32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if n < 1 or not 1 <= L <= 32:
        raise ValueError(f"need n >= 1 and 1 <= L <= 32, got n={n}, L={L}")
    if x.shape[1] < n:
        raise ValueError(f"sequence length {x.shape[1]} < window n={n}")


def cyclic_rolling(x: torch.Tensor, *, n: int, L: int = 32) -> torch.Tensor:
    """(B, S) uint32 -> (B, S-n+1) uint32 CYCLIC window hashes."""
    global LAUNCHES
    if x.device.type == "cpu":
        return _ref.cyclic_ref(x, n, L).to(torch.uint32)
    check_input(x, n, L)
    B, S = x.shape
    out = torch.empty((B, S - n + 1), dtype=torch.uint32, device=x.device)
    fn = _build.load("rolling").cyclic_rolling
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, i, i, i, vp, vp]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), B, S, n, L, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cyclic_rolling launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
