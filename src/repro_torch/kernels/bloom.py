"""The Bloom probe kernel's wrapper, on the card through ``csrc/bloom.cu``.

Replaces the JAX package's Pallas kernel
``repro/kernels/bloom.py::bloom_probe``: two (B, S) uint32 hash streams and
a packed filter of 2^log2_m bits -> (B, S) bool membership, true iff all k
probes ``(h_a + i * (h_b | 1)) & (2^log2_m - 1)`` are set. The
decontamination scan probes every window fingerprint of a stream this way.

The kernel reads the filter from shared memory where a block can hold it:
whole in each block up to 2^20 bits; up to 2^23 bits (the decontaminator's
2^22 among them) its first 224 KiB in each block and the rest through the
read-only cache; above that all of it through the read-only cache.
:func:`route` says which.

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.bloom_probe_ref`. On a CUDA tensor it
launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# kernel launches made by this wrapper; the smoke run resets and reads it
LAUNCHES = 0


def route(log2_m: int) -> int:
    """Where ``csrc/bloom.cu`` reads a filter of 2^log2_m bits: 1 staged
    whole in each block's shared memory, 2 its first 224 KiB staged there
    and the rest through the read-only cache, 0 all through the read-only
    cache. Loads (and on first use builds) the kernel's library."""
    fn = _build.load("bloom").bloom_probe_route
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(log2_m)


def bloom_probe(h_a: torch.Tensor, h_b: torch.Tensor, bits: torch.Tensor, *,
                k: int = 4, log2_m: int = 22) -> torch.Tensor:
    """h_a, h_b (B, S) uint32 fingerprint pairs; bits (2^log2_m / 32,)
    packed uint32 filter -> (B, S) bool membership."""
    global LAUNCHES
    if h_a.dim() != 2 or tuple(h_a.shape) != tuple(h_b.shape):
        raise ValueError(f"h_a and h_b must be (B, S) of one shape, got "
                         f"{tuple(h_a.shape)} and {tuple(h_b.shape)}")
    if not 5 <= log2_m <= 32 or k < 0:
        raise ValueError(f"need 5 <= log2_m <= 32 and k >= 0, got "
                         f"log2_m={log2_m}, k={k}")
    if tuple(bits.shape) != (1 << (log2_m - 5),):
        raise ValueError(f"bits must have shape ({1 << (log2_m - 5)},) for "
                         f"log2_m={log2_m}, got {tuple(bits.shape)}")
    if h_a.device.type == "cpu":
        return _ref.bloom_probe_ref(h_a, h_b, bits, k=k, log2_m=log2_m)
    if not h_a.is_cuda:
        raise ValueError(f"bloom_probe runs on CUDA or CPU tensors, got "
                         f"{h_a.device}")
    for name, t in (("h_a", h_a), ("h_b", h_b), ("bits", bits)):
        if t.device != h_a.device or t.dtype != torch.uint32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous uint32 tensor on "
                             f"{h_a.device}, got {t.dtype} on {t.device}")
    out = torch.empty(h_a.shape, dtype=torch.bool, device=h_a.device)
    fn = _build.load("bloom").bloom_probe
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ctypes.c_longlong, i, i, vp, vp]
        fn.restype = ctypes.c_int
    with torch.cuda.device(h_a.device):
        stream = torch.cuda.current_stream(h_a.device).cuda_stream
        err = fn(h_a.data_ptr(), h_b.data_ptr(), bits.data_ptr(), h_a.numel(),
                 k, log2_m, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bloom_probe launch failed: CUDA error {err}")
    if h_a.numel():
        LAUNCHES += 1
    return out
