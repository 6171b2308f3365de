"""The HyperLogLog update kernel's wrapper, on the card through
``csrc/hll.cu``.

Replaces the JAX package's Pallas kernel ``repro/kernels/hll.py::hll_update``:
(N,) uint32 hashes -> (2^b,) int32 registers, index ``h & (2^b - 1)``, rank
``min(ctz(h >> b), rank_bits) + 1`` with ctz(0) = 32, merged by max from
zero. The paper's §2 distinct count reads its estimate from these
registers.

Up to b = 14 the kernel keeps a register file a block in shared memory,
one 1,024-thread block an SM, and flushes each file once; above it, it
raises the global registers directly.

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.hll_update_ref`. On a CUDA tensor it
launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

# kernel launches made by this wrapper; the smoke run resets and reads it
LAUNCHES = 0


def hll_update(hashes: torch.Tensor, *, b: int = 10,
               rank_bits: int = 32) -> torch.Tensor:
    """hashes (...) uint32 -> (2^b,) int32 HLL registers. Any b >= 1 on
    the CPU, as the reference takes; the kernel takes b <= 31 (b <= 14 in
    shared memory, above it in the global registers)."""
    global LAUNCHES
    if rank_bits < 0:
        raise ValueError(f"need rank_bits >= 0, got rank_bits={rank_bits}")
    if hashes.device.type == "cpu":
        return _ref.hll_update_ref(hashes, b=b, rank_bits=rank_bits)
    if not 1 <= b <= 31:
        raise ValueError(f"the HLL kernel takes 1 <= b <= 31, got b={b}")
    if not hashes.is_cuda:
        raise ValueError(f"hll_update runs on CUDA or CPU tensors, got "
                         f"{hashes.device}")
    if hashes.dtype != torch.uint32:
        raise ValueError(f"hashes must be uint32, got {hashes.dtype}")
    h = hashes.reshape(-1).contiguous()
    regs = torch.zeros((1 << b,), dtype=torch.int32, device=h.device)
    fn = _build.load("hll").hll_update
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ctypes.c_longlong, i, i, vp, vp]
        fn.restype = ctypes.c_int
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(h.data_ptr(), h.numel(), b, rank_bits, regs.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"hll_update launch failed: CUDA error {err}")
    if h.numel():
        LAUNCHES += 1
    return regs
