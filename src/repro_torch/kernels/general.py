"""The plain GENERAL window-hash kernel's wrapper, on the card through
``csrc/rolling.cu`` (entry point ``general_rolling``).

Replaces the JAX package's Pallas kernel
``repro/kernels/general.py::general_rolling``: (B, S) uint32 symbols ->
(B, S-n+1) uint32 window hashes ``XOR_t x[j+t] * x^(n-1-t) mod p`` in
GF(2)[x] of degree L. The kernel rolls each thread through a run of
windows with the paper's Algorithm 3 update, ``h' = x*h ^ x^n*x_out ^
x_in``, and takes the product ``x^n * x_out mod p`` on one of two routes
that :func:`route` picks from (n, p, L) alone: the fold (a few shifts and
XORs) or byte-wide chunk tables in shared memory (any n, p, L), which
:func:`chunk_tables` builds.

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.general_ref`. On a CUDA tensor it launches
the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import gf2
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.cyclic import check_input

# kernel launches made by this wrapper; the smoke run resets and reads it
LAUNCHES = 0

# most set bits of p_low the fold takes (csrc/rolling.cu, kFoldTerms): each
# costs a shift and half a three-input XOR a window; every modulus that
# gf2.find_irreducible_host returns, and the paper's Table 2, has at most 4
FOLD_TERMS = 4
FOLD, TABLES = 1, 2


class Route(NamedTuple):
    """How the kernel takes x^n * v mod p: ``route`` FOLD or TABLES;
    ``ways`` the fold's terms (set bits of p_low) or the tables' byte
    chunks; ``shifts`` the fold's shifts (p_low's set bits), () for the
    tables."""
    route: int
    ways: int
    shifts: tuple


def route(n: int, p: int, L: int) -> Route:
    """The route of a launch: the fold where 1 <= n < L, n + deg(p_low) <= L
    and p_low has 1 to FOLD_TERMS set bits, else the tables (ceil(n / 8)
    chunks of the top n bits of v for n < L, ceil(L / 8) of all of v for
    n >= L). ``p`` is given WITH its top bit."""
    if n < 1 or not 1 <= L <= 32 or p.bit_length() - 1 != L:
        raise ValueError(f"need n >= 1, 1 <= L <= 32 and p of degree L, got "
                         f"n={n}, L={L}, p={bin(p)}")
    p_low = p & gf2.mask(L)
    bits = tuple(j for j in range(L) if p_low >> j & 1)
    if n < L and 1 <= len(bits) <= FOLD_TERMS and \
            n + p_low.bit_length() - 1 <= L:
        return Route(FOLD, len(bits), bits)
    return Route(TABLES, (min(n, L) + 7) // 8, ())


@functools.lru_cache(maxsize=None)
def chunk_tables(n: int, p: int, L: int) -> np.ndarray:
    """The tables route's (ways * 256,) uint32 tables: entry c * 256 + b is
    ``(b << (top + 8c)) * x^n mod p`` (bits past L dropped), top = L - n
    for n < L (Lemma 2's table of the top n bits, in byte chunks:
    gf2.build_shiftn_table_host) and 0 for n >= L (all of v)."""
    route(n, p, L)                      # the same checks
    ways, top = (min(n, L) + 7) // 8, (L - n if n < L else 0)
    # x^(k + n) mod p, the image of bit k
    img = [gf2.x_pow_mod_host(n, p, L)]
    for _ in range(L - 1):
        img.append(gf2.xtimes_host(img[-1], p, L))
    b = np.arange(256, dtype=np.uint64)
    out = np.zeros((ways, 256), dtype=np.uint64)
    for c in range(ways):
        for i in range(8):
            k = top + 8 * c + i
            if k < L:
                out[c] ^= np.where(b >> np.uint64(i) & np.uint64(1),
                                   np.uint64(img[k]), np.uint64(0))
    return out.reshape(-1).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _device_tables(n: int, p: int, L: int, device) -> torch.Tensor:
    """:func:`chunk_tables` on ``device``, built once."""
    return torch.from_numpy(chunk_tables(n, p, L).view(np.int32)).to(
        device).view(torch.uint32)


def general_rolling(x: torch.Tensor, *, n: int, p: int,
                    L: int = 32) -> torch.Tensor:
    """(B, S) uint32 -> (B, S-n+1) uint32 GENERAL window hashes mod the
    degree-L polynomial ``p`` (given WITH its top bit)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return _ref.general_ref(x, n, p, L).to(torch.uint32)
    check_input(x, n, L)
    r = route(n, p, L)
    tabs = _device_tables(n, p, L, x.device) if r.route == TABLES else None
    B, S = x.shape
    out = torch.empty((B, S - n + 1), dtype=torch.uint32, device=x.device)
    fn = _build.load("rolling").general_rolling
    if fn.argtypes is None:
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        fn.argtypes = [vp, i, i, i, i, u, i, i, vp, vp, vp]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), B, S, n, L, p & gf2.mask(L), r.route, r.ways,
                 None if tabs is None else tabs.data_ptr(), out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"general_rolling launch failed ({r}): CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
