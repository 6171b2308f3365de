"""The plan kernel's wrapper: one rolling-hash pass feeding every MinHash
sketch of a plan, on the card through ``csrc/sketch_plan.cu``.

Replaces the JAX package's Pallas kernel
``repro/kernels/sketch_fused.py::sketch_plan_fused`` (``_plan_kernel`` with
its ``_minhash_tile`` epilogue). The window hashes are computed once, masked
by the Theorem-1 discard, remixed and reduced into the signatures inside the
kernel; they never reach device memory.

A plan with several MinHash sketches runs as ONE launch: their remix lanes
are laid side by side into one signature of ``sum(k)`` lanes and the output
is split afterwards. The HLL, CountMin and Bloom epilogues are not ported
yet (ROADMAP.md, Queue 2 item 1).

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.sketch_plan_ref`. On a CUDA tensor it
launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.plan import SketchPlan

# kernel launches made by this wrapper (one per sketch_plan_fused call on
# CUDA tensors); the smoke run resets it and reads it to show the main path
# went through the kernel
LAUNCHES = 0

_FAMILY_CODE = {"cyclic": 0, "general": 1}


def _bind(lib: ctypes.CDLL):
    fn = lib.sketch_plan_minhash
    if fn.argtypes is None:
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        fn.argtypes = [vp, i, i, vp, vp, vp, vp, i, vp, vp, i, i, i, u, u,
                       ctypes.POINTER(ctypes.c_uint), vp]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} dtype {t.dtype} != {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def sketch_plan_fused(h1v: torch.Tensor, h1v_b, n_windows: torch.Tensor,
                      operands, *, plan: SketchPlan, w_start=None) -> dict:
    """Execute every sketch in ``plan`` in ONE rolling-hash pass.

    h1v (B, S) uint32, n_windows (B,) int32 (at most S-n+1), w_start (B,)
    int32 or None, operands ``{name: {"a": (k,), "b": (k,)[, "init":
    (B, k)]}}`` uint32 -> ``{name: (B, k) uint32 signatures}``. A sketch's
    ``init`` seeds its running minima; without it they start at 0xFFFFFFFF.
    """
    global LAUNCHES
    if h1v.device.type == "cpu":
        return _ref.sketch_plan_ref(plan, h1v, h1v_b, n_windows, operands,
                                    w_start=w_start)
    if not h1v.is_cuda:
        raise ValueError(f"sketch_plan_fused runs on CUDA or CPU tensors, "
                         f"got {h1v.device}")
    _ref.require_minhash(plan)
    if h1v_b is not None:
        raise ValueError("h1v_b given but no sketch in the plan consumes a "
                         "second hash stream")
    dev = h1v.device
    if h1v.dim() != 2:
        raise ValueError(f"h1v must be (B, S), got shape {tuple(h1v.shape)}")
    B, S = h1v.shape
    hs = plan.hash
    if S < hs.n:
        raise ValueError(f"sequence length {S} < window n={hs.n}")
    _check(h1v, "h1v", torch.uint32, (B, S), dev)
    _check(n_windows, "n_windows", torch.int32, (B,), dev)
    if w_start is not None:
        _check(w_start, "w_start", torch.int32, (B,), dev)

    a_all, b_all, inits, ks = [], [], [], []
    for name, spec in plan.sketches:
        ops = operands.get(name, {})
        for op in ("a", "b"):
            _check(ops[op], f"sketch {name!r} operand {op!r}", torch.uint32,
                   (spec.k,), dev)
        a_all.append(ops["a"])
        b_all.append(ops["b"])
        init = ops.get("init")
        if init is not None:
            _check(init, f"sketch {name!r} init", torch.uint32, (B, spec.k),
                   dev)
        inits.append(init)
        ks.append(spec.k)
    K = sum(ks)
    if len(ks) == 1:
        a, b, init = a_all[0], b_all[0], inits[0]
    else:
        # uint32 has no cat on every backend: lay the lanes out through the
        # int32 view (same bits)
        a = torch.cat([t.view(torch.int32) for t in a_all]).view(torch.uint32)
        b = torch.cat([t.view(torch.int32) for t in b_all]).view(torch.uint32)
        init = None
        if any(t is not None for t in inits):
            init = torch.cat(
                [torch.full((B, k), -1, dtype=torch.int32, device=dev)
                 if t is None else t.view(torch.int32)
                 for t, k in zip(inits, ks)], dim=1).view(torch.uint32)

    out = torch.empty((B, K), dtype=torch.uint32, device=dev)
    if B > 0:
        fn = _bind(_build.load("sketch_plan"))
        xpow = None
        if hs.family == "general":
            pows = _ref._xpows_host(hs.n, hs.p, hs.L)
            xpow = (ctypes.c_uint * hs.n)(
                *[pows[hs.n - 1 - t] for t in range(hs.n)])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(h1v.data_ptr(), B, S, n_windows.data_ptr(),
                     None if w_start is None else w_start.data_ptr(),
                     a.data_ptr(), b.data_ptr(), K,
                     None if init is None else init.data_ptr(),
                     out.data_ptr(), _FAMILY_CODE[hs.family], hs.n, hs.L,
                     hs.hash_mask, hs.p & ((1 << hs.L) - 1), xpow, stream)
        if err != 0:
            raise RuntimeError(f"sketch_plan_minhash launch failed: CUDA "
                               f"error {err}")
        LAUNCHES += 1
    if len(ks) == 1:
        return {plan.sketches[0][0]: out}
    results, s = {}, 0
    for (name, _), k in zip(plan.sketches, ks):
        results[name] = out[:, s : s + k].contiguous()
        s += k
    return results
