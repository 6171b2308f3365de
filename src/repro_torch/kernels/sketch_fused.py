"""The plan kernel's wrapper: one rolling-hash pass feeding every sketch of a
plan (MinHash, HLL, CountMin, Bloom), on the card through
``csrc/sketch_plan.cu``.

Replaces the JAX package's Pallas kernel
``repro/kernels/sketch_fused.py::sketch_plan_fused`` (``_plan_kernel`` with
its ``_minhash_tile``, ``_hll_tile``, ``_cms_tile`` and ``_bloom_tile``
epilogues and the CountMin scatter epilogue). The window hashes are
computed once, masked by the Theorem-1 discard and reduced into every
sketch inside the kernel; they never reach device memory.

A plan with any mix of up to eight sketches runs as ONE launch: each sketch
becomes one :class:`_Epilogue` of a :class:`_PlanDesc`, which mirrors the
kernel's C structs. A larger plan runs as one launch for each group of
eight (:func:`sketch_groups`) over the same inputs; every sketch's output
is its own, so the bits are those of one launch. A launch with a Bloom
sketch also hashes the second stream ``h1v_b``, which gives the probe
stride.

The module also holds the byte path's wrapper,
:func:`cyclic_rolling_fused`: the h1 table lookup fused into the CYCLIC
window hash, on the card through ``csrc/rolling.cu`` (entry point
``cyclic_rolling_fused``; launch count in ``LOOKUP_LAUNCHES``).

On a CPU tensor each wrapper runs its plain version,
:func:`repro_torch.kernels.ref.sketch_plan_ref` and
:func:`repro_torch.kernels.ref.cyclic_fused_ref`. On a CUDA tensor it
launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.plan import (BloomSpec, CountMinSpec, HLLSpec,
                                      MinHashSpec, SketchPlan)

# kernel launches made by this wrapper (one per sketch_plan_fused call on
# CUDA tensors, one a group of eight in a larger plan); the smoke run
# resets it and reads it to show the main path went through the kernel
LAUNCHES = 0
# launches that ran each epilogue, by spec type name (a launch of a mixed
# plan counts under every kind it holds)
EPILOGUE_LAUNCHES = {t.__name__: 0 for t in
                     (MinHashSpec, HLLSpec, CountMinSpec, BloomSpec)}

# kernel launches made by cyclic_rolling_fused
LOOKUP_LAUNCHES = 0

SIGMA = 256  # the byte path's alphabet

_FAMILY_CODE = {"cyclic": 0, "general": 1}
_KIND = {MinHashSpec: 0, HLLSpec: 1, CountMinSpec: 2, BloomSpec: 3}
_MAX_SKETCHES = 8   # epilogue descriptors of one launch (csrc/sketch_plan.cu)


class _Epilogue(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("p0", ctypes.c_int),
                ("p1", ctypes.c_int), ("smem", ctypes.c_int),
                ("a", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("init", ctypes.c_void_p), ("out", ctypes.c_void_p)]


class _PlanDesc(ctypes.Structure):
    _fields_ = [("n_sketches", ctypes.c_int), ("unused", ctypes.c_int),
                ("sk", _Epilogue * _MAX_SKETCHES)]


def _bind(lib: ctypes.CDLL):
    fn = lib.sketch_plan
    if fn.argtypes is None:
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        fn.argtypes = [vp, vp, i, i, vp, vp, ctypes.POINTER(_PlanDesc), i, i,
                       i, u, u, ctypes.POINTER(ctypes.c_uint), vp]
        fn.restype = ctypes.c_int
    return fn


def launch_counts() -> dict:
    """``LAUNCHES`` and ``EPILOGUE_LAUNCHES`` as one dict (key ``"plan"``
    for the former)."""
    return {"plan": LAUNCHES, **EPILOGUE_LAUNCHES}


def add_launch_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign`` times a :func:`launch_counts`-shaped ``delta`` to the
    counters: a CUDA-graph replay launches what its capture recorded, and
    a capture launches nothing (``kernels/stream.py``)."""
    global LAUNCHES
    LAUNCHES += sign * delta["plan"]
    for kind in EPILOGUE_LAUNCHES:
        EPILOGUE_LAUNCHES[kind] += sign * delta[kind]


def sketch_groups(sketches) -> list:
    """A plan's ``(name, spec)`` sketches cut, in order, into consecutive
    groups of at most eight: one plan launch each."""
    sketches = tuple(sketches)
    return [sketches[i : i + _MAX_SKETCHES]
            for i in range(0, len(sketches), _MAX_SKETCHES)]


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} dtype {t.dtype} != {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def operand_shapes(spec) -> dict:
    """The shape of every uint32 runtime operand a sketch spec declares."""
    if isinstance(spec, MinHashSpec):
        return {"a": (spec.k,), "b": (spec.k,)}
    if isinstance(spec, CountMinSpec):
        return {"a": (spec.depth,), "b": (spec.depth,)}
    if isinstance(spec, BloomSpec):
        return {"bits": (spec.n_words,)}
    return {}


def _check_init(name: str, spec, init, B: int, dev):
    """An ``init`` carry in its output's exact shape and type on ``dev``
    (a donated one becomes that output) -> (shape, dtype) of the output."""
    shape, dtype_name, _ = spec.state_struct(B)
    dtype = torch.uint32 if dtype_name == "uint32" else torch.int32
    if init is not None:
        if not isinstance(init, torch.Tensor):
            raise TypeError(f"sketch {name!r}: init must be a tensor here, "
                            f"got {type(init).__name__}")
        _check(init, f"sketch {name!r} init", dtype, shape, dev)
    return shape, dtype


def _epilogue(name: str, spec, ops: dict, plan: SketchPlan, B: int, dev,
              donate: bool):
    """-> (the C descriptor, its output tensor) for one sketch, with its
    operands checked against what the kernel reads. A donated ``init`` is
    the output itself: the kernel folds into it in place."""
    u32 = torch.uint32
    init = ops.get("init")
    shape, dtype = _check_init(name, spec, init, B, dev)
    if isinstance(spec, MinHashSpec):
        p0, p1 = spec.k, 0
    elif isinstance(spec, HLLSpec):
        if spec.b > 31:
            raise ValueError(f"sketch {name!r}: HLL b={spec.b} > 31")
        p0, p1 = spec.b, spec.resolve_rank_bits(plan.hash)
    elif isinstance(spec, CountMinSpec):
        p0, p1 = spec.depth, spec.log2_width
    else:
        p0, p1 = spec.k, spec.log2_m
    for op, op_shape in operand_shapes(spec).items():
        _check(ops[op], f"sketch {name!r} operand {op!r}", u32, op_shape, dev)
    out = (init if donate and init is not None
           else torch.empty(shape, dtype=dtype, device=dev))
    ep = _Epilogue(kind=_KIND[type(spec)], p0=p0, p1=p1,
                   a=_ptr(ops.get("a", ops.get("bits"))), b=_ptr(ops.get("b")),
                   init=_ptr(init), out=out.data_ptr())
    return ep, out


def sketch_plan_fused(h1v: torch.Tensor, h1v_b, n_windows: torch.Tensor,
                      operands, *, plan: SketchPlan, w_start=None,
                      donate: bool = False) -> dict:
    """Execute every sketch in ``plan``: one rolling-hash launch for each
    group of up to eight sketches (:func:`sketch_groups`), so ONE for a
    plan of eight or fewer.

    h1v and h1v_b (B, S) uint32 (h1v_b only for a plan with a Bloom
    sketch), n_windows (B,) int32 (at most S-n+1), w_start (B,) int32 or
    None, operands ``{name: {...}}`` as ``api.run`` checks them, each
    sketch's optional ``init`` in the shape and type of its output ->
    ``{name: MinHash (B, k) uint32 | HLL (2^b,) int32 | CountMin (depth,
    2^w) int32 | Bloom (B,) int32}``. Without ``init`` a sketch starts at
    its identity.

    ``donate=True`` hands each ``init`` to the kernel as its output: the
    kernel folds into it in place, the launch fills nothing, and the caller
    must not read the old carry again. Every donated ``init`` must have its
    output's exact shape and type on ``h1v``'s device. The plain version
    takes the flag's checks but stays functional (fresh outputs).
    """
    global LAUNCHES
    if h1v.device.type == "cpu":
        if donate:   # checked as the card's path checks it, then unused
            for name, spec in plan.sketches:
                _check_init(name, spec, (operands.get(name) or {}).get(
                    "init"), h1v.shape[0], h1v.device)
        return _ref.sketch_plan_ref(plan, h1v, h1v_b, n_windows, operands,
                                    w_start=w_start)
    if not h1v.is_cuda:
        raise ValueError(f"sketch_plan_fused runs on CUDA or CPU tensors, "
                         f"got {h1v.device}")
    dev = h1v.device
    if h1v.dim() != 2:
        raise ValueError(f"h1v must be (B, S), got shape {tuple(h1v.shape)}")
    B, S = h1v.shape
    hs = plan.hash
    if S < hs.n:
        raise ValueError(f"sequence length {S} < window n={hs.n}")
    _check(h1v, "h1v", torch.uint32, (B, S), dev)
    if plan.needs_second_stream:
        if h1v_b is None:
            raise ValueError("plan contains a BloomSpec: the probe stride "
                             "needs a second stream h1v_b")
        _check(h1v_b, "h1v_b", torch.uint32, (B, S), dev)
    elif h1v_b is not None:
        raise ValueError("h1v_b given but no sketch in the plan consumes a "
                         "second hash stream")
    _check(n_windows, "n_windows", torch.int32, (B,), dev)
    if w_start is not None:
        _check(w_start, "w_start", torch.int32, (B,), dev)

    fn = _bind(_build.load("sketch_plan"))
    xpow = None
    if hs.family == "general":
        pows = _ref._xpows_host(hs.n, hs.p, hs.L)
        xpow = (ctypes.c_uint * hs.n)(
            *[pows[hs.n - 1 - t] for t in range(hs.n)])
    # every group's descriptors first: an operand a group rejects raises
    # before any launch (and before any donated carry is folded into)
    results, launches = {}, []
    for group in sketch_groups(plan.sketches):
        desc = _PlanDesc(n_sketches=len(group))
        for e, (name, spec) in enumerate(group):
            desc.sk[e], results[name] = _epilogue(
                name, spec, operands.get(name, {}), plan, B, dev, donate)
        # the second stream only where the group holds a Bloom sketch
        xb = (h1v_b if any(isinstance(spec, BloomSpec) for _, spec in group)
              else None)
        launches.append((group, desc, xb))
    for group, desc, xb in launches:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(h1v.data_ptr(), _ptr(xb), B, S, n_windows.data_ptr(),
                     _ptr(w_start), ctypes.byref(desc),
                     _FAMILY_CODE[hs.family], hs.n, hs.L, hs.hash_mask,
                     hs.p & ((1 << hs.L) - 1), xpow, stream)
        if err != 0:
            raise RuntimeError(f"sketch_plan launch failed: CUDA error {err}")
        LAUNCHES += 1
        for kind in {type(spec).__name__ for _, spec in group}:
            EPILOGUE_LAUNCHES[kind] += 1
    return results

def cyclic_rolling_fused(tokens: torch.Tensor, table: torch.Tensor, *, n: int,
                         L: int = 32) -> torch.Tensor:
    """The fused byte -> fingerprint path: tokens (B, S) int32 bytes, table
    (256,) uint32 -> (B, S-n+1) uint32 CYCLIC hashes of ``table[token] &
    mask(L)``, no discard. Replaces the JAX package's Pallas kernel
    ``repro/kernels/sketch_fused.py::cyclic_rolling_fused``. A token
    outside [0, 256) reads the entry :func:`ref.lookup_ref` gives it."""
    global LOOKUP_LAUNCHES
    if tokens.dim() != 2 or tuple(table.shape) != (SIGMA,):
        raise ValueError(f"need tokens (B, S) and table ({SIGMA},), got "
                         f"{tuple(tokens.shape)} and {tuple(table.shape)}")
    if tokens.device.type == "cpu":
        return _ref.cyclic_fused_ref(tokens, table, n, L).to(torch.uint32)
    if not tokens.is_cuda:
        raise ValueError(f"cyclic_rolling_fused runs on CUDA or CPU tensors, "
                         f"got {tokens.device}")
    _check(tokens, "tokens", torch.int32, tokens.shape, tokens.device)
    _check(table, "table", torch.uint32, (SIGMA,), tokens.device)
    if n < 1 or not 1 <= L <= 32:
        raise ValueError(f"need n >= 1 and 1 <= L <= 32, got n={n}, L={L}")
    B, S = tokens.shape
    if S < n:
        raise ValueError(f"sequence length {S} < window n={n}")
    out = torch.empty((B, S - n + 1), dtype=torch.uint32,
                      device=tokens.device)
    fn = _build.load("rolling").cyclic_rolling_fused
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, i, i, i, i, vp, vp]
        fn.restype = ctypes.c_int
    with torch.cuda.device(tokens.device):
        stream = torch.cuda.current_stream(tokens.device).cuda_stream
        err = fn(tokens.data_ptr(), table.data_ptr(), B, S, n, L,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cyclic_rolling_fused launch failed: CUDA error "
                           f"{err}")
    LOOKUP_LAUNCHES += 1
    return out
