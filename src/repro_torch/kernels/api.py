"""The plan engine: one validated entry point for the hash->sketch data-plane.

Callers build a declarative :class:`~repro_torch.kernels.plan.SketchPlan`
(hash family + named sketches) once and execute it with :func:`run`, which
flattens leading dims, validates the impl, operands and per-row counts,
applies the Theorem-1 discard mask, and runs every requested sketch in one
rolling-hash pass:

* ``impl="kernel"`` (or ``"auto"`` on a CUDA tensor) — the hand-written
  CUDA kernel behind :func:`repro_torch.kernels.sketch_fused.sketch_plan_fused`;
* ``impl="ref"`` (or ``"auto"`` on a CPU tensor) — the plain PyTorch
  executor :func:`repro_torch.kernels.ref.sketch_plan_ref`.

Both are bit-identical. ``impl="kernel"`` on a CPU tensor raises. Inputs
may be tensors or numpy arrays: a tensor stays on its device unless
``device`` says otherwise, an array goes to ``device`` (default ``cuda``).
Hash values travel as uint32 tensors and counts as int32.

Example::

    from repro_torch.kernels import api
    from repro_torch.kernels.plan import HashSpec, HLLSpec, MinHashSpec, SketchPlan

    plan = SketchPlan(hash=HashSpec(family="cyclic", n=8, L=32),
                      sketches={"sig": MinHashSpec(k=64),
                                "hll": HLLSpec(b=12)})
    out = api.run(plan, h1v, n_windows=nw,
                  operands={"sig": {"a": a, "b": b}})
    out["sig"]                                  # (..., 64) uint32
    out["hll"]                                  # (4096,) int32
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.analysis.contracts import kernel_contract
from repro_torch.core import u32
from repro_torch.kernels import decode as _dk
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sketch_fused as _sf
from repro_torch.kernels.plan import (BloomSpec, DecodeSpec, MinHashSpec,
                                      SketchPlan)

_IMPLS = ("auto", "kernel", "ref")


def resolve_device(x, device=None) -> torch.device:
    """``device`` when given; else a tensor's own device; else ``cuda``."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return torch.device("cuda")


def as_u32(x, device) -> torch.Tensor:
    """Integer values below 2^32 (tensor or array) -> a uint32 tensor on
    ``device``. int32 tensors are taken as bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32:
            x = x.view(torch.uint32)
        elif x.dtype != torch.uint32:
            x = x.to(torch.int64).to(torch.uint32)
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).astype(np.uint32))).to(device)


def as_i32(x, device) -> torch.Tensor:
    return torch.as_tensor(
        x if isinstance(x, torch.Tensor) else np.asarray(x, np.int32),
        device=device).to(torch.int32)


def full_u32(shape, fill: int, device) -> torch.Tensor:
    """``torch.full`` of a uint32 value, through the int32 view (which every
    backend implements)."""
    fill = fill - (1 << 32) if fill >= 1 << 31 else fill
    return torch.full(shape, fill, dtype=torch.int32,
                      device=device).view(torch.uint32)


def use_ref(impl: str, device) -> bool:
    """Validate ``impl`` and decide the dispatch for tensors on ``device``:
    True for the plain version, False for the CUDA kernel."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl={impl!r}; expected one of {_IMPLS}")
    dev = torch.device(device)
    if impl == "ref":
        return True
    if dev.type == "cuda":
        return False
    if impl == "kernel":
        raise ValueError(f"impl='kernel' launches the CUDA kernel and needs "
                         f"tensors on a CUDA device, got {dev}")
    if dev.type == "cpu":
        return True
    raise ValueError(f"no kernel or plain path for device {dev}")


def flatten(x: torch.Tensor):
    """(..., S) -> ((B, S), leading-shape)."""
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]), lead


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad (B, S) uint32 on the right up to ``width`` columns."""
    out = torch.zeros((x.shape[0], width), dtype=torch.int32,
                      device=x.device)
    out[:, : x.shape[1]] = x.view(torch.int32)
    return out.view(torch.uint32)


def prepare(h1v, *, n: int, impl: str, allow_short: bool = False,
            device=None):
    """The validated prologue: resolve the device and the impl dispatch,
    flatten leading dims, check the window fits.

    ``allow_short=True`` (the sketch engine) accepts ``S < n`` — a short row
    is legal in a padded/chunked batch and simply has ``n_windows = 0`` — by
    zero-padding up to ``S = n`` so the kernel has one physical window
    (masked by the W=0 clamp in :func:`validate`).

    Returns (x (B, max(S, n)) uint32 contiguous, lead shape, use_ref flag)."""
    dev = resolve_device(h1v, device)
    ref_path = use_ref(impl, dev)     # validates impl before any shape work
    x, lead = flatten(as_u32(h1v, dev))
    S = x.shape[-1]
    if S < n:
        if not allow_short:
            raise ValueError(f"sequence length {S} < window n={n}")
        x = _pad_cols(x, n)
    return x.contiguous(), lead, ref_path


def check_row_counts(counts, what: str, upper: Optional[int] = None) -> None:
    """Reject out-of-range per-row counts with the offending row index:
    negative always, and above ``upper`` when one is given. Reads the
    values on the host."""
    vals = (counts.cpu().numpy() if isinstance(counts, torch.Tensor)
            else np.asarray(counts))
    flat = vals.reshape(-1)

    def where(i):          # multi-dim counts (e.g. (T, B) chunk stacks)
        if vals.ndim <= 1:
            return f"row {i}"
        return f"row {np.unravel_index(i, vals.shape)}"

    neg = flat < 0
    if neg.any():
        i = int(np.argmax(neg))
        raise ValueError(
            f"{what} must be non-negative; {where(i)} has {int(flat[i])}")
    if upper is not None:
        over = flat > upper
        if over.any():
            i = int(np.argmax(over))
            raise ValueError(
                f"{what} must be <= {upper}; {where(i)} has {int(flat[i])}")


def norm_windows(n_windows, B: int, W: int, device) -> torch.Tensor:
    """-> (B,) int32 valid-window counts, clamped to the physical W;
    negative counts are rejected with the offending row index."""
    if n_windows is None:
        return torch.full((B,), W, dtype=torch.int32, device=device)
    check_row_counts(n_windows, "n_windows")
    nw = as_i32(n_windows, device).reshape(-1)
    if tuple(nw.shape) != (B,):
        raise ValueError(f"n_windows shape {tuple(nw.shape)} != batch ({B},)")
    return nw.clamp(max=W).contiguous()


def norm_w_start(w_start, B: int, W: int, device):
    """-> (B,) int32 first-valid-window indices (or None = 0 everywhere).
    Window ``j`` of row ``i`` counts iff ``w_start[i] <= j < n_windows[i]``;
    the streaming executor uses it to exclude windows that would span a
    chunk's zero-filled history at the very start of a stream."""
    if w_start is None:
        return None
    ws = as_i32(w_start, device).reshape(-1)
    if tuple(ws.shape) != (B,):
        raise ValueError(f"w_start shape {tuple(ws.shape)} != batch ({B},)")
    return ws.clamp(0, W).contiguous()


def as_state(x, dtype_name: str, device) -> torch.Tensor:
    """A sketch state (tensor or array) -> its ``state_struct`` dtype on
    ``device``: uint32 through :func:`as_u32`, int32 through
    :func:`as_i32`."""
    if dtype_name == "uint32":
        return as_u32(x, device)
    if isinstance(x, torch.Tensor) and x.dtype == torch.uint32:
        return x.view(torch.int32).to(device)
    return as_i32(x, device)


def _check_operands(plan: SketchPlan, operands, batch: Optional[int],
                    device) -> Dict[str, dict]:
    """Every sketch gets exactly the operand tensors its spec declares
    (uint32 on ``device``, as the kernel takes them), plus an optional
    ``init`` carry-in of its running state in the spec's ``state_struct``
    dtype (its shape checked when the flattened batch size is known)."""
    operands = dict(operands or {})
    unknown = set(operands) - set(plan.names)
    if unknown:
        raise ValueError(f"operands for sketches not in plan: {sorted(unknown)}")
    for name, spec in plan.sketches:
        raw = operands.get(name) or {}
        want = spec.operand_names
        if set(raw) - {"init"} != set(want):
            raise ValueError(
                f"sketch {name!r} ({type(spec).__name__}) needs operands "
                f"{list(want)}, got {sorted(raw)}")
        got = {k: as_u32(v, device).contiguous() for k, v in raw.items()
               if k != "init"}
        for op, shape in _sf.operand_shapes(spec).items():
            if tuple(got[op].shape) != shape:
                raise ValueError(
                    f"sketch {name!r}: operand {op!r} shape "
                    f"{tuple(got[op].shape)} != {shape}")
        if "init" in raw:
            shape, dtype_name, _ = spec.state_struct(batch or 0)
            got["init"] = as_state(raw["init"], dtype_name,
                                   device).contiguous()
            if batch is not None and tuple(got["init"].shape) != shape:
                raise ValueError(
                    f"sketch {name!r}: init carry shape "
                    f"{tuple(got['init'].shape)} != state shape {shape} "
                    f"(flattened batch {batch})")
        operands[name] = got
    return operands


def needs_second_stream(plan: SketchPlan, given, name: str) -> bool:
    """Whether the plan takes a second hash stream (it holds a Bloom
    sketch); raises when the caller's ``given`` argument ``name`` is
    missing although needed, or present although not."""
    if plan.needs_second_stream and given is None:
        raise ValueError(f"plan contains a BloomSpec: the double-hashing "
                         f"probe stride needs a second stream {name}")
    if not plan.needs_second_stream and given is not None:
        raise ValueError(f"{name} given but no sketch in the plan consumes "
                         f"a second hash stream")
    return plan.needs_second_stream


def second_stream(plan: SketchPlan, h1v_b, shape, device):
    """``h1v_b`` as (B, S) uint32 on ``device`` when the plan holds a Bloom
    sketch, else None. ``shape`` is the (B, S0) of the flattened first
    stream."""
    if not needs_second_stream(plan, h1v_b, "h1v_b"):
        return None
    xb, _ = flatten(as_u32(h1v_b, device))
    if tuple(xb.shape) != tuple(shape):
        raise ValueError(f"h1v_b shape {tuple(xb.shape)} != h1v shape "
                         f"{tuple(shape)}")
    return xb.contiguous()


def validate(plan: SketchPlan, h1v, h1v_b, n_windows, operands, impl: str,
             w_start=None, device=None):
    """The front half of :func:`run`: validate + normalize everything.

    Returns ``(x (B, S), xb (B, S) | None, nw (B,), ws (B,) | None,
    operands, lead, ref_path)`` ready for :func:`execute`. ``h1v_b`` is
    required exactly when the plan holds a Bloom sketch.

    ``S < n`` inputs are legal here (every row simply has zero valid
    windows): the rows are zero-padded to ``S = n`` and the window clamp
    masks everything, so a chunk of documents all shorter than the n-gram
    window signs to sentinel signatures instead of raising.
    """
    if not isinstance(plan, SketchPlan):
        raise TypeError(f"plan must be a SketchPlan, got {type(plan)}")
    n = plan.hash.n
    dev = resolve_device(h1v, device)
    S0 = h1v.shape[-1]
    x, lead, ref_path = prepare(h1v, n=n, impl=impl, allow_short=True,
                                device=dev)
    B, S = x.shape
    operands = _check_operands(plan, operands, B, dev)
    xb = second_stream(plan, h1v_b, (B, S0), dev)
    if xb is not None and S0 < S:
        xb = _pad_cols(xb, S)
    W = max(0, S0 - n + 1)          # windows of the *caller's* rows
    nw = norm_windows(n_windows, B, W, dev)
    ws = norm_w_start(w_start, B, W, dev)
    return x, xb, nw, ws, operands, lead, ref_path


def execute(plan: SketchPlan, x, xb, nw, operands, ref_path: bool,
            w_start=None, donate: bool = False) -> Dict[str, torch.Tensor]:
    """The back half: dispatch validated (B, S) tensors to the CUDA kernel's
    wrapper or the plain executor. ``donate`` hands every ``init`` carry to
    the kernel as its output (folded in place, no fill); the plain executor
    ignores it."""
    if ref_path:
        return _ref.sketch_plan_ref(plan, x, xb, nw, operands,
                                    w_start=w_start)
    return _sf.sketch_plan_fused(x, xb, nw, operands, plan=plan,
                                 w_start=w_start, donate=donate)


def shape_outputs(plan: SketchPlan, out: Dict[str, torch.Tensor],
                  lead) -> Dict[str, torch.Tensor]:
    """Restore the caller's leading dims on per-row outputs: MinHash
    (..., k), Bloom (...,). HLL registers (2^b,) and the CountMin table
    (depth, 2^w) are corpus-level and pass through."""
    results = {}
    for name, spec in plan.sketches:
        o = out[name]
        if isinstance(spec, MinHashSpec):
            o = o.reshape(lead + (spec.k,))
        elif isinstance(spec, BloomSpec):
            o = o.reshape(lead)
        results[name] = o
    return results


@kernel_contract(kernel="plan", launches=1, dispatches=0, merges="none")
def run(plan: SketchPlan, h1v, *, h1v_b=None, n_windows=None, operands=None,
        impl: str = "auto", w_start=None,
        device=None) -> Dict[str, torch.Tensor]:
    """Execute a :class:`SketchPlan` over (..., S) h1-mapped values.

    Args:
      plan: hash family + named sketch specs.
      h1v: (..., S) h1-mapped token values below 2^32 (uint32 tensor, or
        any integer tensor or array); leading dims are flattened to a batch
        and restored on return.
      h1v_b: second independent family draw, required iff the plan
        contains a :class:`BloomSpec` (double-hashing probe stride).
      n_windows: optional (...,) per-row valid-window counts for padded
        batches; ``None`` means every window of every row is valid.
      operands: ``{sketch_name: {operand_name: values}}`` — MinHash remix
        lanes ``a``/``b`` (k,), the packed Bloom filter ``bits``
        (2^log2_m/32,), the CountMin row remix constants ``a``/``b``
        (depth,); plus an optional ``init`` carry of each sketch's running
        state (see the spec's ``state_struct``), folded in with the
        sketch's own merge operator.
      impl: ``"auto"`` (the kernel on CUDA, the plain version on CPU),
        ``"kernel"`` (the kernel; raises on CPU) or ``"ref"``.
      w_start: optional (...,) per-row *first* valid window index (window j
        counts iff ``w_start <= j < n_windows``); ``None`` means 0.
      device: where the computation runs (default: ``h1v``'s device for a
        tensor, else ``cuda``).

    Returns ``{sketch_name: result}`` — MinHash (..., k) uint32, HLL (2^b,)
    int32 (reduced over the whole batch), Bloom (...,) int32 hit counts,
    CountMin (depth, 2^log2_width) int32 counts (additive: fold into a
    running table with ``+``, or pass it as ``init``).
    """
    x, xb, nw, ws, operands, lead, ref_path = validate(
        plan, h1v, h1v_b, n_windows, operands, impl, w_start, device)
    out = execute(plan, x, xb, nw, operands, ref_path, w_start=ws)
    return shape_outputs(plan, out, lead)


@kernel_contract(kernel="decode", launches=1, dispatches=0, merges="none")
def decode(spec: DecodeSpec, logits, prefix, ready, bloom, h1, *,
           canary_bits=None, impl: str = "auto",
           device=None) -> Dict[str, torch.Tensor]:
    """Decode-time n-gram plane: hash every candidate continuation, probe
    the per-session no-repeat filter (and the optional shared decontam
    canary), and mask the logits — ONE launch of the decode kernel on a
    CUDA device, its plain version on the CPU.

    Args:
      spec: :class:`~repro_torch.kernels.plan.DecodeSpec`.
      logits: (B, V) float logits for this decode step (cast to float32).
      prefix: (B,) uint32 rolling prefix hashes (last n-1 tokens).
      ready: (B,) bool/int — the session has >= n-1 symbols of history (a
        not-ready session bans nothing and registers no canary hits).
      bloom: (B, 2^log2_m/32) uint32 packed per-session filters.
      h1: (V,) uint32 symbol hashes (masked to L bits here).
      canary_bits: (2^canary_log2_m/32,) uint32 shared filter, required iff
        ``spec.has_canary``.
      impl: ``"auto"`` (the kernel on CUDA, the plain version on the CPU),
        ``"kernel"`` or ``"ref"`` — the contract of :func:`run`.
      device: where arrays go (default: the logits tensor's device, else
        ``cuda``).

    Returns ``{"logits": (B, V) float32 banned-masked logits, "banned":
    (B, ceil(V/32)) uint32 packed mask[, "canary": packed hit mask]}``.
    """
    if not isinstance(spec, DecodeSpec):
        raise TypeError(f"spec must be a DecodeSpec, got {type(spec)}")
    dev = resolve_device(logits, device)
    ref_path = use_ref(impl, dev)
    logits = torch.as_tensor(logits, device=dev).to(torch.float32)
    if logits.dim() != 2:
        raise ValueError(f"logits must be (B, V), got shape "
                         f"{tuple(logits.shape)}")
    B, V = logits.shape
    prefix = as_u32(prefix, dev)
    ready = torch.as_tensor(ready, device=dev)
    if ready.dtype == torch.uint32:
        ready = ready.view(torch.int32)
    for name, arr in (("prefix", prefix), ("ready", ready)):
        if tuple(arr.shape) != (B,):
            raise ValueError(f"{name} shape {tuple(arr.shape)} != batch "
                             f"({B},)")
    bloom = as_u32(bloom, dev)
    if tuple(bloom.shape) != (B, spec.n_words):
        raise ValueError(f"bloom words shape {tuple(bloom.shape)} != "
                         f"({B}, {spec.n_words}) for log2_m={spec.log2_m}")
    h1 = as_u32(h1, dev)
    if tuple(h1.shape) != (V,):
        raise ValueError(f"h1 shape {tuple(h1.shape)} != vocab ({V},)")
    h1 = u32.keep_low(h1, spec.L)
    if spec.has_canary:
        if canary_bits is None:
            raise ValueError("spec has a decontam canary filter: pass "
                             "canary_bits (2^canary_log2_m/32,)")
        canary_bits = as_u32(canary_bits, dev)
        if tuple(canary_bits.shape) != (spec.canary_words,):
            raise ValueError(f"canary_bits shape "
                             f"{tuple(canary_bits.shape)} != "
                             f"({spec.canary_words},) for canary_log2_m="
                             f"{spec.canary_log2_m}")
        canary_bits = canary_bits.contiguous()
    elif canary_bits is not None:
        raise ValueError("canary_bits given but spec.canary_log2_m == 0")
    args = (logits.contiguous(), prefix.contiguous(), ready.contiguous(),
            bloom.contiguous(), h1.contiguous())
    if ref_path:
        return _ref.decode_masks_ref(
            *args, n=spec.n, L=spec.L, hash_mask=spec.hash_mask,
            log2_m=spec.log2_m, k=spec.k, canary_bits=canary_bits,
            canary_log2_m=spec.canary_log2_m, canary_k=spec.canary_k)
    return _dk.decode_masks_fused(*args, spec=spec, canary_bits=canary_bits)
