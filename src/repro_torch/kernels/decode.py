"""The decode plane's wrapper: candidate hashing, the Theorem-2 discard,
per-session no-repeat Bloom probes, the shared decontam canary probes and
the banned-logit substitution in ONE launch of ``csrc/decode.cu``.

Replaces the JAX package's Pallas kernel
``repro/kernels/decode.py::decode_masks_fused``. The recursive CYCLIC
structure prices every candidate continuation of a session at one rotate
and one XOR, ``h_cand = rotl(h_prefix, 1) ^ h1[v]`` for the whole
vocabulary at once; the kernel probes each masked candidate hash against
the session's filter and writes the masked logits and bit-packed
banned/canary masks (32 candidates a uint32 word).

On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.decode_masks_ref`. On a CUDA tensor it
launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.plan import DecodeSpec

# kernel launches made by this wrapper (one per call on CUDA tensors); the
# smoke run resets it and reads it to show the serve path went through the
# kernel
LAUNCHES = 0


def _bind(lib: ctypes.CDLL):
    fn = lib.decode_masks
    if fn.argtypes is None:
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        fn.argtypes = [vp, vp, vp, i, vp, vp, vp, i, i, i, u, i, i, i, i,
                       vp, vp, vp, vp]
        fn.restype = ctypes.c_int
    return fn


# flag types the kernel reads as they are (nonzero = ready), by byte width;
# any other type becomes int32 first
_READY_BYTES = {torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
                torch.int32: 4, torch.int64: 8}


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} dtype {t.dtype} != {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def decode_masks_fused(logits: torch.Tensor, prefix: torch.Tensor,
                       ready: torch.Tensor, bloom: torch.Tensor,
                       h1: torch.Tensor, *, spec: DecodeSpec,
                       canary_bits=None) -> dict:
    """ONE launch: candidate hashing + Bloom probing + logit masking.

    logits (B, V) float32, prefix (B,) uint32, ready (B,) bool or int,
    bloom (B, 2^log2_m/32) uint32 per-session filters, h1 (V,) uint32
    (masked to L bits by ``api.decode``), canary_bits (2^canary_log2_m/32,)
    uint32 shared filter iff ``spec.has_canary`` -> ``{"logits", "banned"[,
    "canary"]}`` exactly as :func:`repro_torch.kernels.ref.decode_masks_ref`.
    """
    global LAUNCHES
    if logits.device.type == "cpu":
        return _ref.decode_masks_ref(
            logits, prefix, ready, bloom, h1, n=spec.n, L=spec.L,
            hash_mask=spec.hash_mask, log2_m=spec.log2_m, k=spec.k,
            canary_bits=canary_bits, canary_log2_m=spec.canary_log2_m,
            canary_k=spec.canary_k)
    if not logits.is_cuda:
        raise ValueError(f"decode_masks_fused runs on CUDA or CPU tensors, "
                         f"got {logits.device}")
    dev = logits.device
    if logits.dim() != 2:
        raise ValueError(f"logits must be (B, V), got shape "
                         f"{tuple(logits.shape)}")
    B, V = logits.shape
    u32 = torch.uint32
    _check(logits, "logits", torch.float32, (B, V), dev)
    _check(prefix, "prefix", u32, (B,), dev)
    if tuple(ready.shape) != (B,) or ready.device != dev:
        raise ValueError(f"ready must be ({B},) on {dev}, got "
                         f"{tuple(ready.shape)} on {ready.device}")
    _check(bloom, "bloom", u32, (B, spec.n_words), dev)
    _check(h1, "h1", u32, (V,), dev)
    if spec.has_canary:
        if canary_bits is None:
            raise ValueError("spec has a canary filter: pass canary_bits")
        _check(canary_bits, "canary_bits", u32, (spec.canary_words,), dev)
    elif canary_bits is not None:
        raise ValueError("canary_bits given but spec.canary_log2_m == 0")
    rd = (ready.contiguous() if ready.dtype in _READY_BYTES
          else (ready != 0).to(torch.int32))
    W = -(-V // 32)
    out = torch.empty((B, V), dtype=torch.float32, device=dev)
    banned = torch.empty((B, W), dtype=u32, device=dev)
    canary = (torch.empty((B, W), dtype=u32, device=dev)
              if spec.has_canary else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    decode_masks = _bind(_build.load("decode"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = decode_masks(
            logits.data_ptr(), prefix.data_ptr(), rd.data_ptr(),
            _READY_BYTES[rd.dtype], bloom.data_ptr(), h1.data_ptr(),
            ptr(canary_bits), B, V, spec.L, spec.hash_mask, spec.log2_m,
            spec.k, spec.canary_log2_m, spec.canary_k, out.data_ptr(),
            banned.data_ptr(), ptr(canary), stream)
    if err != 0:
        raise RuntimeError(f"decode_masks launch failed: CUDA error {err}")
    LAUNCHES += 1
    results = {"logits": out, "banned": banned}
    if canary is not None:
        results["canary"] = canary
    return results
