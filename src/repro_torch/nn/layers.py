"""Base layers: RMSNorm, einsum linear, embedding, RoPE.

Each layer is a small ``nn.Module`` that holds its parameters under the
names of the JAX package's parameter trees (``scale``, ``w``, ``b``,
``table``), beside a functional apply as in the reference
(``rmsnorm_apply(norm, x)``, ``linear_apply(lin, x, contract)``, ...).
Weights keep the reference's einsum layouts: a linear map from ``in_dims``
to ``out_dims`` holds ``w`` of shape ``in_dims + out_dims`` (``(d, h, q)``
for a query projection, ``(h, q, d)`` for the output projection).

The dtype rules are the reference's (``repro/nn/layers.py``): RMSNorm
computes in float32 and returns the input dtype; matmuls run in the
activation dtype; a bias is added in the output dtype; RoPE rotates in
float32. Parameters are drawn from an explicit ``torch.Generator``, which
does not give JAX's threefry bits: parity with the reference carries its
weights across (:func:`repro_torch.convert.lm_params_from_jax`). They
take gradients; the serving entry points run under ``torch.no_grad``.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


def truncated_normal(gen: torch.Generator, shape, stddev: float,
                     device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``stddev``, in float32."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * stddev


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.scale = _param(torch.ones((dim,), dtype=dtype, device=device))


def rmsnorm_apply(norm: RMSNorm, x: torch.Tensor, eps: float = 1e-6,
                  var: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``var``: the float32 mean square over the normalised dimension,
    when ``x`` is one model shard of it (the Mamba gated norm)."""
    orig = x.dtype
    xf = x.to(torch.float32)
    if var is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * norm.scale.to(torch.float32)).to(orig)


# ---------------------------------------------------------------------------
# Linear (arbitrary in/out shapes, einsum-based)
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """``w`` (in_dims + out_dims) drawn fan-in scaled (``1 /
    sqrt(prod(in_dims))``), optional zero bias ``b`` (out_dims)."""

    def __init__(self, gen: torch.Generator, in_dims: Sequence[int],
                 out_dims: Sequence[int], *, bias: bool = False,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        fan_in = int(np.prod(in_dims))
        w = truncated_normal(gen, tuple(in_dims) + tuple(out_dims),
                             1.0 / np.sqrt(fan_in), device)
        self.w = _param(w.to(dtype))
        self.b = (_param(torch.zeros(tuple(out_dims), dtype=dtype,
                                     device=device)) if bias else None)


def linear_apply(lin: Linear, x: torch.Tensor, contract: str,
                 compute_dtype=None) -> torch.Tensor:
    """einsum-style apply; ``contract`` e.g. ``'bsd,dhq->bshq'``."""
    w = lin.w
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = torch.einsum(contract, x, w)
    if lin.b is not None:
        y = y + lin.b.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """``table`` (vocab, dim), standard normal over sqrt(dim): keeps the
    tied-logit variance O(1) at init."""

    def __init__(self, gen: torch.Generator, vocab: int, dim: int,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        tbl = torch.empty((vocab, dim), dtype=torch.float32, device=device)
        tbl.normal_(generator=gen)
        self.table = _param((tbl / np.sqrt(dim)).to(dtype))


def embedding_lookup(emb: Embedding, tokens: torch.Tensor,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The rows of ``tokens`` in ``compute_dtype`` (gathered, then cast:
    the same values as the reference's cast-then-gather)."""
    return emb.table[tokens].to(compute_dtype)


def embedding_logits(emb: Embedding, x: torch.Tensor,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    tbl = emb.table.to(compute_dtype)
    return torch.einsum("bsd,vd->bsv", x.to(compute_dtype), tbl)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rope_freqs(D: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's float32 frequencies, computed the same way in numpy,
    copied to ``device`` once: a copy from host memory at every call would
    wait for the card to drain its queue."""
    freqs = 1.0 / (theta ** (np.arange(D // 2, dtype=np.float32) * 2.0 / D))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) integers."""
    B, S, H, D = x.shape
    half = D // 2
    freqs = _rope_freqs(D, float(theta), x.device)
    ang = positions.to(torch.float32)[..., None] * freqs     # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
