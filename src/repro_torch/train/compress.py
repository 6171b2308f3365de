"""Gradient compression for a cross-pod all-reduce, as in the JAX
package's ``train/compress.py``.

``quantize_int8`` scales a gradient to int8 by its largest magnitude and
rounds stochastically (unbiased: E[q * scale] = g, error below one step),
with the uniforms drawn from an explicit ``torch.Generator``;
``dequantize_int8`` undoes the scale. The reference applies them over a
``pod`` axis bound by ``shard_map`` before the pod-axis sum and degrades
to the identity where no such axis is bound; its train step calls it
under ``jit`` with no ``shard_map``, so no axis is bound there, on any
mesh. :func:`compress_pod_gradients` is therefore the identity, on one
device and on a model mesh with a ``pod`` axis alike: the reference's
result.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def quantize_int8(x: torch.Tensor,
                  gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization. Returns (q int8, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    scaled = x / scale
    floor = torch.floor(scaled)
    prob = scaled - floor
    rnd = torch.rand(x.shape, generator=gen, device=x.device)
    q = floor + (rnd < prob).to(torch.float32)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_pod_gradients(grads: Dict[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """Quantize, sum over a bound ``pod`` axis and dequantize, leaf by
    leaf: the train step binds none (as the reference's does not), so the
    gradients come back as they are."""
    return grads
