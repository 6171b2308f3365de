"""GQA/MQA attention for serving: prefill over the prompt, single-token
decode against a fixed-capacity KV cache.

The JAX package computes attention outside any Pallas kernel (a chunked
online-softmax ``lax.scan``, ``repro/nn/attention.py``); so does the port,
in plain PyTorch: one matmul for the scores, a masked float32 softmax, one
matmul for the values. Scores and values are taken in float32 whatever the
activation dtype, and the output is cast back, as in the reference.

Supports GQA/MQA (any kv <= heads), RoPE or none, qk-norm (qwen3), qkv
bias (qwen1.5), logit soft-capping, prefix-LM masking, and decode with a
fixed-capacity cache whose length is one scalar for the whole batch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.nn.layers import (DTYPES, Linear, RMSNorm, linear_apply,
                                   rmsnorm_apply, rope)

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, Smax, KV, D)
    v: torch.Tensor       # (B, Smax, KV, D)
    length: int           # tokens already in the cache, for the whole batch


class Attention(nn.Module):
    """``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd, d), with
    q/k/v biases when ``cfg.qkv_bias`` and ``q_norm``/``k_norm`` when
    ``cfg.qk_norm``."""

    def __init__(self, gen: torch.Generator, cfg, device="cuda"):
        super().__init__()
        hd = cfg.resolved_head_dim
        dt = DTYPES[cfg.param_dtype]
        kw = dict(dtype=dt, device=device)
        self.wq = Linear(gen, (cfg.d_model,), (cfg.n_heads, hd),
                         bias=cfg.qkv_bias, **kw)
        self.wk = Linear(gen, (cfg.d_model,), (cfg.n_kv_heads, hd),
                         bias=cfg.qkv_bias, **kw)
        self.wv = Linear(gen, (cfg.d_model,), (cfg.n_kv_heads, hd),
                         bias=cfg.qkv_bias, **kw)
        self.wo = Linear(gen, (cfg.n_heads, hd), (cfg.d_model,), **kw)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, **kw)
            self.k_norm = RMSNorm(hd, **kw)


def attn_init(gen: torch.Generator, cfg, device="cuda") -> Attention:
    return Attention(gen, cfg, device)


def _project_qkv(params: Attention, cfg, x, positions):
    adt = DTYPES[cfg.activation_dtype]
    q = linear_apply(params.wq, x, "bsd,dhq->bshq", compute_dtype=adt)
    k = linear_apply(params.wk, x, "bsd,dgq->bsgq", compute_dtype=adt)
    v = linear_apply(params.wv, x, "bsd,dgq->bsgq", compute_dtype=adt)
    if cfg.qk_norm:
        q = rmsnorm_apply(params.q_norm, q, cfg.norm_eps)
        k = rmsnorm_apply(params.k_norm, k, cfg.norm_eps)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(q_pos, k_pos, prefix_len: int):
    """(..., Sq, Sk) bool: causal + bidirectional prefix."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if prefix_len > 0:
        ok = ok | (k_pos[..., None, :] < prefix_len)
    return ok


def attend(q, k, v, ok=None, *, softcap: float = 0.0,
           bf16_probs: bool = False):
    """q (B, Sq, H, D), k/v (B, Sk, KV, D), ``ok`` (B, Sq, Sk) bool or None
    (every key visible) -> (B, Sq, H, D) in q's dtype. The softmax is kept
    unnormalised through the value product and divided after, as the
    reference's online softmax does; ``bf16_probs`` rounds the
    probabilities and values to bfloat16 for that product (the reference's
    ``attn_bf16_scores``)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D).to(torch.float32)
    s = torch.einsum("bsgrd,bcgd->bsgrc", qg, k.to(torch.float32))
    s = s * (1.0 / np.sqrt(D))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    if ok is not None:
        s = s.masked_fill(~ok[:, :, None, None, :], NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    vf = v.to(torch.float32)
    if bf16_probs:
        p = p.to(torch.bfloat16).to(torch.float32)
        vf = v.to(torch.bfloat16).to(torch.float32)
    out = torch.einsum("bsgrc,bcgd->bsgrd", p, vf) / l.clamp_min(1e-30)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attn_forward(params: Attention, cfg, x, positions, *,
                 prefix_len: int = 0, return_kv: bool = False):
    """Prefill forward. x: (B, S, D); positions: (B, S)."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = attend(q, k, v, _mask(positions, positions, prefix_len),
                 softcap=cfg.attn_logit_softcap,
                 bf16_probs=cfg.attn_bf16_scores)
    y = linear_apply(params.wo, out, "bshq,hqd->bsd", compute_dtype=out.dtype)
    return (y, (k, v)) if return_kv else y


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def attn_decode(params: Attention, cfg, x, cache: KVCache):
    """Single-step decode. x: (B, 1, D). Returns (y, new_cache).

    The new token's K/V are written into the cache tensors in place (the
    reference returns updated copies); the returned cache shares them and
    counts one more token. The query at position ``length`` sees every key
    up to and including its own, so the valid prefix of the cache is
    sliced and no mask is needed. Like the reference's decode, it keeps
    the probabilities in float32 whatever ``attn_bf16_scores`` says."""
    B = x.shape[0]
    t = cache.length
    if t >= cache.k.shape[1]:
        raise ValueError(f"KV cache full: length {t} == capacity "
                         f"{cache.k.shape[1]}")
    pos = torch.full((B, 1), t, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, pos)
    cache.k[:, t] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, t] = v_new[:, 0].to(cache.v.dtype)
    out = attend(q, cache.k[:, : t + 1], cache.v[:, : t + 1],
                 softcap=cfg.attn_logit_softcap)
    y = linear_apply(params.wo, out, "bshq,hqd->bsd", compute_dtype=out.dtype)
    return y, KVCache(k=cache.k, v=cache.v, length=t + 1)
