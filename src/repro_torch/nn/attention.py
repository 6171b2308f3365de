"""GQA/MQA attention: the chunked flash forward of training and prefill,
and single-token decode against a fixed-capacity KV cache.

The JAX package computes attention outside any Pallas kernel (a chunked
online-softmax ``lax.scan``, ``repro/nn/attention.py``); so does the port,
in plain PyTorch: :func:`flash_attention` loops over the same KV chunks
with the same running max and sum, and autograd differentiates it. Scores
and values are taken in float32 whatever the activation dtype, and the
output is cast back, as in the reference. ``F.scaled_dot_product_attention``
is not used: it expresses neither the logit soft cap nor bfloat16
probabilities.

Supports GQA/MQA (any kv <= heads), RoPE or none, qk-norm (qwen3), qkv
bias (qwen1.5), logit soft-capping, prefix-LM masking, and decode with a
fixed-capacity cache whose length is one scalar for the whole batch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

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


def attend(q, k, v, *, softcap: float = 0.0):
    """Decode attention: q (B, Sq, H, D) against every key of k/v (B, Sk,
    KV, D) -> (B, Sq, H, D) in q's dtype, in float32. The softmax is kept
    unnormalised through the value product and divided after, as the
    reference's online softmax does."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D).to(torch.float32)
    s = torch.einsum("bsgrd,bcgd->bsgrc", qg, k.to(torch.float32))
    s = s * (1.0 / np.sqrt(D))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bsgrc,bcgd->bsgrd", p, v.to(torch.float32))
    out = out / l.clamp_min(1e-30)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention(q, k, v, q_pos, k_pos, *, kv_chunk: int,
                    prefix_len: int = 0, softcap: float = 0.0,
                    kv_valid: Optional[torch.Tensor] = None,
                    bf16_probs: bool = False):
    """Online-softmax attention over ``kv_chunk`` blocks of keys, as the
    reference's ``lax.scan`` (``repro/nn/attention.py::flash_attention``).

    q: (B, Sq, H, D); k/v: (B, Sk, KV, D); q_pos: (B, Sq); k_pos: (B, Sk).
    kv_valid: optional (B, Sk) bool; False entries are masked. A tail that
    ``kv_chunk`` does not divide is padded with keys at position 2**30
    that ``kv_valid`` masks. ``bf16_probs`` rounds the probabilities and
    values to bfloat16 for the value product, which sums in float32 (the
    running max and sum stay float32). Scores, max and sum are float32;
    the output is cast to q's dtype. Autograd gives the backward.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = 1.0 / np.sqrt(D)
    nchunks = -(-Sk // kv_chunk)
    pad = nchunks * kv_chunk - Sk
    if kv_valid is None:
        kv_valid = torch.ones((B, Sk), dtype=torch.bool, device=q.device)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2**30)
        kv_valid = F.pad(kv_valid, (0, pad), value=False)
    qg = q.reshape(B, Sq, KV, rep, D).to(torch.float32)
    m = torch.full((B, Sq, KV, rep), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sq, KV, rep), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KV, rep, D), dtype=torch.float32,
                      device=q.device)
    for c in range(nchunks):
        blk = slice(c * kv_chunk, (c + 1) * kv_chunk)
        s = torch.einsum("bsgrd,bcgd->bsgrc", qg,
                         k[:, blk].to(torch.float32)) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        ok = (_mask(q_pos, k_pos[:, blk], prefix_len)
              & kv_valid[:, None, blk])                     # (B, Sq, kc)
        s = torch.where(ok[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        vb = v[:, blk]
        if bf16_probs:
            p = p.to(torch.bfloat16).to(torch.float32)
            vb = vb.to(torch.bfloat16)
        acc = acc * corr[..., None] + torch.einsum(
            "bsgrc,bcgd->bsgrd", p, vb.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_causal_skip(q, k, v, q_pos, k_pos, *, q_chunk: int,
                                kv_chunk: int, prefix_len: int = 0,
                                softcap: float = 0.0,
                                bf16_probs: bool = False):
    """Causal flash attention with a static KV range a q chunk: chunk i
    visits keys ``[0, ceil(max((i+1)*q_chunk, prefix_len) / kv_chunk) *
    kv_chunk)`` and never the blocks wholly in its future. Positions must
    be aligned (training, prefill)."""
    B, Sq, H, D = q.shape
    nq = -(-Sq // q_chunk)
    pad_q = nq * q_chunk - Sq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q), value=2**30)
    outs = []
    for qi in range(nq):
        rows = slice(qi * q_chunk, (qi + 1) * q_chunk)
        need = max((qi + 1) * q_chunk, prefix_len)  # prefix rows see it all
        hi = min(-(-need // kv_chunk) * kv_chunk, k.shape[1])
        outs.append(flash_attention(
            q[:, rows], k[:, :hi], v[:, :hi], q_pos[:, rows], k_pos[:, :hi],
            kv_chunk=kv_chunk, prefix_len=prefix_len, softcap=softcap,
            bf16_probs=bf16_probs))
    return torch.cat(outs, dim=1)[:, :Sq]


def attn_forward(params: Attention, cfg, x, positions, *,
                 prefix_len: int = 0, return_kv: bool = False):
    """Training and prefill forward. x: (B, S, D); positions: (B, S)."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    if cfg.attn_causal_skip:
        out = flash_attention_causal_skip(
            q, k, v, positions, positions, q_chunk=cfg.q_chunk,
            kv_chunk=cfg.kv_chunk, prefix_len=prefix_len,
            softcap=cfg.attn_logit_softcap, bf16_probs=cfg.attn_bf16_scores)
    else:
        out = flash_attention(q, k, v, positions, positions,
                              kv_chunk=cfg.kv_chunk, prefix_len=prefix_len,
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
