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
    out = _attend_prompt(cfg, q, k, v, positions, prefix_len)
    y = linear_apply(params.wo, out, "bshq,hqd->bsd", compute_dtype=out.dtype)
    return (y, (k, v)) if return_kv else y


def _attend_prompt(cfg, q, k, v, positions, prefix_len: int):
    """The flash attention of a training or prefill forward."""
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
    return out


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


# -- on a model mesh ----------------------------------------------------------
# Heads and kv heads are split over ``model`` where the specs split them
# (``wq``/``wo`` on heads, ``wk``/``wv`` on kv heads); ``wo`` is
# row-parallel and its partial outputs are all-reduced. With fewer kv heads
# than the model axis (MQA), ``wk``/``wv`` are gathered and each position
# takes the kv heads its query heads read.

def _local(P, cfg, pos, hsplit: bool, kvsplit: bool):
    from types import SimpleNamespace
    qs = {1: "model"} if hsplit else {}
    ks = {1: "model"} if kvsplit else {}
    p = SimpleNamespace(
        wq=P.linear("wq", pos, qs), wk=P.linear("wk", pos, ks),
        wv=P.linear("wv", pos, ks),
        wo=P.linear("wo", pos, {0: "model"} if hsplit else {}, n_in=2))
    if cfg.qk_norm:
        p.q_norm, p.k_norm = P.norm("q_norm", pos), P.norm("k_norm", pos)
    return p


def _splits(P):
    return P.split("wq.w", 1), P.split("wk.w", 1)


def _heads_of(cfg, mesh, pos, k, v):
    """k/v of every kv head -> the kv heads this position's query heads
    read, in the grouping ``flash_attention`` expects."""
    H, KV = cfg.n_heads, k.shape[2]
    m = mesh.axis_size("model")
    h0 = mesh.index(pos, "model") * (H // m)
    idx = [h // (H // KV) for h in range(h0, h0 + H // m)]
    if len(set(idx)) == 1:
        sel = idx[:1]
    else:                       # a kv head a query head
        sel = idx
    sel = torch.tensor(sel, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def attn_forward_sharded(P, cfg, mesh, hs, positions, *, prefix_len: int = 0,
                         return_kv: bool = False):
    """:func:`attn_forward` at every position of ``mesh``: ``hs`` and
    ``positions`` map a position to its rows. Returns ``{pos: y}`` (and
    ``{pos: (k, v)}``: the position's kv heads, or every kv head where
    the kv heads are not split)."""
    from repro_torch.nn.collectives import REDUCE_DTYPE, all_reduce
    hsplit, kvsplit = _splits(P)
    ys, kvs = {}, {}
    for pos in mesh.positions():
        p = _local(P, cfg, pos, hsplit, kvsplit)
        q, k, v = _project_qkv(p, cfg, hs[pos], positions[pos])
        ka, va = ((k, v) if kvsplit or not hsplit
                  else _heads_of(cfg, mesh, pos, k, v))
        out = _attend_prompt(cfg, q, ka, va, positions[pos], prefix_len)
        ys[pos] = linear_apply(p.wo, out, "bshq,hqd->bsd",
                               compute_dtype=REDUCE_DTYPE if hsplit
                               else out.dtype)
        kvs[pos] = (k, v)
    if hsplit:
        ys = {p: y.to(q.dtype)
              for p, y in all_reduce(ys, mesh, "model").items()}
    return (ys, kvs) if return_kv else ys


def seq_sharded(cache: KVCache) -> bool:
    """Whether a sharded cache splits the sequence (kv_cache_axes'
    fallback) rather than the kv heads."""
    return bool(cache.k.spec.axes(1))


def write_prompt(cache: KVCache, kvs, S: int) -> None:
    """Write each position's prefill k/v into its shard of a sharded
    cache (the sequence block it owns, on a sequence-sharded cache)."""
    for pos, (k, v) in kvs.items():
        c = cache.k.coord(pos)
        kt, vt = cache.k.shards[c], cache.v.shards[c]
        if seq_sharded(cache):
            lo, hi = cache.k.box(c)[1]
            n = max(0, min(hi, S) - lo)
            kt[:, :n] = k[:, lo:lo + n].to(kt.dtype)
            vt[:, :n] = v[:, lo:lo + n].to(vt.dtype)
        else:
            kt[:, :S] = k.to(kt.dtype)
            vt[:, :S] = v.to(vt.dtype)


def attend_partial(q, k, v, *, softcap: float = 0.0):
    """One sequence shard's part of :func:`attend`: (max, sum, the
    unnormalised value product) over its keys, float32, packed as
    (B, Sq, KV, rep, D + 2). No keys: max -1e30, sum and product 0."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D).to(torch.float32)
    if k.shape[1] == 0:
        out = torch.zeros((B, Sq, KV, H // KV, D + 2), dtype=torch.float32,
                          device=q.device)
        out[..., 0] = NEG_INF
        return out
    s = torch.einsum("bsgrd,bcgd->bsgrc", qg, k.to(torch.float32))
    s = s * (1.0 / np.sqrt(D))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bsgrc,bcgd->bsgrd", p, v.to(torch.float32))
    return torch.cat([m[..., None], p.sum(dim=-1)[..., None], acc], dim=-1)


def combine_partials(parts, dtype):
    """(n shards, B, Sq, KV, rep, D + 2) -> the attention (B, Sq, H, D),
    the shards folded in order (flash-decode)."""
    m = parts[..., 0]
    M = m.amax(dim=0)
    w = torch.exp(m - M)
    l = (parts[..., 1] * w).sum(dim=0)
    acc = (parts[..., 2:] * w[..., None]).sum(dim=0)
    out = acc / l.clamp_min(1e-30)[..., None]
    B, Sq, KV, rep, D = out.shape
    return out.reshape(B, Sq, KV * rep, D).to(dtype)


def attn_decode_sharded(P, cfg, mesh, hs, cache: KVCache):
    """:func:`attn_decode` on a mesh with a sharded cache (``cache.k`` and
    ``cache.v`` :class:`~repro_torch.nn.collectives.Sharded`): the new
    token's k/v go into the shard that holds position ``length``; a
    sequence-sharded cache's shards each attend over their own keys and
    their partial softmax is combined. Returns ({pos: y}, cache)."""
    from repro_torch.nn.collectives import (REDUCE_DTYPE, all_gather,
                                            all_reduce)
    hsplit, kvsplit = _splits(P)
    t = cache.length
    if t >= cache.k.shape[1]:
        raise ValueError(f"KV cache full: length {t} == capacity "
                         f"{cache.k.shape[1]}")
    seq = seq_sharded(cache)
    qs, params = {}, {}
    for pos in mesh.positions():
        p = params[pos] = _local(P, cfg, pos, hsplit, kvsplit)
        B = hs[pos].shape[0]
        posid = torch.full((B, 1), t, dtype=torch.int64,
                           device=hs[pos].device)
        q, k_new, v_new = _project_qkv(p, cfg, hs[pos], posid)
        c = cache.k.coord(pos)
        lo, hi = cache.k.box(c)[1]
        if lo <= t < hi:
            cache.k.shards[c][:, t - lo] = k_new[:, 0].to(cache.k.dtype)
            cache.v.shards[c][:, t - lo] = v_new[:, 0].to(cache.v.dtype)
        qs[pos] = q
    outs = {}
    if not seq:
        for pos in mesh.positions():
            c = cache.k.coord(pos)
            dev = qs[pos].device
            outs[pos] = attend(qs[pos], cache.k.shards[c][:, :t + 1].to(dev),
                               cache.v.shards[c][:, :t + 1].to(dev),
                               softcap=cfg.attn_logit_softcap)
    else:
        q_all = all_gather(qs, mesh, "model", 2) if hsplit else qs
        parts = {}
        for pos in mesh.positions():
            c = cache.k.coord(pos)
            lo, hi = cache.k.box(c)[1]
            n = max(0, min(hi, t + 1) - lo)
            dev = q_all[pos].device
            parts[pos] = attend_partial(
                q_all[pos], cache.k.shards[c][:, :n].to(dev),
                cache.v.shards[c][:, :n].to(dev),
                softcap=cfg.attn_logit_softcap)
        parts = all_gather(parts, mesh, "model", 0, stack=True)
        m = mesh.axis_size("model")
        for pos in mesh.positions():
            out = combine_partials(parts[pos], qs[pos].dtype)
            if hsplit:
                h = cfg.n_heads // m
                i = mesh.index(pos, "model")
                out = out[:, :, i * h:(i + 1) * h]
            outs[pos] = out
    ys = {pos: linear_apply(params[pos].wo, outs[pos], "bshq,hqd->bsd",
                            compute_dtype=REDUCE_DTYPE if hsplit
                            else outs[pos].dtype)
          for pos in mesh.positions()}
    if hsplit:
        dt = next(iter(qs.values())).dtype
        ys = {p: y.to(dt) for p, y in all_reduce(ys, mesh, "model").items()}
    return ys, cache._replace(length=t + 1)
