"""Mixture-of-Experts feed-forward with capacity-based token dropping, as
in the JAX package's ``repro/nn/moe.py`` (GShard-style semantics, a
gather/scatter dispatch with no (T, E, C) one-hot tensor):

1. top-k routing over the float32 router's softmax (or sigmoid);
2. each assignment's rank within its expert, slot by slot: an exclusive
   cumsum of (T, E) one-hots in slot-major order;
3. a scatter-add of the kept tokens into an (E·C, D) buffer; an
   assignment past capacity C is zeroed and clamped to slot C-1;
4. per-expert batched products (E, C, D) x (E, D, F);
5. the gather back and the gate-weighted combine.

The reference computes all of it in plain JAX outside any Pallas kernel;
so does the port, in plain PyTorch (``torch.bmm`` for the expert
products, one ``index_add`` for the scatter). Its ``constrain(...)``
calls are sharding hints for a model mesh and have no counterpart here.

Three dispatches, chosen by :func:`moe_forward` as the reference does:
``gathered_decode`` (the routed experts' weights gathered per token, for
T <= max(E // K, 4)), ``grouped`` (per batch row ranks and capacity, for
S > 1) and the global one.

Integer results are exact. Ties among router probabilities go to the
lower expert index, as ``jax.lax.top_k`` sends them: the top K come from
a stable descending sort, which ``torch.topk`` does not promise. The
scatter adds each kept token once to a zero row, and dropped assignments
add exact zeros, so the buffer does not depend on the order of the adds
and a recompute under ``torch.utils.checkpoint`` routes and fills it as
the first pass did.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.nn.layers import DTYPES, Linear, truncated_normal


def _experts(gen: torch.Generator, shape, dtype, device) -> nn.Parameter:
    """(E, fan_in, fan_out) truncated normal over sqrt(fan_in), drawn one
    expert at a time: the whole stack at once would hold two float32
    copies of it (the draw and its scaling), 8.4 GB for a dbrx layer's
    ``w_in``."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        out[e] = truncated_normal(gen, shape[1:], 1.0 / np.sqrt(shape[1]),
                                  device).to(dtype)
    return nn.Parameter(out)


class MoE(nn.Module):
    """``router`` (d, E) float32, ``w_in``/``w_gate`` (E, d, F) and
    ``w_out`` (E, F, d) in the parameter dtype (``w_gate`` when
    ``cfg.mlp_gated``)."""

    def __init__(self, gen: torch.Generator, cfg, device="cuda"):
        super().__init__()
        dt = DTYPES[cfg.param_dtype]
        D, Fh, E = cfg.d_model, cfg.resolved_expert_d_ff, cfg.n_experts
        self.router = Linear(gen, (D,), (E,), dtype=torch.float32,
                             device=device)
        self.w_in = _experts(gen, (E, D, Fh), dt, device)
        if cfg.mlp_gated:
            self.w_gate = _experts(gen, (E, D, Fh), dt, device)
        self.w_out = _experts(gen, (E, Fh, D), dt, device)


def moe_init(gen: torch.Generator, cfg, device="cuda") -> MoE:
    return MoE(gen, cfg, device)


def _capacity(cfg, T: int) -> int:
    """Slots an expert takes, from Python floats as the reference
    computes them (a float32 ceil may land one slot off): above 8,
    rounded up to a multiple of 128."""
    c = math.ceil(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 128) * 128) if c > 8 else 8


def moe_forward(params: MoE, cfg, x):
    """x: (B, S, D) -> ((B, S, D), aux {"load_balance", "dropped_frac"})."""
    if cfg.moe_dispatch == "gathered_decode" and \
            x.shape[0] * x.shape[1] <= max(cfg.n_experts // cfg.top_k, 4):
        return _moe_forward_gathered(params, cfg, x)
    if cfg.moe_dispatch == "grouped" and x.shape[1] > 1:
        return moe_forward_grouped(params, cfg, x)
    return _moe_forward_global(params, cfg, x)


def _route(params: MoE, cfg, x):
    """(..., D) -> (probs (..., E), renormalised gates (..., K), expert
    indices (..., K) int64), all in float32 and ties to the lower index."""
    logits = torch.einsum("...d,de->...e", x.to(torch.float32),
                          params.router.w.to(torch.float32))
    probs = (torch.softmax(logits, dim=-1) if cfg.router_softmax
             else torch.sigmoid(logits))
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, top_idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, top_idx


def _slots(top_idx, E: int, C: int):
    """top_idx (..., T, K) -> (keep, slot), each (..., T, K): an
    assignment's rank within its expert over the T tokens in slot-major
    order (slot k's assignments after every earlier slot's), kept below
    C, and its buffer row ``expert * C + min(rank, C - 1)``."""
    counts = torch.zeros(top_idx.shape[:-2] + (E,), dtype=torch.int64,
                         device=top_idx.device)
    ranks = []
    for k in range(top_idx.shape[-1]):
        ek = top_idx[..., k]                                  # (..., T)
        oh = F.one_hot(ek, E)                                 # (..., T, E)
        within = torch.cumsum(oh, dim=-2) - oh                # exclusive
        rank_k = torch.gather(within, -1, ek[..., None])[..., 0]
        ranks.append(rank_k + torch.gather(counts, -1, ek))
        counts = counts + oh.sum(dim=-2)
    rank = torch.stack(ranks, dim=-1)
    return rank < C, top_idx * C + torch.clamp_max(rank, C - 1)


def _expert_ffn(params: MoE, cfg, buf, adt):
    """buf (E, R, D) -> (E, R, D): each expert's MLP over its R rows."""
    h = torch.bmm(buf, params.w_in.to(adt))
    if cfg.mlp_gated:
        g = torch.bmm(buf, params.w_gate.to(adt))
        h = F.silu(g.to(torch.float32)).to(adt) * h
    else:           # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(adt)
    return torch.bmm(h, params.w_out.to(adt))


def _aux(probs, top_idx, keep, E: int):
    """Switch-style load balance over every token, and the dropped share
    of the assignments (0-d float32)."""
    flat = probs.reshape(-1, E)
    me = flat.mean(dim=0)
    ce = F.one_hot(top_idx[..., 0].reshape(-1), E).to(torch.float32).mean(
        dim=0)
    return {"load_balance": E * torch.sum(me * ce),
            "dropped_frac": 1.0 - keep.to(torch.float32).mean()}


def _moe_forward_gathered(params: MoE, cfg, x):
    """Tiny T: each token's K routed experts' weights gathered, exactly
    T·K expert slots computed; never drops."""
    adt = DTYPES[cfg.activation_dtype]
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    probs, gates, top_idx = _route(params, cfg, xt)
    xa = xt.to(adt)
    h = torch.einsum("td,tkdf->tkf", xa, params.w_in.to(adt)[top_idx])
    if cfg.mlp_gated:
        g = torch.einsum("td,tkdf->tkf", xa, params.w_gate.to(adt)[top_idx])
        h = F.silu(g.to(torch.float32)).to(adt) * h
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(adt)
    y = torch.einsum("tkf,tkfd->tkd", h, params.w_out.to(adt)[top_idx])
    out = torch.einsum("tkd,tk->td", y, gates.to(adt)).reshape(B, S, D)
    aux = _aux(probs, top_idx, torch.ones_like(top_idx, dtype=torch.bool),
               cfg.n_experts)
    return out, aux


def _moe_forward_global(params: MoE, cfg, x):
    """One pool of T = B·S tokens, ranked together, capacity C(T)."""
    adt = DTYPES[cfg.activation_dtype]
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = _capacity(cfg, T)
    xt = x.reshape(T, D)
    probs, gates, top_idx = _route(params, cfg, xt)          # (T, K)
    keep, slot = _slots(top_idx, E, C)
    flat_slot = slot.reshape(T * K)
    src = (torch.repeat_interleave(xt.to(adt), K, dim=0)
           * keep.reshape(T * K, 1).to(adt))
    # index_add, not index_copy: a dropped assignment's zero may share
    # slot C-1 with a kept token, whose row the zero must leave as it is
    buf = torch.zeros((E * C, D), dtype=adt, device=x.device).index_add(
        0, flat_slot, src)
    y_buf = _expert_ffn(params, cfg, buf.reshape(E, C, D), adt).reshape(
        E * C, D)
    gathered = y_buf[flat_slot].reshape(T, K, D)
    w = (gates * keep.to(gates.dtype)).to(adt)
    out = torch.einsum("tkd,tk->td", gathered, w).reshape(B, S, D)
    return out, _aux(probs, top_idx, keep, E)


def moe_forward_grouped(params: MoE, cfg, x):
    """Grouped dispatch (GShard's ``group_size``): each batch row ranks
    and buffers its own S tokens at capacity C(S) per (row, expert). The
    rows' buffers are one (B·E·C, D) tensor filled by one ``index_add``
    over row-offset slots."""
    adt = DTYPES[cfg.activation_dtype]
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, S)
    probs, gates, top_idx = _route(params, cfg, x)           # (B, S, K)
    keep, slot = _slots(top_idx, E, C)
    rows = (slot.reshape(B, S * K)
            + torch.arange(B, device=x.device)[:, None] * (E * C)).reshape(-1)
    src = (torch.repeat_interleave(x.to(adt), K, dim=1).reshape(B, S, K, D)
           * keep[..., None].to(adt)).reshape(B * S * K, D)
    buf = torch.zeros((B * E * C, D), dtype=adt, device=x.device).index_add(
        0, rows, src)
    # (B, E, C, D) -> (E, B·C, D): one batched product an expert
    buf = buf.reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    y_buf = _expert_ffn(params, cfg, buf, adt).reshape(E, B, C, D)
    y_buf = y_buf.transpose(0, 1).reshape(B * E * C, D)
    gathered = y_buf[rows].reshape(B, S, K, D)
    w = (gates * keep.to(gates.dtype)).to(adt)
    out = torch.einsum("bskd,bsk->bsd", gathered, w)
    return out, _aux(probs, top_idx, keep, E)
