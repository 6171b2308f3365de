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
products, one ``index_add`` for the scatter). On a model mesh
(:func:`moe_forward_sharded`) the experts are split over ``model``.

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
    if out.device.type == "meta":       # shapes only: nothing to draw
        return nn.Parameter(out)
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


def _slots(top_idx, E: int, C: int, offset=None):
    """top_idx (..., T, K) -> (keep, slot), each (..., T, K): an
    assignment's rank within its expert over the T tokens in slot-major
    order (slot k's assignments after every earlier slot's), kept below
    C, and its buffer row ``expert * C + min(rank, C - 1)``. ``offset``
    (K, E): the assignments that rank before these tokens' in each slot
    and expert (a data shard's share of a global batch); without it, the
    earlier slots' counts of these T tokens."""
    counts = torch.zeros(top_idx.shape[:-2] + (E,), dtype=torch.int64,
                         device=top_idx.device)
    ranks = []
    for k in range(top_idx.shape[-1]):
        ek = top_idx[..., k]                                  # (..., T)
        oh = F.one_hot(ek, E)                                 # (..., T, E)
        within = torch.cumsum(oh, dim=-2) - oh                # exclusive
        rank_k = torch.gather(within, -1, ek[..., None])[..., 0]
        base = counts if offset is None else offset[k]
        ranks.append(rank_k + torch.gather(base, -1, ek))
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


# -- on a model mesh ----------------------------------------------------------
# The experts are split over ``model`` (EP) where E divides; the router is
# read whole. Each data shard ranks its tokens after every earlier data
# shard's in each slot and expert (the per-expert counts all-gathered), so
# the dropped assignments are the one-device run's at any capacity. A
# position fills the capacity buffer of its own experts with its own
# tokens; the buffers are reduce-scattered over the batch axes along the
# capacity (each row has one writer, so the sum is exact), each position
# runs its experts over its capacity block, and the outputs are gathered
# back. The gate-weighted outputs of each position's experts are summed
# over ``model``.

def _local(P, mesh, pos, esplit: bool):
    from types import SimpleNamespace
    ex = {0: "model"} if esplit else {}
    p = SimpleNamespace(router=P.linear("router", pos),
                        w_in=P.local("w_in", pos, ex),
                        w_out=P.local("w_out", pos, ex))
    if "w_gate" in P:
        p.w_gate = P.local("w_gate", pos, ex)
    return p


def _aux_sharded(mesh, baxes, probs, top_idx, keep, E: int, T: int):
    """``_aux`` over the global batch: the shards' sums all-reduced over
    the batch axes."""
    from repro_torch.nn.collectives import all_reduce
    K = next(iter(top_idx.values())).shape[-1]
    packed = {}
    for pos in probs:
        ce = F.one_hot(top_idx[pos][..., 0].reshape(-1), E).to(
            torch.float32).sum(dim=0)
        packed[pos] = torch.cat([
            probs[pos].reshape(-1, E).sum(dim=0), ce,
            keep[pos].to(torch.float32).sum()[None]])
    packed = all_reduce(packed, mesh, baxes)
    out = {}
    for pos, t in packed.items():
        me, ce = t[:E] / T, t[E:2 * E] / T
        out[pos] = torch.stack([E * torch.sum(me * ce),
                                1.0 - t[2 * E] / (T * K)])
    return out


def moe_forward_sharded(P, cfg, mesh, baxes, hs):
    """:func:`moe_forward` at every position of ``mesh``. ``hs`` maps a
    position to its batch rows (B_loc, S, D), ``baxes`` names the mesh
    axes the batch is split over. Returns ({pos: y}, {pos: aux (2,)
    float32: load_balance, dropped_frac})."""
    from repro_torch.nn.collectives import (REDUCE_DTYPE, _axes_size,
                                            all_gather, all_reduce,
                                            block_index, reduce_scatter)
    from repro_torch.nn.sharding import mesh_sizes
    adt = DTYPES[cfg.activation_dtype]
    E, K = cfg.n_experts, cfg.top_k
    esplit = P.split("w_in", 0)
    m = mesh.axis_size("model") if esplit else 1
    El = E // m
    nb = _axes_size(mesh_sizes(mesh), baxes)
    B, S, D = next(iter(hs.values())).shape
    T = B * nb * S                                     # the global tokens
    grouped = cfg.moe_dispatch == "grouped" and S > 1
    gathered = (cfg.moe_dispatch == "gathered_decode"
                and T <= max(E // K, 4))
    C = _capacity(cfg, S if grouped else T)
    rdt = REDUCE_DTYPE if esplit else adt   # the combine's partial sums
    ps, probs, gates, tops = {}, {}, {}, {}
    for pos in mesh.positions():
        ps[pos] = _local(P, mesh, pos, esplit)
        x = hs[pos] if grouped else hs[pos].reshape(B * S, D)
        probs[pos], gates[pos], tops[pos] = _route(ps[pos], cfg, x)

    keeps, slots = {}, {}
    if gathered:
        keeps = {p: torch.ones_like(t, dtype=torch.bool)
                 for p, t in tops.items()}
    elif grouped:
        for pos in tops:
            keeps[pos], slots[pos] = _slots(tops[pos], E, C)
    else:
        counts = {pos: torch.stack([F.one_hot(t[:, k], E).sum(dim=0)
                                    for k in range(K)])
                  for pos, t in tops.items()}           # (K, E)
        counts = all_gather(counts, mesh, baxes, 0, stack=True)
        for pos, c in counts.items():                  # (nb, K, E)
            b = block_index(mesh, pos, baxes)
            tot = c.sum(dim=0)
            offset = (torch.cumsum(tot, dim=0) - tot) + c[:b].sum(dim=0)
            keeps[pos], slots[pos] = _slots(tops[pos], E, C, offset)

    ys = {}
    if gathered:
        for pos in mesh.positions():
            e0 = mesh.index(pos, "model") * El if esplit else 0
            top = tops[pos]
            mine = (top >= e0) & (top < e0 + El)
            idx = torch.clamp(top - e0, 0, El - 1)
            p, xa = ps[pos], hs[pos].reshape(B * S, D).to(adt)
            h = torch.einsum("td,tkdf->tkf", xa, p.w_in.to(adt)[idx])
            if cfg.mlp_gated:
                g = torch.einsum("td,tkdf->tkf", xa, p.w_gate.to(adt)[idx])
                h = F.silu(g.to(torch.float32)).to(adt) * h
            else:
                h = F.gelu(h.to(torch.float32), approximate="tanh").to(adt)
            y = torch.einsum("tkf,tkfd->tkd", h, p.w_out.to(adt)[idx])
            w = (gates[pos] * mine.to(gates[pos].dtype)).to(adt)
            ys[pos] = torch.einsum("tkd,tk->td", y.to(rdt), w.to(rdt)
                                   ).reshape(B, S, D)
    else:
        rows, bufs = {}, {}
        for pos in mesh.positions():
            e0 = mesh.index(pos, "model") * El if esplit else 0
            top, keep, slot = tops[pos], keeps[pos], slots[pos]
            mine = (top >= e0) & (top < e0 + El)
            row = torch.where(mine, slot - e0 * C, 0)
            x = hs[pos].to(adt)
            if grouped:              # (B, S, K): a row's own buffers
                row = (row.reshape(B, S * K) + torch.arange(
                    B, device=x.device)[:, None] * (El * C)).reshape(-1)
                src = torch.repeat_interleave(x, K, dim=1).reshape(
                    B * S * K, D)
                nrows = B * El * C
            else:
                row = row.reshape(-1)
                src = torch.repeat_interleave(x.reshape(B * S, D), K, dim=0)
                nrows = El * C
            src = src * (keep & mine).reshape(-1, 1).to(adt)
            rows[pos] = row
            bufs[pos] = torch.zeros((nrows, D), dtype=adt,
                                    device=x.device).index_add(0, row, src)
        if grouped:
            y_bufs = {}
            for pos, buf in bufs.items():
                b3 = buf.reshape(B, El, C, D).transpose(0, 1).reshape(
                    El, B * C, D)
                y = _expert_ffn(ps[pos], cfg, b3, adt).reshape(El, B, C, D)
                y_bufs[pos] = y.transpose(0, 1).reshape(B * El * C, D)
        else:
            bufs = {p: b.reshape(El, C, D) for p, b in bufs.items()}
            cap = nb > 1 and C % nb == 0
            bufs = (reduce_scatter(bufs, mesh, baxes, 1) if cap
                    else all_reduce(bufs, mesh, baxes))
            y_bufs = {p: _expert_ffn(ps[p], cfg, b, adt)
                      for p, b in bufs.items()}
            if cap:
                y_bufs = all_gather(y_bufs, mesh, baxes, 1)
            y_bufs = {p: y.reshape(El * C, D) for p, y in y_bufs.items()}
        for pos in mesh.positions():
            e0 = mesh.index(pos, "model") * El if esplit else 0
            top = tops[pos]
            mine = (top >= e0) & (top < e0 + El)
            w = (gates[pos] * (keeps[pos] & mine).to(
                gates[pos].dtype)).to(adt)
            got = y_bufs[pos][rows[pos]].reshape(top.shape + (D,))
            ys[pos] = torch.einsum("...kd,...k->...d", got.to(rdt),
                                   w.to(rdt)).reshape(B, S, D)
    if esplit:
        ys = {p: y.to(adt) for p, y in all_reduce(ys, mesh, "model").items()}
    return ys, _aux_sharded(mesh, baxes, probs, tops, keeps, E, T)
