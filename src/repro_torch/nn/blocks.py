"""Pre-norm residual blocks, for training, prefill and decode, as in the
JAX package's ``repro/nn/blocks.py``: an attention or Mamba-2 mixer
(:mod:`repro_torch.nn.mamba2`), then a dense (SwiGLU or GELU) MLP, an MoE
(:mod:`repro_torch.nn.moe`) or no feed-forward, as the unit's
:class:`~repro_torch.configs.base.LayerSpec` says.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import LayerSpec
from repro_torch.nn import attention as attn
from repro_torch.nn import mamba2, moe
from repro_torch.nn.layers import (DTYPES, Linear, RMSNorm, linear_apply,
                                   rmsnorm_apply)


class MLP(nn.Module):
    """``w_in``/``w_gate`` (d, d_ff) and ``w_out`` (d_ff, d)."""

    def __init__(self, gen: torch.Generator, cfg, device="cuda"):
        super().__init__()
        kw = dict(dtype=DTYPES[cfg.param_dtype], device=device)
        self.w_in = Linear(gen, (cfg.d_model,), (cfg.d_ff,), **kw)
        self.w_out = Linear(gen, (cfg.d_ff,), (cfg.d_model,), **kw)
        if cfg.mlp_gated:
            self.w_gate = Linear(gen, (cfg.d_model,), (cfg.d_ff,), **kw)


def mlp_init(gen: torch.Generator, cfg, device="cuda") -> MLP:
    return MLP(gen, cfg, device)


def mlp_forward(params: MLP, cfg, x, out_dtype=None):
    """``out_dtype``: the output product's dtype (default the activation
    dtype), float32 for a row-parallel shard's partial sum."""
    adt = DTYPES[cfg.activation_dtype]
    h = linear_apply(params.w_in, x, "bsd,df->bsf", compute_dtype=adt)
    if cfg.mlp_gated:
        g = linear_apply(params.w_gate, x, "bsd,df->bsf", compute_dtype=adt)
        h = F.silu(g.to(torch.float32)).to(adt) * h
    else:           # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(adt)
    return linear_apply(params.w_out, h, "bsf,fd->bsd",
                        compute_dtype=out_dtype or adt)


class Block(nn.Module):
    """``norm_mix`` + ``attn`` (or ``mamba`` for a Mamba unit), then
    ``norm_ffn`` + ``ffn`` (an :class:`~repro_torch.nn.moe.MoE` or an
    :class:`MLP`) unless the unit's ffn is ``"none"``."""

    def __init__(self, gen: torch.Generator, cfg, spec: LayerSpec,
                 device="cuda"):
        super().__init__()
        dt = DTYPES[cfg.param_dtype]
        self.norm_mix = RMSNorm(cfg.d_model, dt, device)
        if spec.kind == "attn":
            self.attn = attn.attn_init(gen, cfg, device)
        else:
            self.mamba = mamba2.mamba_init(gen, cfg, device)
        if spec.ffn != "none":
            self.norm_ffn = RMSNorm(cfg.d_model, dt, device)
            self.ffn = (moe.moe_init(gen, cfg, device) if spec.ffn == "moe"
                        else mlp_init(gen, cfg, device))


def block_init(gen: torch.Generator, cfg, spec: LayerSpec,
               device="cuda") -> Block:
    return Block(gen, cfg, spec, device)


def _ffn(params: Block, cfg, spec: LayerSpec, x):
    """The feed-forward half: (x, aux), aux the MoE's dict or empty."""
    if spec.ffn == "none":
        return x, {}
    h = rmsnorm_apply(params.norm_ffn, x, cfg.norm_eps)
    if spec.ffn == "moe":
        y, aux = moe.moe_forward(params.ffn, cfg, h)
        return x + y, aux
    return x + mlp_forward(params.ffn, cfg, h), {}


def block_forward(params: Block, cfg, spec: LayerSpec, x, positions, *,
                  prefix_len: int = 0):
    """One layer of the training forward. Returns (x, aux): the MoE's
    ``{"load_balance", "dropped_frac"}``, empty for a dense unit."""
    h = rmsnorm_apply(params.norm_mix, x, cfg.norm_eps)
    if spec.kind == "attn":
        mixed = attn.attn_forward(params.attn, cfg, h, positions,
                                  prefix_len=prefix_len)
    else:
        mixed = mamba2.mamba_forward(params.mamba, cfg, h)
    return _ffn(params, cfg, spec, x + mixed)


def block_prefill(params: Block, cfg, spec: LayerSpec, x, positions, *,
                  prefix_len: int = 0):
    """One layer over the prompt. Returns (x, cache): (k, v) for an
    attention mixer, a :class:`~repro_torch.nn.mamba2.MambaCache` for a
    Mamba one."""
    h = rmsnorm_apply(params.norm_mix, x, cfg.norm_eps)
    if spec.kind == "attn":
        mixed, cache = attn.attn_forward(params.attn, cfg, h, positions,
                                         prefix_len=prefix_len,
                                         return_kv=True)
    else:
        mixed, cache = mamba2.mamba_forward(params.mamba, cfg, h,
                                            return_cache=True)
    return _ffn(params, cfg, spec, x + mixed)[0], cache


def block_decode(params: Block, cfg, spec: LayerSpec, x, cache):
    """Single-step decode. Returns (x, new_cache)."""
    h = rmsnorm_apply(params.norm_mix, x, cfg.norm_eps)
    if spec.kind == "attn":
        mixed, cache = attn.attn_decode(params.attn, cfg, h, cache)
    else:
        mixed, cache = mamba2.mamba_decode(params.mamba, cfg, h, cache)
    return _ffn(params, cfg, spec, x + mixed)[0], cache


# -- on a model mesh ----------------------------------------------------------

def mlp_forward_sharded(P, cfg, mesh, hs):
    """:func:`mlp_forward` at every position: ``w_in``/``w_gate``
    column-parallel and ``w_out`` row-parallel over ``model`` (where
    ``d_ff`` divides), the float32 partial outputs all-reduced."""
    from types import SimpleNamespace

    from repro_torch.nn.collectives import REDUCE_DTYPE, all_reduce
    split = P.split("w_in.w", 1)
    cols = {1: "model"} if split else {}
    out = {}
    for pos in mesh.positions():
        p = SimpleNamespace(
            w_in=P.linear("w_in", pos, cols),
            w_out=P.linear("w_out", pos, {0: "model"} if split else {}))
        if cfg.mlp_gated:
            p.w_gate = P.linear("w_gate", pos, cols)
        out[pos] = mlp_forward(p, cfg, hs[pos],
                               REDUCE_DTYPE if split else None)
    if not split:
        return out
    adt = DTYPES[cfg.activation_dtype]
    return {p: y.to(adt) for p, y in all_reduce(out, mesh, "model").items()}


def _norm_all(P, name, cfg, mesh, xs):
    return {pos: rmsnorm_apply(P.norm(name, pos), x, cfg.norm_eps)
            for pos, x in xs.items()}


def _ffn_sharded(P, cfg, spec: LayerSpec, mesh, xs, baxes):
    if spec.ffn == "none":
        return xs, None
    hs = _norm_all(P, "norm_ffn", cfg, mesh, xs)
    if spec.ffn == "moe":
        ys, aux = moe.moe_forward_sharded(P.sub("ffn."), cfg, mesh, baxes, hs)
    else:
        ys, aux = mlp_forward_sharded(P.sub("ffn."), cfg, mesh, hs), None
    return {pos: xs[pos] + ys[pos] for pos in xs}, aux


def block_forward_sharded(P, cfg, spec: LayerSpec, mesh, xs, positions,
                          baxes, *, prefix_len: int = 0):
    """:func:`block_forward` at every position of ``mesh`` (``P`` the
    block's leaves, ``xs`` a position's rows, ``baxes`` the mesh axes the
    batch is split over). Returns ({pos: x}, aux {pos: (2,) float32} of
    the MoE, or None)."""
    hs = _norm_all(P, "norm_mix", cfg, mesh, xs)
    if spec.kind == "attn":
        mixed = attn.attn_forward_sharded(P.sub("attn."), cfg, mesh, hs,
                                          positions, prefix_len=prefix_len)
    else:
        mixed = mamba2.mamba_forward_sharded(P.sub("mamba."), cfg, mesh, hs)
    return _ffn_sharded(P, cfg, spec, mesh,
                        {pos: xs[pos] + mixed[pos] for pos in xs}, baxes)


def block_prefill_sharded(P, cfg, spec: LayerSpec, mesh, xs, positions,
                          baxes, cache, *, prefix_len: int = 0):
    """One layer over the prompt on a mesh, writing the sharded ``cache``
    in place. Returns {pos: x}."""
    hs = _norm_all(P, "norm_mix", cfg, mesh, xs)
    S = next(iter(hs.values())).shape[1]
    if spec.kind == "attn":
        mixed, kvs = attn.attn_forward_sharded(
            P.sub("attn."), cfg, mesh, hs, positions, prefix_len=prefix_len,
            return_kv=True)
        attn.write_prompt(cache, kvs, S)
    else:
        mixed = mamba2.mamba_forward_sharded(P.sub("mamba."), cfg, mesh, hs,
                                             cache=cache)
    return _ffn_sharded(P, cfg, spec, mesh,
                        {pos: xs[pos] + mixed[pos] for pos in xs}, baxes)[0]


def block_decode_sharded(P, cfg, spec: LayerSpec, mesh, xs, baxes, cache):
    """Single-step decode on a mesh. Returns ({pos: x}, new_cache)."""
    hs = _norm_all(P, "norm_mix", cfg, mesh, xs)
    if spec.kind == "attn":
        mixed, cache = attn.attn_decode_sharded(P.sub("attn."), cfg, mesh,
                                                hs, cache)
    else:
        mixed, cache = mamba2.mamba_decode_sharded(P.sub("mamba."), cfg,
                                                   mesh, hs, cache)
    return _ffn_sharded(P, cfg, spec, mesh,
                        {pos: xs[pos] + mixed[pos] for pos in xs},
                        baxes)[0], cache
