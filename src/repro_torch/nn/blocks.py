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


def mlp_forward(params: MLP, cfg, x):
    adt = DTYPES[cfg.activation_dtype]
    h = linear_apply(params.w_in, x, "bsd,df->bsf", compute_dtype=adt)
    if cfg.mlp_gated:
        g = linear_apply(params.w_gate, x, "bsd,df->bsf", compute_dtype=adt)
        h = F.silu(g.to(torch.float32)).to(adt) * h
    else:           # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(adt)
    return linear_apply(params.w_out, h, "bsf,fd->bsd", compute_dtype=adt)


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
