"""Pre-norm residual blocks, for training, prefill and decode: an
attention mixer and a dense (SwiGLU or GELU) MLP.

The reference's Mamba-2 mixer and MoE feed-forward (``repro/nn/mamba2.py``,
``repro/nn/moe.py``) are not ported yet: a config with such a unit raises
``NotImplementedError`` (ROADMAP Queue 1 item 11b).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import LayerSpec
from repro_torch.nn import attention as attn
from repro_torch.nn.layers import (DTYPES, Linear, RMSNorm, linear_apply,
                                   rmsnorm_apply)

_UNPORTED = ("ROADMAP Queue 1 item 11: the port runs attention + dense "
             "units only; {what} waits for its port (item 11b)")


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


def _check_spec(spec: LayerSpec) -> None:
    if spec.kind != "attn":
        raise NotImplementedError(_UNPORTED.format(what=f"a {spec.kind!r} "
                                                   f"mixer"))
    if spec.ffn == "moe":
        raise NotImplementedError(_UNPORTED.format(what="an MoE "
                                                   "feed-forward"))


class Block(nn.Module):
    """``norm_mix`` + ``attn``, then ``norm_ffn`` + ``ffn`` unless the
    unit's ffn is ``"none"``."""

    def __init__(self, gen: torch.Generator, cfg, spec: LayerSpec,
                 device="cuda"):
        super().__init__()
        _check_spec(spec)
        dt = DTYPES[cfg.param_dtype]
        self.norm_mix = RMSNorm(cfg.d_model, dt, device)
        self.attn = attn.attn_init(gen, cfg, device)
        if spec.ffn != "none":
            self.norm_ffn = RMSNorm(cfg.d_model, dt, device)
            self.ffn = mlp_init(gen, cfg, device)


def block_init(gen: torch.Generator, cfg, spec: LayerSpec,
               device="cuda") -> Block:
    return Block(gen, cfg, spec, device)


def _ffn(params: Block, cfg, spec: LayerSpec, x):
    if spec.ffn == "none":
        return x
    h = rmsnorm_apply(params.norm_ffn, x, cfg.norm_eps)
    return x + mlp_forward(params.ffn, cfg, h)


def block_forward(params: Block, cfg, spec: LayerSpec, x, positions, *,
                  prefix_len: int = 0):
    """One layer of the training forward. Returns (x, aux); ``aux`` is
    empty for a dense unit (the MoE's load-balance and drop terms come
    with its port)."""
    h = rmsnorm_apply(params.norm_mix, x, cfg.norm_eps)
    mixed = attn.attn_forward(params.attn, cfg, h, positions,
                              prefix_len=prefix_len)
    return _ffn(params, cfg, spec, x + mixed), {}


def block_prefill(params: Block, cfg, spec: LayerSpec, x, positions, *,
                  prefix_len: int = 0):
    """One layer over the prompt. Returns (x, (k, v)) for its cache."""
    h = rmsnorm_apply(params.norm_mix, x, cfg.norm_eps)
    mixed, kv = attn.attn_forward(params.attn, cfg, h, positions,
                                  prefix_len=prefix_len, return_kv=True)
    return _ffn(params, cfg, spec, x + mixed), kv


def block_decode(params: Block, cfg, spec: LayerSpec, x, cache):
    """Single-step decode. Returns (x, new_cache)."""
    h = rmsnorm_apply(params.norm_mix, x, cfg.norm_eps)
    mixed, cache = attn.attn_decode(params.attn, cfg, h, cache)
    return _ffn(params, cfg, spec, x + mixed), cache
