"""The decoder-only LM, serving half: init, prefill and single-step decode.

The reference scans one block unit over ``cfg.repeats`` stacked copies of
its parameters (``lax.scan``); the port holds one module per repeat in an
``nn.ModuleList``. The parameters are an :class:`LM` module whose
``state_dict`` keys follow the reference's trees with the stacked leading
axis split into layers (``blocks.<r>.u<i>.attn.wq.w``), so
:func:`repro_torch.convert.lm_params_from_jax` carries the reference's
weights across. Caches are a list, one dict a repeat, of
:class:`~repro_torch.nn.attention.KVCache` per unit member.

Entry points (as in ``repro/nn/lm.py``):
  init(gen, cfg, device)                      -> params (an LM module)
  prefill(params, cfg, tokens, max_len)       -> (last_logits, caches)
  decode_step(params, cfg, token, caches)     -> (logits, caches)
  init_caches(cfg, batch, max_len)            -> caches
  mask_pad_logits(cfg, logits)                -> logits
Training (``forward``, ``loss``) and the MoE and Mamba units wait for their
port (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import attention, blocks
from repro_torch.nn.layers import (DTYPES, Embedding, RMSNorm,
                                   embedding_logits, embedding_lookup,
                                   rmsnorm_apply)

Caches = List[Dict[str, attention.KVCache]]


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // 256) * 256


class LM(nn.Module):
    """``embed`` (padded vocab, d), ``final_norm``, ``unembed`` unless the
    embeddings are tied, and ``blocks``: one ``ModuleDict`` of unit members
    ``u0``, ``u1``, ... a repeat."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig,
                 device="cuda"):
        super().__init__()
        dt = DTYPES[cfg.param_dtype]
        pv = padded_vocab(cfg)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({f"u{u}": blocks.block_init(gen, cfg, spec, device)
                           for u, spec in enumerate(cfg.unit)})
            for _ in range(cfg.repeats))
        self.embed = Embedding(gen, pv, cfg.d_model, dt, device)
        if not cfg.tie_embeddings:
            self.unembed = Embedding(gen, pv, cfg.d_model, dt, device)
        self.final_norm = RMSNorm(cfg.d_model, dt, device)


def init(gen, cfg: ModelConfig, device="cuda") -> LM:
    """Random parameters from ``gen``: a ``torch.Generator`` on ``device``,
    or an int seed for one."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    with torch.no_grad():
        return LM(gen, cfg, device).eval()


def _embed_inputs(params: LM, cfg: ModelConfig, tokens, prefix_embeds, adt):
    x = embedding_lookup(params.embed, tokens, adt)
    if cfg.prefix_len and prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(adt), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    return x, positions


def _tokens(params: LM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.table.device).to(
        torch.int64)


def _logits(params: LM, cfg: ModelConfig, x, adt):
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    table = params.embed if cfg.tie_embeddings else params.unembed
    return embedding_logits(table, x, adt)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda") -> Caches:
    """Empty caches, one dict of unit members a repeat."""
    for spec in cfg.unit:
        blocks._check_spec(spec)
    return [{f"u{u}": attention.init_cache(cfg, batch, max_len, dtype, device)
             for u in range(len(cfg.unit))} for _ in range(cfg.repeats)]


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, tokens, max_len: int,
            prefix_embeds=None, cache_dtype=torch.bfloat16):
    """Run the full prompt (B, S), build decode caches of capacity
    ``max_len``. Returns (last_logits (B, padded vocab), caches)."""
    adt = DTYPES[cfg.activation_dtype]
    x, positions = _embed_inputs(params, cfg, _tokens(params, tokens),
                                 prefix_embeds, adt)
    pfx = cfg.prefix_len if prefix_embeds is not None else 0
    B, S, _ = x.shape
    if max_len < S:
        raise ValueError(f"cache max_len={max_len} < prompt length {S} "
                         f"(remember to include prefix_len={pfx})")
    caches = init_caches(cfg, B, max_len, cache_dtype, x.device)
    for unit_p, unit_c in zip(params.blocks, caches):
        for u, spec in enumerate(cfg.unit):
            x, (k, v) = blocks.block_prefill(unit_p[f"u{u}"], cfg, spec, x,
                                             positions, prefix_len=pfx)
            c = unit_c[f"u{u}"]
            c.k[:, :S] = k.to(cache_dtype)
            c.v[:, :S] = v.to(cache_dtype)
            unit_c[f"u{u}"] = c._replace(length=S)
    return _logits(params, cfg, x[:, -1:], adt)[:, 0], caches


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, token, caches: Caches):
    """token: (B, 1) integers. Returns (logits (B, padded vocab), caches);
    the caches' tensors are updated in place."""
    adt = DTYPES[cfg.activation_dtype]
    x = embedding_lookup(params.embed, _tokens(params, token), adt)
    new_caches = []
    for unit_p, unit_c in zip(params.blocks, caches):
        new_c = {}
        for u, spec in enumerate(cfg.unit):
            x, new_c[f"u{u}"] = blocks.block_decode(
                unit_p[f"u{u}"], cfg, spec, x, unit_c[f"u{u}"])
        new_caches.append(new_c)
    return _logits(params, cfg, x, adt)[:, 0], new_caches


def mask_pad_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """-1e30 on the padded vocab tail before sampling."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(ids[None, :] >= cfg.vocab, -1e30)
