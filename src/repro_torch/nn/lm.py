"""The decoder-only LM: init, the training forward and loss, prefill and
single-step decode.

The reference scans one block unit over ``cfg.repeats`` stacked copies of
its parameters (``lax.scan``); the port holds one module per repeat in an
``nn.ModuleList``. The parameters are an :class:`LM` module whose
``state_dict`` keys follow the reference's trees with the stacked leading
axis split into layers (``blocks.<r>.u<i>.attn.wq.w``), so
:func:`repro_torch.convert.lm_params_from_jax` carries the reference's
weights across (:func:`stack_groups` maps the names back). Caches are a
list, one dict a repeat, of a :class:`~repro_torch.nn.attention.KVCache`
per attention member and a :class:`~repro_torch.nn.mamba2.MambaCache` per
Mamba member.

Entry points (as in ``repro/nn/lm.py``):
  init(gen, cfg, device)                      -> params (an LM module)
  forward(params, cfg, tokens, prefix)        -> (logits, aux)
  loss(params, cfg, batch)                    -> (scalar, metrics)
  prefill(params, cfg, tokens, max_len)       -> (last_logits, caches)
  decode_step(params, cfg, token, caches)     -> (logits, caches)
  init_caches(cfg, batch, max_len)            -> caches
  mask_pad_logits(cfg, logits)                -> logits
The backward is autograd's, with ``cfg.remat`` choosing what a block unit
keeps for it (:func:`_remat`). The serving entry points run under
``torch.no_grad``.
"""
from __future__ import annotations

import functools
import re
from typing import Dict, Iterable, List, Union

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.nn import attention, blocks, mamba2
from repro_torch.nn.layers import (DTYPES, Embedding, RMSNorm,
                                   embedding_logits, embedding_lookup,
                                   rmsnorm_apply)

Caches = List[Dict[str, Union[attention.KVCache, mamba2.MambaCache]]]


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
    or an int seed for one. They take gradients."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    with torch.no_grad():
        return LM(gen, cfg, device)


_STACKED = re.compile(r"blocks\.(\d+)\.(.+)")


def stack_groups(names: Iterable[str]) -> Dict[str, List[str]]:
    """The port's parameter names grouped by the reference leaf they
    form: ``blocks.<r>.<rest>`` for r = 0, 1, ... are the layers of the
    reference's ``blocks.<rest>``, stacked on its leading axis; any other
    name is a leaf of its own. Keys are the reference's dotted paths,
    each list in layer order."""
    groups: Dict[str, List[str]] = {}
    for name in names:
        m = _STACKED.fullmatch(name)
        if m is None:
            groups[name] = [name]
        else:
            groups.setdefault(f"blocks.{m[2]}", []).append(name)
    key = lambda n: int(_STACKED.fullmatch(n)[1])
    return {k: sorted(v, key=key) if k.startswith("blocks.") else v
            for k, v in groups.items()}


_DOTS = functools.partial(
    checkpoint.create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
     torch.ops.aten.addmm.default])


def _remat(fn, cfg: ModelConfig):
    """What a block unit keeps for the backward: ``"nothing"`` keeps every
    activation autograd saves; ``"full"`` keeps the unit's input and
    recomputes the unit in the backward; ``"dots"`` keeps the outputs of
    the matrix products and recomputes the rest (``checkpoint_dots``)."""
    if cfg.remat == "nothing":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint.checkpoint, fn,
                                 use_reentrant=False)
    return functools.partial(checkpoint.checkpoint, fn, use_reentrant=False,
                             context_fn=_DOTS)


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


def _unembedding(params: LM, cfg: ModelConfig):
    return params.embed if cfg.tie_embeddings else params.unembed


def _logits(params: LM, cfg: ModelConfig, x, adt):
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    return embedding_logits(_unembedding(params, cfg), x, adt)


def _backbone(params: LM, cfg: ModelConfig, tokens, prefix_embeds=None):
    """Everything up to the final norm. Returns (hidden, aux, pfx): aux is
    (load_balance, dropped_frac), float32, summed over a repeat's MoE
    members and averaged over the repeats (zeros without an MoE)."""
    adt = DTYPES[cfg.activation_dtype]
    x, positions = _embed_inputs(params, cfg, _tokens(params, tokens),
                                 prefix_embeds, adt)
    pfx = cfg.prefix_len if prefix_embeds is not None else 0

    def unit_body(x, unit_params):
        aux_acc = torch.zeros(2, dtype=torch.float32, device=x.device)
        for u, spec in enumerate(cfg.unit):
            x, aux = blocks.block_forward(unit_params[f"u{u}"], cfg, spec, x,
                                          positions, prefix_len=pfx)
            if aux:
                aux_acc = aux_acc + torch.stack(
                    [aux["load_balance"], aux["dropped_frac"]])
        return x, aux_acc

    # the aux leaves the checkpointed region beside x; a recompute in the
    # backward routes every token as the first pass did (nothing in the
    # MoE's integer results depends on the order of float work)
    body = _remat(unit_body, cfg)
    auxes = []
    for unit_params in params.blocks:
        x, aux = body(x, unit_params)
        auxes.append(aux)
    x = rmsnorm_apply(params.final_norm, x, cfg.norm_eps)
    return x, torch.stack(auxes).mean(dim=0), pfx


def forward(params: LM, cfg: ModelConfig, tokens, prefix_embeds=None):
    """tokens (B, S) -> (logits (B, S, padded vocab) in the activation
    dtype over the text positions, aux)."""
    adt = DTYPES[cfg.activation_dtype]
    x, aux, pfx = _backbone(params, cfg, tokens, prefix_embeds)
    logits = embedding_logits(_unembedding(params, cfg), x, adt)
    return (logits[:, pfx:] if pfx else logits), aux


def _slab(m, s, lab, xf, table, labels, base: int, chunk: int):
    """One vocab slab of :func:`chunked_softmax_stats`: the slab's logits
    in bfloat16 (the product rounded to bfloat16, then widened), folded
    into the running max ``m``, sum ``s`` and label logit ``lab``."""
    slab = table[base: base + chunk].to(torch.bfloat16)
    lg = torch.einsum("bsd,vd->bsv", xf, slab).to(torch.float32)
    m_new = torch.maximum(m, lg.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
    rel = labels - base
    hit = (rel >= 0) & (rel < chunk)
    picked = torch.gather(lg, -1, rel.clamp(0, chunk - 1)[..., None])[..., 0]
    return m_new, s, lab + torch.where(hit, picked, 0.0)


def chunked_softmax_stats(x, table, labels, chunk: int):
    """logsumexp and label logit over the vocab without the (B, S, V)
    logits: ``chunk``-row slabs of the unembedding ``table`` (V, D), each
    slab's logits recomputed in the backward (``torch.utils.checkpoint``,
    as the reference's ``jax.checkpoint(body)``), so no two slabs live at
    once. Returns (logz (B, S), label_logit (B, S)), float32."""
    V, _ = table.shape
    if V % chunk:
        raise ValueError(f"ce_chunk_vocab {chunk} does not divide the "
                         f"padded vocab {V}")
    B, S = labels.shape
    xf = x.to(torch.bfloat16)
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    lab = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for base in range(0, V, chunk):
        m, s, lab = checkpoint.checkpoint(_slab, m, s, lab, xf, table,
                                          labels, base, chunk,
                                          use_reentrant=False)
    return torch.log(s) + m, lab


def loss(params: LM, cfg: ModelConfig, batch, *, z_loss: float = 1e-4,
         moe_loss_weight: float = 0.01):
    """Next-token CE plus ``z_loss * mean(logz**2)``. batch: {"tokens":
    (B, S) integers, "prefix": optional (B, P, D)}. Returns (total,
    metrics {"ce", "load_balance", "dropped_frac"}), 0-d float32 tensors."""
    tokens = _tokens(params, batch["tokens"])
    labels = tokens[:, 1:]
    prefix = batch.get("prefix")
    if cfg.ce_chunk_vocab:
        x, aux, pfx = _backbone(params, cfg, tokens, prefix)
        x = x[:, pfx:] if pfx else x
        logz, label_logit = chunked_softmax_stats(
            x[:, :-1], _unembedding(params, cfg).table, labels,
            cfg.ce_chunk_vocab)
    else:
        logits, aux = forward(params, cfg, tokens, prefix)
        lg = logits[:, :-1].to(torch.float32)
        logz = torch.logsumexp(lg, dim=-1)
        label_logit = torch.gather(lg, -1, labels[..., None])[..., 0]
    ce = (logz - label_logit).mean()
    total = ce + z_loss * (logz ** 2).mean()
    if cfg.n_experts:
        total = total + moe_loss_weight * aux[0]
    return total, {"ce": ce, "load_balance": aux[0], "dropped_frac": aux[1]}


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda") -> Caches:
    """Empty caches, one dict of unit members a repeat: a KV cache of
    ``dtype`` for an attention member, a Mamba cache (float32 conv
    history and state, as the reference's) for a Mamba member."""
    def one(spec):
        if spec.kind == "attn":
            return attention.init_cache(cfg, batch, max_len, dtype, device)
        return mamba2.init_mamba_cache(cfg, batch, device=device)
    return [{f"u{u}": one(spec) for u, spec in enumerate(cfg.unit)}
            for _ in range(cfg.repeats)]


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
            x, got = blocks.block_prefill(unit_p[f"u{u}"], cfg, spec, x,
                                          positions, prefix_len=pfx)
            c = unit_c[f"u{u}"]
            if spec.kind == "attn":
                k, v = got
                c.k[:, :S] = k.to(cache_dtype)
                c.v[:, :S] = v.to(cache_dtype)
            else:        # the history holds activation-dtype values exactly
                c.conv.copy_(got.conv)
                c.state.copy_(got.state)
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
