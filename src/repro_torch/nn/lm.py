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

Each entry point also takes a :class:`ShardedLM` (:func:`shard` lays an
LM over a ``launch.mesh.ModelMesh``; ``init_caches(..., mesh=)`` gives
sharded caches) and runs one local program a mesh position, layer by
layer, with the collectives of :mod:`repro_torch.nn.collectives`.
"""
from __future__ import annotations

import functools
import re
from typing import Dict, Iterable, List, Union

import torch
from torch import nn
from torch.utils import checkpoint

from repro_torch.analysis.contracts import kernel_contract
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
    or an int seed for one (on the CPU for ``meta``, which draws nothing).
    They take gradients."""
    if not isinstance(gen, torch.Generator):
        gdev = "cpu" if torch.device(device).type == "meta" else device
        gen = torch.Generator(device=gdev).manual_seed(int(gen))
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


def device_of(params) -> torch.device:
    """Where an LM's inputs go: its device, or its mesh's home."""
    if isinstance(params, ShardedLM):
        return params.mesh.home
    return params.embed.table.device


def _tokens(params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device_of(params)).to(torch.int64)


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
    if isinstance(params, ShardedLM):
        return _forward_sharded(params, cfg, tokens, prefix_embeds)
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


def chunked_softmax_partial(x, table, labels, chunk: int):
    """The running (max, sum, label logit) of :func:`chunked_softmax_stats`
    over the rows of ``table`` (a vocab shard: ``labels`` relative to its
    first row, a label outside it adds nothing), in ``chunk``-row slabs
    and a last, shorter one where ``chunk`` does not divide the rows."""
    V, _ = table.shape
    B, S = labels.shape
    xf = x.to(torch.bfloat16)
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    lab = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for base in range(0, V, chunk):
        m, s, lab = checkpoint.checkpoint(_slab, m, s, lab, xf, table,
                                          labels, base, min(chunk, V - base),
                                          use_reentrant=False)
    return m, s, lab


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
    m, s, lab = chunked_softmax_partial(x, table, labels, chunk)
    return torch.log(s) + m, lab


def loss(params: LM, cfg: ModelConfig, batch, *, z_loss: float = 1e-4,
         moe_loss_weight: float = 0.01):
    """Next-token CE plus ``z_loss * mean(logz**2)``. batch: {"tokens":
    (B, S) integers, "prefix": optional (B, P, D)}. Returns (total,
    metrics {"ce", "load_balance", "dropped_frac"}), 0-d float32 tensors."""
    if isinstance(params, ShardedLM):
        return _loss_sharded(params, cfg, batch, z_loss, moe_loss_weight)
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
                dtype=torch.bfloat16, device="cuda", mesh=None) -> Caches:
    """Empty caches, one dict of unit members a repeat: a KV cache of
    ``dtype`` for an attention member, a Mamba cache (float32 conv
    history and state, as the reference's) for a Mamba member. With a
    ``mesh``, each cache tensor is a Sharded laid out by ``cache_axes``
    (``device`` unused)."""
    if mesh is not None:
        return _init_caches_sharded(cfg, batch, max_len, dtype, mesh)
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
    if isinstance(params, ShardedLM):
        return _prefill_sharded(params, cfg, tokens, max_len, prefix_embeds,
                                cache_dtype)
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


@kernel_contract(collectives="model-mesh", donated=("caches",),
                 variant="mesh")
@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, token, caches: Caches):
    """token: (B, 1) integers. Returns (logits (B, padded vocab), caches);
    the caches' tensors are updated in place."""
    if isinstance(params, ShardedLM):
        return _decode_sharded(params, cfg, token, caches)
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


# -- on a model mesh ----------------------------------------------------------
# A ShardedLM holds each parameter as its spec's shards
# (``nn.sharding.spec_for`` of its logical axes). Each entry point runs one
# local program per mesh position, layer by layer, on the position's batch
# rows (the batch split over ``pod`` and ``data``) and parameter slices,
# with the collectives of ``nn.collectives`` between them.

class ShardedLM:
    """The parameters of an :class:`LM` over a ``ModelMesh``: ``leaves``
    maps each of the LM's parameter names to a Sharded whose shards are
    leaf tensors that take gradients."""

    def __init__(self, cfg: ModelConfig, mesh, leaves):
        self.cfg, self.mesh, self.leaves = cfg, mesh, leaves

    def shard_tensors(self):
        """``{(name, coord): shard}`` for every distinct shard, in the
        LM's parameter order and each leaf's coordinate order."""
        return {(n, c): t for n, leaf in self.leaves.items()
                for c, t in leaf.shards.items()}

    def parameters(self):
        return list(self.shard_tensors().values())

    def full(self, device=None):
        """``{name: the whole tensor}`` on ``device`` (default the mesh's
        home)."""
        with torch.no_grad():
            return {n: leaf.full(device) for n, leaf in self.leaves.items()}


def shard(params, cfg: ModelConfig, mesh) -> ShardedLM:
    """``params`` (an :class:`LM`, or its state dict) laid out over
    ``mesh``, each shard a copy on its position's device."""
    from repro_torch.nn.collectives import Sharded
    from repro_torch.nn.sharding import axes_of, spec_for
    named = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    leaves = {}
    for name, p in named:
        spec = spec_for(tuple(p.shape), axes_of(name), mesh)
        leaves[name] = Sharded.from_full(p.detach(), spec, mesh, param=True)
    return ShardedLM(cfg, mesh, leaves)


def init_sharded(gen, cfg: ModelConfig, mesh) -> ShardedLM:
    """Random parameters (drawn as :func:`init` draws them on the mesh's
    home device), laid out over ``mesh``."""
    params = init(gen, cfg, mesh.home)
    out = shard(params, cfg, mesh)
    del params
    return out


def batch_axes(mesh, B: int, S: int):
    """The mesh axes a (B, S) batch is split over (``spec_for``'s)."""
    from repro_torch.nn.sharding import spec_for
    return spec_for((B, S), ("batch", "seq"), mesh).axes(0)


def split_rows(mesh, baxes, t: torch.Tensor):
    """{pos: the position's contiguous block of ``t``'s rows, on its
    device}: the batch placed over ``baxes``."""
    from repro_torch.nn.collectives import _axes_size, block_index
    from repro_torch.nn.sharding import mesh_sizes
    nb = _axes_size(mesh_sizes(mesh), baxes)
    w = t.shape[0] // nb
    return {pos: t[block_index(mesh, pos, baxes) * w:][:w].to(
        mesh.device(pos)) for pos in mesh.positions()}


def _unembed_name(cfg: ModelConfig) -> str:
    return "embed.table" if cfg.tie_embeddings else "unembed.table"


def _lookup_sharded(sp: ShardedLM, toks, adt):
    """The vocab-parallel embedding lookup: each position reads the rows
    of its vocab shard (the table gathered over ``data``), zeros for the
    other ids, all-reduced over ``model``."""
    from repro_torch.nn.collectives import all_reduce
    leaf = sp.leaves["embed.table"]
    vsplit = leaf.spec.axes(0) == ("model",)
    out = {}
    for pos, ids in toks.items():
        if not vsplit:
            out[pos] = leaf.local(pos)[ids].to(adt)
            continue
        tbl = leaf.local(pos, {0: "model"})
        n = tbl.shape[0]
        rel = ids - sp.mesh.index(pos, "model") * n
        ok = (rel >= 0) & (rel < n)
        x = tbl[rel.clamp(0, n - 1)].to(adt)
        out[pos] = torch.where(ok[..., None], x, torch.zeros((), dtype=adt,
                                                             device=x.device))
    return all_reduce(out, sp.mesh, "model") if vsplit else out


def _embed_sharded(sp: ShardedLM, cfg, tokens, prefix_embeds, adt):
    mesh = sp.mesh
    toks = _tokens(sp, tokens)
    B, S = toks.shape
    baxes = batch_axes(mesh, B, S)
    xs = _lookup_sharded(sp, split_rows(mesh, baxes, toks), adt)
    if cfg.prefix_len and prefix_embeds is not None:
        pf = split_rows(mesh, baxes, torch.as_tensor(prefix_embeds).to(
            mesh.home))
        xs = {p: torch.cat([pf[p].to(adt), x], dim=1) for p, x in xs.items()}
    positions = {}
    for p, x in xs.items():
        b, s = x.shape[:2]
        positions[p] = torch.arange(s, device=x.device)[None].expand(b, s)
    return xs, positions, baxes


def _backbone_sharded(sp: ShardedLM, cfg, tokens, prefix_embeds=None):
    """:func:`_backbone` at every position: ({pos: hidden}, {pos: aux},
    pfx, the batch axes)."""
    from repro_torch.nn.collectives import Scope
    adt = DTYPES[cfg.activation_dtype]
    mesh = sp.mesh
    xs, positions, baxes = _embed_sharded(sp, cfg, tokens, prefix_embeds,
                                          adt)
    pfx = cfg.prefix_len if prefix_embeds is not None else 0
    order = list(mesh.positions())
    scope = Scope(sp.leaves)
    auxes = {p: [] for p in order}
    for r in range(cfg.repeats):
        def unit_body(*vals, r=r):
            xs = dict(zip(order, vals))
            acc = {p: torch.zeros(2, dtype=torch.float32,
                                  device=mesh.device(p)) for p in order}
            for u, spec in enumerate(cfg.unit):
                xs, aux = blocks.block_forward_sharded(
                    scope.sub(f"blocks.{r}.u{u}."), cfg, spec, mesh, xs,
                    positions, baxes, prefix_len=pfx)
                if aux is not None:
                    acc = {p: acc[p] + aux[p] for p in order}
            return tuple(xs[p] for p in order) + tuple(acc[p] for p in order)
        # a checkpointed unit over several cards would be recomputed from
        # each card's autograd thread at once (torch.utils.checkpoint's
        # recompute takes no lock): there every activation is kept
        body = (unit_body if mesh.distinct_devices > 1
                else _remat(unit_body, cfg))
        got = body(*(xs[p] for p in order))
        xs = dict(zip(order, got[:len(order)]))
        for p, a in zip(order, got[len(order):]):
            auxes[p].append(a)
    xs = {p: rmsnorm_apply(scope.norm("final_norm", p), x, cfg.norm_eps)
          for p, x in xs.items()}
    aux = {p: torch.stack(a).mean(dim=0) for p, a in auxes.items()}
    return xs, aux, pfx, baxes


def _forward_sharded(sp: ShardedLM, cfg, tokens, prefix_embeds=None):
    adt = DTYPES[cfg.activation_dtype]
    xs, aux, pfx, baxes = _backbone_sharded(sp, cfg, tokens, prefix_embeds)
    logits = _logits_home(sp, cfg, xs, adt, baxes)
    a = next(iter(aux.values()))
    return (logits[:, pfx:] if pfx else logits), a


def _logits_home(sp: ShardedLM, cfg, xs, adt, baxes):
    from repro_torch.nn.collectives import all_gather, gather_home
    leaf = sp.leaves[_unembed_name(cfg)]
    vsplit = leaf.spec.axes(0) == ("model",)
    out = {}
    for pos, x in xs.items():
        tbl = leaf.local(pos, {0: "model"} if vsplit else {})
        out[pos] = torch.einsum("bsd,vd->bsv", x.to(adt), tbl.to(adt))
    if vsplit:
        out = all_gather(out, sp.mesh, "model", -1)
    return gather_home(sp.mesh, out, baxes)


def _loss_sharded(sp: ShardedLM, cfg, batch, z_loss: float,
                  moe_loss_weight: float):
    """:func:`loss` on a mesh: each position's softmax statistics over
    its vocab shard (chunked where ``ce_chunk_vocab`` is set, with a last
    shorter chunk where it does not divide the shard), combined over
    ``model`` (the max, the sum of exps rescaled, the label's logit from
    the shard that holds it); the sums over the batch all-reduced."""
    from repro_torch.nn.collectives import all_gather, all_reduce
    mesh = sp.mesh
    adt = DTYPES[cfg.activation_dtype]
    tokens = _tokens(sp, batch["tokens"])
    B, S = tokens.shape
    xs, aux, pfx, baxes = _backbone_sharded(sp, cfg, tokens,
                                            batch.get("prefix"))
    labels = split_rows(mesh, baxes, tokens[:, 1:])
    leaf = sp.leaves[_unembed_name(cfg)]
    vsplit = leaf.spec.axes(0) == ("model",)
    stats = {}
    for pos, x in xs.items():
        x = (x[:, pfx:] if pfx else x)[:, :-1]
        tbl = leaf.local(pos, {0: "model"} if vsplit else {})
        lab = labels[pos] - (mesh.index(pos, "model") * tbl.shape[0]
                             if vsplit else 0)
        if cfg.ce_chunk_vocab:
            m, s, ll = chunked_softmax_partial(x, tbl, lab,
                                               cfg.ce_chunk_vocab)
        else:
            lg = torch.einsum("bsd,vd->bsv", x.to(adt), tbl.to(adt)).to(
                torch.float32)
            m = lg.amax(dim=-1)
            s = torch.exp(lg - m[..., None]).sum(dim=-1)
            n = tbl.shape[0]
            hit = (lab >= 0) & (lab < n)
            picked = torch.gather(lg, -1, lab.clamp(0, n - 1)[..., None])[
                ..., 0]
            ll = torch.where(hit, picked, 0.0)
        stats[pos] = torch.stack([m, s, ll])
    if vsplit:
        parts = all_gather(stats, mesh, "model", 0, stack=True)
        stats = {}
        for pos, p in parts.items():            # (shards, 3, B, S)
            M = p[:, 0].amax(dim=0)
            ssum = (p[:, 1] * torch.exp(p[:, 0] - M)).sum(dim=0)
            stats[pos] = torch.stack([M, ssum, p[:, 2].sum(dim=0)])
    sums = {}
    for pos, st in stats.items():
        logz = torch.log(st[1]) + st[0]
        sums[pos] = torch.stack([(logz - st[2]).sum(), (logz ** 2).sum()])
    sums = all_reduce(sums, mesh, baxes)
    home = next(iter(mesh.positions()))
    n = B * (S - 1)
    ce = sums[home][0] / n
    total = ce + z_loss * (sums[home][1] / n)
    a = aux[home]
    if cfg.n_experts:
        total = total + moe_loss_weight * a[0]
    return total, {"ce": ce, "load_balance": a[0], "dropped_frac": a[1]}


def _init_caches_sharded(cfg: ModelConfig, batch: int, max_len: int, dtype,
                         mesh) -> Caches:
    from repro_torch.launch.shardings import cache_axes
    from repro_torch.nn.collectives import Sharded
    from repro_torch.nn.sharding import shard_shape, spec_for

    def zeros(shape, axes, dt):
        spec = spec_for(shape, axes, mesh)
        local = shard_shape(shape, spec, mesh)
        return Sharded.build(shape, spec, mesh, lambda c, box, pos:
                             torch.zeros(local, dtype=dt,
                                         device=mesh.device(pos)))
    ax = cache_axes(cfg, mesh)
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    out = []
    for _ in range(cfg.repeats):
        unit = {}
        for u, spec in enumerate(cfg.unit):
            a = ax[f"u{u}"]
            if spec.kind == "attn":
                shape = (batch, max_len, kv, hd)
                unit[f"u{u}"] = attention.KVCache(
                    k=zeros(shape, a.k, dtype), v=zeros(shape, a.v, dtype),
                    length=0)
            else:
                unit[f"u{u}"] = mamba2.MambaCache(
                    conv=zeros((batch, cfg.ssm_conv - 1, di + 2 * N), a.conv,
                               torch.float32),
                    state=zeros((batch, H, N, P), a.state, torch.float32),
                    length=0)
        out.append(unit)
    return out


@torch.no_grad()
def _prefill_sharded(sp: ShardedLM, cfg, tokens, max_len: int,
                     prefix_embeds, cache_dtype):
    from repro_torch.nn.collectives import Scope
    adt = DTYPES[cfg.activation_dtype]
    mesh = sp.mesh
    xs, positions, baxes = _embed_sharded(sp, cfg, tokens, prefix_embeds,
                                          adt)
    pfx = cfg.prefix_len if prefix_embeds is not None else 0
    B = torch.as_tensor(tokens).shape[0]
    S = next(iter(xs.values())).shape[1]
    if max_len < S:
        raise ValueError(f"cache max_len={max_len} < prompt length {S} "
                         f"(remember to include prefix_len={pfx})")
    caches = _init_caches_sharded(cfg, B, max_len, cache_dtype, mesh)
    scope = Scope(sp.leaves)
    for r, unit_c in enumerate(caches):
        for u, spec in enumerate(cfg.unit):
            xs = blocks.block_prefill_sharded(
                scope.sub(f"blocks.{r}.u{u}."), cfg, spec, mesh, xs,
                positions, baxes, unit_c[f"u{u}"], prefix_len=pfx)
            unit_c[f"u{u}"] = unit_c[f"u{u}"]._replace(length=S)
    xs = {p: rmsnorm_apply(scope.norm("final_norm", p), x[:, -1:],
                           cfg.norm_eps) for p, x in xs.items()}
    return _logits_home(sp, cfg, xs, adt, baxes)[:, 0], caches


@torch.no_grad()
def _decode_sharded(sp: ShardedLM, cfg, token, caches: Caches):
    from repro_torch.nn.collectives import Scope
    adt = DTYPES[cfg.activation_dtype]
    mesh = sp.mesh
    toks = _tokens(sp, token)
    baxes = batch_axes(mesh, toks.shape[0], 1)
    xs = _lookup_sharded(sp, split_rows(mesh, baxes, toks), adt)
    scope = Scope(sp.leaves)
    new_caches = []
    for r, unit_c in enumerate(caches):
        new_c = {}
        for u, spec in enumerate(cfg.unit):
            xs, new_c[f"u{u}"] = blocks.block_decode_sharded(
                scope.sub(f"blocks.{r}.u{u}."), cfg, spec, mesh, xs, baxes,
                unit_c[f"u{u}"])
        new_caches.append(new_c)
    xs = {p: rmsnorm_apply(scope.norm("final_norm", p), x, cfg.norm_eps)
          for p, x in xs.items()}
    return _logits_home(sp, cfg, xs, adt, baxes)[:, 0], new_caches
